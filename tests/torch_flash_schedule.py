"""The schedule of the head-dim-96 flash kernels (``csrc/flash_fwd.cu``
``flash_fwd_d96_kernel`` and ``csrc/flash_bwd.cu``
``flash_bwd_dkv_d96_kernel``), written as a plain model for the CPU tests
(``tests/test_torch_flash_fwd_tiles.py``, ``tests/test_torch_flash_bwd_tiles.py``).
Not collected: it holds no tests.

A CTA walks n ring tiles. Each of its two consumer warpgroups does its math
on a contiguous run [a, b] of them (a > b: none) and takes n + 1 rounds,
each one turn at the tensor core:

- an idle round r waits on tile r's full barriers (r < n), takes and hands
  over the turn, and frees tile r's stage;
- the prologue (round a) waits on the first barrier of tile a and issues
  its first product (S, or S^T and dP^T);
- a steady round i waits on tile i's first barrier (the forward also on
  tile i - 1's V), issues tile i's first product and tile i - 1's second
  (P.V, or dv and dk), and frees tile i - 1's stage;
- the epilogue (round b + 1) waits on tile b + 1's barriers (if it is a
  tile: no math reaches it) and, in the forward, on tile b's V, issues tile
  b's second product, and frees tiles b and b + 1.

Warpgroup 0 takes the first turn (warpgroup 1 arrives on its barrier once
before its rounds); each round ends by handing the turn to the other, but
warpgroup 1's last. One producer thread fills a tile's stage once both
warpgroups freed the tile STAGES before it.
"""

# The full barriers a tile has: the forward's K and V, dk/dv's one (Q, dO,
# lse and delta together).
FWD = ("k", "v")
DKV = ("f",)


def rounds(n, a, b, kinds):
    """A warpgroup's rounds: dicts of the barriers it waits on ((tile,
    kind)), the tile whose first product it issues (``s``), the tile whose
    second product it issues (``acc``) and the tiles it frees."""
    first, last = kinds[0], kinds[-1]
    two = first != last

    def idle(r):
        return dict(waits=[(r, x) for x in kinds] if r < n else [], s=None, acc=None, frees=[r] if r < n else [])

    if a > b:
        return [idle(r) for r in range(n + 1)]
    out = [idle(r) for r in range(a)]
    out.append(dict(waits=[(a, first)], s=a, acc=None, frees=[]))
    for i in range(a + 1, b + 1):
        out.append(dict(waits=[(i, first)] + ([(i - 1, last)] if two else []), s=i, acc=i - 1, frees=[i - 1]))
    r = b + 1
    out.append(dict(waits=([(r, x) for x in kinds] if r < n else []) + ([(b, last)] if two else []), s=None, acc=b,
                    frees=[b] + ([r] if r < n else [])))
    out += [idle(r) for r in range(b + 2, n + 1)]
    return out


def simulate(n, runs, kinds, stages):
    """Run the producer and both warpgroups' rounds (``runs``: each
    warpgroup's (a, b)) in any order the barriers allow; raise on a
    deadlock or a broken invariant. Returns the rounds."""
    plans = [rounds(n, a, b, kinds) for a, b in runs]
    assert all(len(p) == n + 1 for p in plans)
    loaded, freed = [], [set(), set()]
    done = [0, 0]  # rounds completed
    arrivals = [1, 0]  # arrivals on each warpgroup's turn barrier (warpgroup 1's first, before its rounds)
    syncs = [0, 0]
    issued = [[], []]
    while done != [n + 1, n + 1]:
        progress = False
        j = len(loaded)
        if j < n and (j < stages or all(j - stages in f for f in freed)):
            loaded.append(j)
            progress = True
        for w in (0, 1):
            if done[w] > n:
                continue
            rd = plans[w][done[w]]
            if any(t not in loaded for t, _ in rd["waits"]) or arrivals[w] <= syncs[w]:
                continue
            syncs[w] += 1
            if rd["s"] is not None:
                issued[w].append(("s", rd["s"]))
            if rd["acc"] is not None:
                issued[w].append(("acc", rd["acc"]))
            if w == 0 or done[w] < n:
                arrivals[1 - w] += 1
            for t in rd["frees"]:
                assert t not in freed[w], (w, t)
                freed[w].add(t)
            done[w] += 1
            progress = True
        if not progress:
            raise AssertionError(f"deadlock: loaded {loaded}, rounds done {done}, runs {runs}, n {n}")
    assert syncs == [n + 1, n + 1] and arrivals == syncs, (syncs, arrivals)
    for w, (a, b) in enumerate(runs):
        waits = [x for rd in plans[w] for x in rd["waits"]]
        assert sorted(waits) == sorted((t, x) for t in range(n) for x in kinds), (w, waits)
        assert freed[w] == set(range(n)), (w, freed[w])
        live = list(range(a, b + 1))
        assert [t for op, t in issued[w] if op == "s"] == live
        assert [t for op, t in issued[w] if op == "acc"] == live
        for r, rd in enumerate(plans[w]):
            seen = {x for q in plans[w][:r + 1] for x in q["waits"]}
            if rd["s"] is not None:
                assert (rd["s"], kinds[0]) in seen
            if rd["acc"] is not None:
                assert (rd["acc"], kinds[-1]) in seen
                assert any(q["s"] == rd["acc"] for q in plans[w][:r])  # its first product came a round earlier
            for t in rd["frees"]:
                assert all((t, x) in seen for x in kinds)
                assert not a <= t <= b or any(q["acc"] == t for q in plans[w][:r + 1])
    return plans
