"""The walk of the head-dim-96 flash forward (``csrc/flash_fwd.cu``
``flash_fwd_d96_kernel``, row 1h) on the CPU: a plain model, written here,
of which key tiles each consumer warpgroup does its math on, which of them
skip the per-score mask, and what the online softmax computes on them, held
against the port's plain forward (``flash_attention_plain``) and the JAX
package's Pallas forward in interpret mode on the same numpy inputs. The
tile sizes and the ring depth are read from the kernel's source.

- One CTA per BQ = 128 query rows, two consumer warpgroups of 64; key tiles
  of BK_D96 = 128 from the tile of the first key the CTA's first row's
  window sees to the diagonal of its last row (both in the offset frame).
- A warpgroup does its math on the tiles some pair of whose rows and keys
  (cut at T) is reachable by position; they form one contiguous run.
- A tile skips the mask when every row of the warpgroup reaches every key
  of the tile by position and every key is valid (the producer's 128 bits:
  kv_mask > 0.5 on every key, all below T). Otherwise the masked raw scores
  become -inf: they weigh 0 beside any valid key and count as the replaced
  -1e9 in the max, and a row with no valid key yet weighs every masked key
  below T 1 (as 2^(-1e9 - (-1e9)) does). Both paths give a valid score the
  same bits: the row max is taken on the raw scores and scaled once
  (rounding is monotone), and 2^(s * scale * log2 e - m) is one fused
  multiply-add.
- Keys past T weigh exactly 0, P is rounded to the value dtype before P.V,
  a row that reaches no key by position gets o = 0 and lse = -1e30.

The walk's schedule (the ring's phases and the warpgroups' turns) is
``tests/torch_flash_schedule.py``'s, simulated here on every CTA.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_flash_schedule as schedule
from trlx_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from trlx_tpu_torch.ops import cuda_lib
from trlx_tpu_torch.ops import flash_attention as flash_mod

torch.set_num_threads(1)

# float32 on both sides: what differs is the summation order.
TOL = dict(rtol=1e-4, atol=1e-5)
WG_ROWS = 64  # query rows of a consumer warpgroup (one wgmma M)
LOG2E = np.float32(1.4426950408889634)
LN2 = 0.6931471805599453
D = 96


def _kernel_source():
    with open(os.path.join(cuda_lib._CSRC, "flash_fwd.cu")) as f:
        return f.read()


def _kernel_tiles():
    """The d = 96 tile constants of ``csrc/flash_fwd.cu``; the rules the
    model below follows are asserted to be the source's, as written."""
    src = _kernel_source()
    names = ("BQ", "BK_D96", "STAGES_D96", "BOX_D96")
    tiles = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1)) for n in names}
    for rule in ("(!p.causal || k0 + BKH - 1 + p.offset <= rlo)", "(p.window <= 0 || k0 + p.offset > rlo + 63 - p.window)",
                 "__ballot_sync(0xffffffffu, key < T && p.kmask[(size_t)bi * T + key] > 0.5f)",
                 "(w.x & w.y & w.z & w.w) == 0xffffffffu"):
        assert rule in src, rule
    return tiles


TILES = _kernel_tiles()


def _reach(rows, keys, causal, window, offset):
    """[len(rows), len(keys)] bool: key j (at position j + offset) is
    reachable from query row i by position (rows may lie past T)."""
    kp = np.asarray(keys)[None, :] + offset
    r = np.asarray(rows)[:, None]
    ok = np.ones((len(rows), len(keys)), bool)
    if causal:
        ok &= kp <= r
    if window > 0:
        ok &= kp > r - window
    return ok


def fwd_walk(T, window, causal=True, offset=0):
    """[(q0, [k0, ...], [(a, b, [unmasked by position of tile i, ...]) for
    each warpgroup])]: the key tiles each CTA walks, each warpgroup's live
    run [a, b] (a > b: none) and which tiles every row of the warpgroup
    reaches whole by position. Python's // is the kernel's floor_div."""
    bq, bk = TILES["BQ"], TILES["BK_D96"]
    n_kt = -(-T // bk)
    out = []
    for q0 in range(0, T, bq):
        kt_hi = min(n_kt - 1, (min(q0 + bq, T) - 1 - offset) // bk) if causal else n_kt - 1
        kt_lo = max(0, (q0 - window + 1 - offset) // bk) if window > 0 else 0
        k0s = [kt * bk for kt in range(kt_lo, kt_hi + 1)]
        wgs = []
        for w in range(bq // WG_ROWS):
            rlo = q0 + w * WG_ROWS
            live = [rlo < T and (not causal or k0 + offset <= min(rlo + WG_ROWS, T) - 1)
                    and not (window > 0 and min(k0 + bk, T) - 1 + offset <= rlo - window) for k0 in k0s]
            idx = [i for i, lv in enumerate(live) if lv]
            a, b = (idx[0], idx[-1]) if idx else (len(k0s), -1)
            assert idx == list(range(a, b + 1)), (q0, w, live)  # one contiguous run
            whole = [(not causal or k0 + bk - 1 + offset <= rlo) and (window <= 0 or k0 + offset > rlo + 63 - window)
                     for k0 in k0s]
            wgs.append((a, b, whole))
        out.append((q0, k0s, wgs))
    return out


def _fma(a, b, c):
    """a * b + c with one rounding to float32 (the kernel's fmaf), through
    float64, where the product of two float32 values is exact."""
    return (a.double() * float(b) + c.double()).float()


def walk_fwd(q, k, v, kv_mask, *, scale, window, causal=True, offset=0, force_masked=False):
    """(o, lse, unmasked tile count) by the kernel's walk, tile by tile, f32
    scores, P rounded to v's dtype. ``force_masked`` takes the masked path on
    every tile (it must not change a bit)."""
    b, T, h, d = q.shape
    bk = TILES["BK_D96"]

    def heads(x):
        return x.float().permute(0, 2, 1, 3)  # [b, h, T, d]

    qf, kf, vf = heads(q), heads(k), heads(v)
    km = kv_mask.float() > 0.5
    sl2 = np.float32(np.float32(scale) * LOG2E)
    mask2 = np.float32(flash_mod.MASK_VAL) * LOG2E
    o = torch.zeros((b, h, T, d))
    lse = torch.full((b, h, T), flash_mod.M_INIT)
    n_unmasked = 0
    for q0, k0s, wgs in fwd_walk(T, window, causal, offset):
        for w, (a, last, whole) in enumerate(wgs):
            rlo = q0 + w * WG_ROWS
            if rlo >= T:
                continue
            rows = np.arange(rlo, min(rlo + WG_ROWS, T))
            m = torch.full((b, h, len(rows)), flash_mod.M_INIT)
            l = torch.zeros((b, h, len(rows)))
            acc = torch.zeros((b, h, len(rows), d))
            for i in range(a, last + 1):
                k0 = k0s[i]
                keys = np.arange(k0, min(k0 + bk, T))
                s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
                # The producer's flag: every key of the 128-key tile valid (keys past T are not).
                flag = km[:, k0:k0 + bk].all(-1) & (k0 + bk <= T)
                unm = (flag & bool(whole[i]) & (scale > 0) & (not force_masked))[:, None, None]  # [b, 1, 1]
                n_unmasked += int(unm.sum())
                valid = torch.from_numpy(_reach(rows, keys, causal, window, offset))[None, None] & km[:, None, None, keys]
                # The masked path: masked raw scores become -inf (weight 0 beside any
                # valid key), and count as mask2 in the max.
                s = torch.where(unm[..., None] | valid, s, torch.full_like(s, -torch.inf))
                mx = torch.maximum(s.amax(-1) * sl2, torch.tensor(mask2))
                mn = torch.maximum(m, mx)
                al = torch.exp2(m - mn)
                p = torch.exp2(_fma(s, sl2, -mn[..., None]))
                # A row with no valid key yet (max mask2) weighs every masked key 1.
                p = torch.where((mn == mask2)[..., None] & ~unm[..., None], torch.ones_like(p), p)
                l = al * l + p.sum(-1)
                acc = acc * al[..., None] + p.to(v.dtype).float() @ vf[:, :, keys]
                m = mn
            span = _reach(rows, np.arange(T), causal, window, offset).any(-1)
            live = (l > 0) & torch.from_numpy(span)[None, None]
            o[:, :, rows] = torch.where(live[..., None], acc / l.clamp_min(1e-30)[..., None], torch.zeros_like(acc))
            lse[:, :, rows] = torch.where(live, m * LN2 + torch.log(l.clamp_min(1e-30)),
                                          torch.full_like(m, flash_mod.M_INIT))
    return o.permute(0, 2, 1, 3).to(q.dtype), lse, n_unmasked


def _inputs(seed, T, pads, b=None, h=2):
    rng = np.random.default_rng(seed)
    b = len(pads) if b is None else b
    q, k, v = (rng.normal(size=(b, T, h, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, T), np.float32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0.0
    return q, k, v, mask


def _good(mask, T, causal, window, offset):
    """[b, T] rows with a valid reachable key (the rows every version
    defines alike); [T] rows that reach no key at all."""
    reach = flash_mod.reachable(T, T, "cpu", causal=causal, window=window, offset=offset)
    return (reach[None] & mask.bool()[:, None, :]).any(-1), ~reach.any(-1)


# (T, window, causal, offset, left pads per row): ragged T against the
# 128-key tiles, left padding that empties whole tiles (130 slots) and a
# wholly masked row, windows across tile edges, the offset frame's wholly
# past, cut and wholly future chunks, the non-causal mode.
MODES = [
    (1, 0, True, 0, (0, 0)),
    (65, 0, True, 0, (0, 20)),
    (130, 0, True, 0, (0, 130)),
    (200, 48, True, 0, (3, 70)),
    (300, 0, False, 0, (0, 140)),
    (256, 100, False, 0, (0, 0)),
    (256, 0, True, -256, (0, 9)),
    (200, 0, True, 37, (0, 9)),
    (200, 0, True, 200, (0, 0)),
    (300, 48, True, -64, (0, 130)),
]
MODE_IDS = [f"T{T}-w{w}-{'causal' if c else 'full'}-off{o}-pad{p[0]}_{p[1]}" for T, w, c, o, p in MODES]


@pytest.mark.parametrize("T,window,causal,offset,pads", MODES, ids=MODE_IDS)
def test_walk_matches_plain_and_pallas(T, window, causal, offset, pads):
    """float32: the walk (its skips and unmasked tiles) gives the plain
    forward's o and lse and the Pallas forward's (interpret mode, one block
    of T rows) on every row with a valid reachable key, to float32
    summation order (TOL); rows that reach no key get o = 0, lse = -1e30."""
    q_np, k_np, v_np, mask_np = _inputs(T + 7 * len(pads) + abs(offset), T, pads)
    q, k, v, mask = (torch.from_numpy(x) for x in (q_np, k_np, v_np, mask_np))
    modes = dict(scale=D ** -0.5, window=window, causal=causal, offset=offset)
    o, lse, _ = walk_fwd(q, k, v, mask, **modes)
    ro, rlse = flash_mod.flash_attention_plain(q, k, v, mask, return_lse=True, **modes)
    good, dead = _good(mask, T, causal, window, offset)
    torch.testing.assert_close(o[good], ro[good], **TOL)
    torch.testing.assert_close(lse.transpose(1, 2)[good], rlse.transpose(1, 2)[good], **TOL)
    assert (o[:, dead] == 0).all() and (lse[:, :, dead] == flash_mod.M_INIT).all()
    jo, jlse = jax_flash_attention(jnp.asarray(q_np), jnp.asarray(k_np), jnp.asarray(v_np), jnp.asarray(mask_np),
                                   block_q=T, block_k=T, interpret=True, return_lse=True, **modes)
    g = good.numpy()
    np.testing.assert_allclose(o.numpy()[g], np.asarray(jo)[g], **TOL)
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[g], np.asarray(jlse).transpose(0, 2, 1)[g], **TOL)


@pytest.mark.parametrize("T,window,causal,offset,pads", MODES, ids=MODE_IDS)
def test_unmasked_tiles_give_the_masked_bits(T, window, causal, offset, pads):
    """bf16 operands: skipping the mask on the interior tiles changes no bit
    of o or lse (every tile through the masked path gives the same), and
    the bf16 walk agrees with the plain forward within 0.02 on every row
    with a valid reachable key (the card tests' tolerance)."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(3 * T + abs(offset), T, pads))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    modes = dict(scale=D ** -0.5, window=window, causal=causal, offset=offset)
    o, lse, n = walk_fwd(q, k, v, mask, **modes)
    o2, lse2, n2 = walk_fwd(q, k, v, mask, force_masked=True, **modes)
    assert n2 == 0 and torch.equal(o, o2) and torch.equal(lse, lse2)
    ro = flash_mod.flash_attention_plain(q, k, v, mask, **modes)
    good, _ = _good(mask, T, causal, window, offset)
    if good.any():
        assert float((o[good].float() - ro[good].float()).abs().max()) <= 2e-2


def test_interior_tiles_take_the_unmasked_path():
    """At a length whose interior tiles are whole (T = 640, one row
    left-padded by 130 slots), the walk takes the unmasked path on every
    warpgroup's tiles strictly below its diagonal tile whose keys are all
    valid, and only there."""
    T, pads = 640, (0, 130)
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(5, T, pads, h=1))
    _, _, n = walk_fwd(q, k, v, mask, scale=D ** -0.5, window=0)
    expect = 0
    for q0, k0s, wgs in fwd_walk(T, 0):
        for w, (a, b, whole) in enumerate(wgs):
            for i in range(a, b + 1):
                expect += sum(bool(whole[i]) and bool((mask[r, k0s[i]:k0s[i] + 128] > 0.5).all()) for r in range(2))
    assert n == expect > 0


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("window", [0, 5, 64, 127, 128, 130])
@pytest.mark.parametrize("offset", [-256, -128, -37, 0, 37, 128, 256])
@pytest.mark.parametrize("T", [1, 65, 128, 130, 256, 300])
def test_walk_visits_every_reachable_pair_once(T, offset, window, causal):
    """Every (query, key) pair reachable in the offset frame is visited
    exactly once by a warpgroup that does its math; every tile whose math
    runs holds a reachable pair of the warpgroup's rows and every tile it
    skips none; key tiles outside a CTA's walk hold none of its rows'; and
    a tile takes the unmasked path by position exactly when every pair of
    its 64 x 128 block (rows past T included, keys all below T or not) is
    reachable."""
    bq, bk = TILES["BQ"], TILES["BK_D96"]
    reach = flash_mod.reachable(T, T, "cpu", causal=causal, window=window, offset=offset).numpy()
    seen = np.zeros((T, T), int)
    for q0, k0s, wgs in fwd_walk(T, window, causal, offset):
        for k0 in range(0, T, bk):
            if k0 not in k0s:
                assert not reach[q0:q0 + bq, k0:k0 + bk].any(), (q0, k0)
        for w, (a, b, whole) in enumerate(wgs):
            rlo = q0 + w * WG_ROWS
            for i, k0 in enumerate(k0s):
                lv = a <= i <= b
                assert lv == bool(reach[rlo:rlo + WG_ROWS, k0:k0 + bk].any()), (q0, w, k0)
                if lv:
                    seen[rlo:rlo + WG_ROWS, k0:k0 + bk] += 1
                block = _reach(np.arange(rlo, rlo + WG_ROWS), np.arange(k0, k0 + bk), causal, window, offset)
                assert whole[i] == bool(block.all()), (q0, w, k0)
    assert (seen[reach] == 1).all()
    assert seen.max() <= 1


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("window", [0, 48, 300])
@pytest.mark.parametrize("offset", [-1024, -300, 0, 37, 512])
@pytest.mark.parametrize("T", [1, 130, 1000, 1024])
def test_every_cta_schedule_completes(T, offset, window, causal):
    """The schedule of every CTA of the walk (``torch_flash_schedule``:
    the producer's K / V ring of STAGES_D96 stages, both warpgroups' rounds
    and turns) runs to its end: each warpgroup takes n + 1 turns, observes
    every phase of the ring, frees every stage once, issues S and P.V of
    each live tile once in order, and no stage is refilled before both
    warpgroups freed it."""
    for q0, k0s, wgs in fwd_walk(T, window, causal, offset):
        schedule.simulate(len(k0s), [(a, b) for a, b, _ in wgs], schedule.FWD, TILES["STAGES_D96"])
