"""The walk of the flash backward kernels (``csrc/flash_bwd.cu``) on the CPU:
a plain model, written here, of which tiles each kernel visits and what it
computes on them, held against the port's plain backward
(``flash_attention_bwd_plain``) and the JAX package's Pallas backward run in
interpret mode (``jax.vjp`` through ``flash_attention``), on the same numpy
inputs. The tile sizes are read from the kernel's source.

- dq: one CTA per DQ_BQ = 128 query rows, two consumer warpgroups of 64;
  key tiles of DQ_BK_D256 = 32 keys at d = 256 and DQ_BK = 64 below, from the
  tile of the first key the CTA's first row's window sees to the diagonal of
  its last row; a warpgroup skips the math of a tile its 64 rows cannot
  reach by position (the forward's test).
- dk/dv: one CTA per DKV_BK = 64 keys; query tiles of DKV_BQ = 64 from the
  diagonal to T, or with a window to the last query that still sees a key
  of the tile. At d = 96 (``flash_bwd_dkv_d96_kernel``) a CTA takes
  DKV_BK_D96 = 128 keys, its walk bounded by the CTA's first and last keys
  likewise, and each consumer warpgroup owns 64 of them and does its math
  on the query tiles some pair of whose queries and its keys (cut at T) is
  reachable: the upper half's run starts one query tile later on the
  diagonal, and a half whose keys all lie past T does none.

On every visited tile: s = q·kᵀ·scale with masked scores replaced by -1e9,
p = exp(s - lse), ds = p·(dO·vᵀ - δ), δ = rowsum(dO·O) - dlse; P and dS are
rounded to the operand dtype (bf16 in the kernels) before their products.

Padded query rows carry no cotangent (dO = dlse = 0), as in the model, where
no later position reads them: every row of dk/dv and every valid row of dq
compare.

Head dim 96 (GPT-NeoX-20B): dq stores a row of d bf16 as whole 64-column
boxes (``box_chunks`` in ``csrc/common.cuh``), so at d = 96 its tile is 128
columns whose last 32 TMA fills with zeros; the key tile of dq at each d is
the source's rule (``D == 256 ? DQ_BK_D256 : DQ_BK``). dk/dv at d = 96
stores it as three BOX_D96 = 32-column boxes: no padding. The boxed walk at
d = 96 runs dq on the zero-padded tiles and must leave their padded columns
exactly 0 (the kernel does not store them). The d = 96 schedule (ring
phases, the warpgroups' turns) is ``tests/torch_flash_schedule.py``'s,
simulated on every CTA.

The offset frame (ring attention): with ``offset`` key k sits at k + offset
of the query frame and ``causal=False`` drops the diagonal; the walks'
ranges and tile tests are written in that frame, as the kernels compute
them (``floor_div`` of possibly negative positions), and a row whose
forward reached no key (lse = -1e30) takes p = 0 on every tile.
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
WG_ROWS = 64  # query rows of a dq consumer warpgroup (one wgmma M)


def _kernel_tiles():
    """The tile constants of ``csrc/flash_bwd.cu``, its dq key-tile rule, the
    d = 96 dk/dv CTA (its keys, a warpgroup's, its ring depth, its box
    width, its whole-tile rule as written), and the box width rows are
    stored in elsewhere (``csrc/common.cuh`` ``box_chunks``)."""
    with open(os.path.join(cuda_lib._CSRC, "flash_bwd.cu")) as f:
        src = f.read()
    names = ("DQ_BQ", "DQ_BK", "DQ_BK_D256", "DKV_BK", "DKV_BQ", "DKV_BK_D96", "DKV_STAGES_D96", "BOX_D96")
    tiles = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1)) for n in names}
    rule = re.search(r"static constexpr int BK = D == (\d+) \? DQ_BK_D256 : DQ_BK;", src)
    tiles["DQ_BK_D256_AT"] = int(rule.group(1))
    tiles["DKV_WG_KEYS"] = int(re.search(r"const int kw0 = k0 \+ cw \* (\d+);", src).group(1))
    assert "cudaError_t launch_dkv<96>(const Maps& m, BwdParams p, cudaStream_t stream) {" in src
    for text in ("kw0 < T && flash_tile_live(q0, min(q0 + BQT - 1, T - 1), kw0 + p.offset, min(kw0 + 64, T) - 1 + p.offset,",
                 "(!p.causal || kw0 + 63 + p.offset <= q0)", "(p.window <= 0 || kw0 + p.offset + p.window > q0 + BQT - 1)"):
        assert text in src, text
    with open(os.path.join(cuda_lib._CSRC, "common.cuh")) as f:
        box = re.search(r"int box_chunks\(int d\) \{ return \(d \+ (\d+)\) / (\d+); \}", f.read())
    assert int(box.group(1)) + 1 == int(box.group(2))
    tiles["BOX_COLS"] = int(box.group(2))
    return tiles


TILES = _kernel_tiles()
DQ_KEY_TILES = (TILES["DQ_BK_D256"], TILES["DQ_BK"])  # d = 256; d = 64 / 96 / 128


def dq_key_tile(d):
    """The dq kernel's keys per ring tile at head dim d (the source's rule)."""
    return TILES["DQ_BK_D256"] if d == TILES["DQ_BK_D256_AT"] else TILES["DQ_BK"]


def _live(r0, rows, k0, bk, window, T, causal=True, offset=0):
    """The forward's tile test (``_run_if_live``, common.cuh
    ``flash_tile_live``): some pair of rows [r0, r0 + rows) and keys
    [k0, k0 + bk), at positions k + offset, is reachable by position; none
    is when every row lies past T."""
    k0, k1 = k0 + offset, min(k0 + bk, T) - 1 + offset
    return r0 < T and (not causal or k0 <= min(r0 + rows, T) - 1) and not (window > 0 and k1 <= r0 - window)


def dq_walk(T, window, bk, causal=True, offset=0):
    """[(q0, [(k0, (live for warpgroup 0, live for warpgroup 1)), ...])]: the
    key tiles each dq CTA walks, and which of its warpgroups do their math.
    Python's // is the kernels' floor_div."""
    bq, out = TILES["DQ_BQ"], []
    n_kt = -(-T // bk)
    for q0 in range(0, T, bq):
        kt_hi = min(n_kt - 1, (min(q0 + bq, T) - 1 - offset) // bk) if causal else n_kt - 1
        kt_lo = max(0, (q0 - window + 1 - offset) // bk) if window > 0 else 0
        tiles = [(kt * bk, tuple(_live(q0 + w * WG_ROWS, WG_ROWS, kt * bk, bk, window, T, causal, offset)
                                 for w in range(bq // WG_ROWS)))
                 for kt in range(kt_lo, kt_hi + 1)]
        out.append((q0, tiles))
    return out


D96 = 96
DKV_GEOMETRIES = {64: (TILES["DKV_BK"], TILES["DKV_BK"]), D96: (TILES["DKV_BK_D96"], TILES["DKV_WG_KEYS"])}


def dkv_geometry(d):
    """(keys a dk/dv CTA takes, keys whose math one warpgroup runs) at head
    dim d: the template's one 64-key group, or d = 96's two halves."""
    return DKV_GEOMETRIES[D96 if d == D96 else 64]


def dkv_walk(T, window, causal=True, offset=0, geometry=DKV_GEOMETRIES[64]):
    """[(k0, [(q0, (live for each key group of the CTA)), ...])]: the query
    tiles each dk/dv CTA walks and which of its warpgroups' key groups do
    their math on each (the forward's tile test on the group's keys, cut at
    T; a group whose keys all lie past T does none)."""
    bk, group = geometry
    bq = TILES["DKV_BQ"]
    nq = -(-T // bq)
    out = []
    for k0 in range(0, T, bk):
        lo = (nq if k0 + offset > T - 1 else max(0, (k0 + offset) // bq)) if causal else 0
        hi = min(nq - 1, (min(k0 + bk, T) - 2 + offset + window) // bq) if window > 0 else nq - 1
        tiles = []
        for qt in range(lo, hi + 1):
            q0 = qt * bq
            tiles.append((q0, tuple(k0 + g < T and _live(q0, bq, k0 + g, group, window, T, causal, offset)
                                    for g in range(0, bk, group))))
        out.append((k0, tiles))
    return out


def walk_bwd(q, k, v, kv_mask, o, lse, do, dlse, *, scale, window, dq_bk, skip=True, causal=True, offset=0,
             dkv=None):
    """(dq, dk, dv) by the kernels' walks, tile by tile, f32 sums over
    operands in the inputs' dtype, P and dS rounded to it; ``dkv`` is the
    dk/dv geometry (by default ``dkv_geometry`` of q's head dim).
    ``skip=False`` visits every tile of both walks (the skip must not change
    a bit)."""
    b, T, h, d = q.shape
    dkv = dkv or dkv_geometry(d)
    dt = q.dtype

    def heads(x):
        return x.float().permute(0, 2, 1, 3)  # [b, h, T, d]

    qf, kf, vf, dof = heads(q), heads(k), heads(v), heads(do)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2) - dlse.float()  # [b, h, T]
    # A row whose forward reached no key: +inf, so exp(s - lse) = 0 (the kernels' dead_or_log2).
    lsef = torch.where(lse.float() > flash_mod.DEAD_LSE, lse.float(), torch.full_like(lse.float(), float("inf")))
    km = kv_mask.float() > 0.5

    def rnd(x):
        return x.to(dt).float()

    def tile(r0, nr, k0, nk):
        """p and ds of query rows [r0, r0 + nr) and keys [k0, k0 + nk), both cut at T."""
        rows, keys = torch.arange(r0, min(r0 + nr, T)), torch.arange(k0, min(k0 + nk, T))
        s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2) * scale
        reach = torch.ones((len(rows), len(keys)), dtype=torch.bool)
        if causal:
            reach = reach & (keys[None, :] + offset <= rows[:, None])
        if window > 0:
            reach = reach & (keys[None, :] + offset > rows[:, None] - window)
        s = torch.where(reach[None, None] & km[:, None, None, keys], s, torch.full_like(s, flash_mod.MASK_VAL))
        p = torch.exp(s - lsef[:, :, rows, None])
        dp = dof[:, :, rows] @ vf[:, :, keys].transpose(-1, -2)
        return rows, keys, p, p * (dp - delta[:, :, rows, None])

    dq, dk, dv = (torch.zeros((b, h, T, d)) for _ in range(3))
    for q0, tiles in dq_walk(T, window, dq_bk, causal, offset):
        for w in range(TILES["DQ_BQ"] // WG_ROWS):
            r0 = q0 + w * WG_ROWS
            every = range(0, T, dq_bk) if r0 < T else ()
            visits = [k0 for k0, live in tiles if live[w]] if skip else every
            for k0 in visits:
                rows, keys, _, ds = tile(r0, WG_ROWS, k0, dq_bk)
                dq[:, :, rows] += rnd(ds) @ kf[:, :, keys]
    groups = range(0, dkv[0], dkv[1])
    for k0, tiles in dkv_walk(T, window, causal, offset, dkv):
        every = [(q0, tuple(k0 + g < T for g in groups)) for q0 in range(0, T, TILES["DKV_BQ"])]
        for q0, lives in tiles if skip else every:
            for g, lv in zip(groups, lives):
                if not lv:
                    continue
                rows, keys, p, ds = tile(q0, TILES["DKV_BQ"], k0 + g, dkv[1])
                dv[:, :, keys] += rnd(p).transpose(-1, -2) @ dof[:, :, rows]
                dk[:, :, keys] += rnd(ds).transpose(-1, -2) @ qf[:, :, rows]
    return tuple(x.permute(0, 2, 1, 3).to(dt) for x in (dq * scale, dk * scale, dv))


def _inputs(seed, T, d, pads, b=None, h=2):
    """Seeded numpy q/k/v (f32), key mask with ``pads[i]`` left-padded slots
    in row i, and cotangents that vanish on the padded rows."""
    rng = np.random.default_rng(seed)
    b = len(pads) if b is None else b
    q, k, v = (rng.normal(size=(b, T, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, T), np.float32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0.0
    rows = mask.astype(bool)
    do = (rng.normal(size=q.shape) * rows[:, :, None, None]).astype(np.float32)
    dlse = (rng.normal(size=(b, h, T)) * rows[:, None, :]).astype(np.float32)
    return q, k, v, mask, do, dlse


def _torch_case(arrays, dtype):
    q, k, v, mask, do, dlse = (torch.from_numpy(x) for x in arrays)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    return q, k, v, mask, do, dlse


def _plain_fwd(q, k, v, mask, scale, window):
    return flash_mod.flash_attention_plain(q, k, v, mask, scale=scale, window=window, return_lse=True)


# (T, window, left pads per row, dq key tile): T tails that are not multiples
# of the tiles, windows across tile edges, left padding that empties whole key
# tiles of a row (70 and 130 slots) and a fully masked row.
CASES = [
    (1, 0, (0, 0), 64),
    (37, 0, (0, 11), 32),
    (64, 0, (0, 64), 64),
    (100, 0, (5, 70), 32),
    (129, 48, (0, 70), 64),
    (150, 33, (64, 0), 32),
    (200, 5, (3, 130), 32),
    (200, 70, (0, 0), 64),
    (300, 100, (0, 130), 64),
]
CASE_IDS = [f"T{T}-w{w}-pad{p[0]}_{p[1]}-bk{bk}" for T, w, p, bk in CASES]


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("T,window,pads,dq_bk", CASES, ids=CASE_IDS)
def test_walk_matches_plain_backward(T, window, pads, dq_bk, d):
    """float32: the walk (with its skips) gives the plain backward's dq, dk,
    dv to float32 summation order (TOL)."""
    q, k, v, mask, do, dlse = _torch_case(_inputs(T + d, T, d, pads), torch.float32)
    scale = d ** -0.5
    o, lse = _plain_fwd(q, k, v, mask, scale, window)
    got = walk_bwd(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window, dq_bk=dq_bk)
    ref = flash_mod.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
    rows = mask.bool()
    torch.testing.assert_close(got[0][rows], ref[0][rows], **TOL)
    torch.testing.assert_close(got[1], ref[1], **TOL)
    torch.testing.assert_close(got[2], ref[2], **TOL)


@pytest.mark.parametrize("T,window,pads,dq_bk", [CASES[i] for i in (1, 3, 4, 6)],
                         ids=[CASE_IDS[i] for i in (1, 3, 4, 6)])
def test_walk_matches_pallas_vjp(T, window, pads, dq_bk):
    """float32: the walk against the Pallas backward (interpret mode, one
    block of T rows, so any T is legal) on the same inputs, to float32
    summation order (TOL)."""
    d = 16
    arrays = _inputs(7 * T, T, d, pads)
    q_np, k_np, v_np, mask_np, do_np, dlse_np = arrays
    scale = 0.25

    def f(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, jnp.asarray(mask_np), scale=scale, causal=True, window=window,
                                   block_q=T, block_k=T, interpret=True, return_lse=True)

    _, vjp = jax.vjp(f, jnp.asarray(q_np), jnp.asarray(k_np), jnp.asarray(v_np))
    ref = [np.asarray(x) for x in vjp((jnp.asarray(do_np), jnp.asarray(dlse_np)))]
    q, k, v, mask, do, dlse = _torch_case(arrays, torch.float32)
    o, lse = _plain_fwd(q, k, v, mask, scale, window)
    got = walk_bwd(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window, dq_bk=dq_bk)
    rows = mask_np.astype(bool)
    np.testing.assert_allclose(got[0].numpy()[rows], ref[0][rows], **TOL)
    np.testing.assert_allclose(got[1].numpy(), ref[1], **TOL)
    np.testing.assert_allclose(got[2].numpy(), ref[2], **TOL)


@pytest.mark.parametrize("T,window,pads,dq_bk", [CASES[i] for i in (2, 3, 5, 7)],
                         ids=[CASE_IDS[i] for i in (2, 3, 5, 7)])
def test_walk_rounds_p_and_ds_like_the_plain_backward(T, window, pads, dq_bk):
    """bf16 operands: P and dS rounded to bf16 before their products, as the
    plain backward (and the TPU kernels) round them. The bf16 outputs agree
    bit for bit but for at most 0.5% of their elements (a float32 sum in
    another order flips a rounding), each within 2^-7 of max |ref| (one
    output rounding on each side); without rounding P and dS, 10% or more of
    the elements of dq and dk differ."""
    d = 32
    q, k, v, mask, do, dlse = _torch_case(_inputs(3 * T, T, d, pads), torch.bfloat16)
    scale = d ** -0.5
    o, lse = _plain_fwd(q, k, v, mask, scale, window)
    ref = flash_mod.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
    got = walk_bwd(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window, dq_bk=dq_bk)
    wide = [x.float() if x.dtype == torch.bfloat16 else x for x in (q, k, v, mask, o, lse, do, dlse)]
    unrounded = [x.to(torch.bfloat16) for x in walk_bwd(*wide, scale=scale, window=window, dq_bk=dq_bk)]
    rows = mask.bool()
    for i, (g, u, r) in enumerate(zip(got, unrounded, ref)):
        if i == 0:
            g, u, r = g[rows], u[rows], r[rows]
        assert float((g != r).float().mean()) <= 5e-3
        assert float((g.float() - r.float()).abs().max()) <= 2.0 ** -7 * float(r.float().abs().max())
        if i < 2:
            assert float((u != r).float().mean()) >= 0.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T,window,pads,dq_bk", CASES, ids=CASE_IDS)
def test_skipped_tiles_add_nothing(T, window, pads, dq_bk, dtype):
    """The skips are exact: visiting every tile of both walks gives the same
    bits (a skipped tile holds no reachable pair, so its p is 0 on the valid
    rows, and the padded rows' dS is 0 with their zero cotangent)."""
    q, k, v, mask, do, dlse = _torch_case(_inputs(5 * T, T, 16, pads), dtype)
    o, lse = _plain_fwd(q, k, v, mask, 0.25, window)
    args = (q, k, v, mask, o, lse, do, dlse)
    walked = walk_bwd(*args, scale=0.25, window=window, dq_bk=dq_bk)
    every = walk_bwd(*args, scale=0.25, window=window, dq_bk=dq_bk, skip=False)
    for x, y in zip(walked, every):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bk", sorted(set(DQ_KEY_TILES)))
@pytest.mark.parametrize("window", [0, 1, 5, 48, 63, 64, 70, 130])
@pytest.mark.parametrize("T", [1, 31, 64, 100, 129, 300])
def test_walks_visit_every_reachable_pair_once(T, window, bk):
    """Every (query, key) pair reachable by position is visited exactly once
    by a dq warpgroup that does its math and exactly once by a dk/dv
    warpgroup, in both dk/dv geometries (the template's 64-key CTA, d = 96's
    128-key CTA of two 64-key halves); every tile whose math runs holds a
    reachable pair and every tile a warpgroup skips holds none; each dk/dv
    walk starts on its diagonal tile and stops at the last query tile that
    still sees its keys."""
    qi, kj = np.arange(T)[:, None], np.arange(T)[None, :]
    reach = kj <= qi
    if window > 0:
        reach &= kj > qi - window
    dq_seen = np.zeros((T, T), int)
    for q0, tiles in dq_walk(T, window, bk):
        for k0, live in tiles:
            for w, lv in enumerate(live):
                r0 = q0 + w * WG_ROWS
                block = reach[r0:r0 + WG_ROWS, k0:k0 + bk]
                assert lv == bool(block.any()), (q0, w, k0)
                if lv:
                    dq_seen[r0:r0 + WG_ROWS, k0:k0 + bk] += 1
    assert (dq_seen[reach] == 1).all()
    for geometry in DKV_GEOMETRIES.values():
        _check_dkv_walk(reach, T, window, True, 0, geometry, ends=True)


def _check_dkv_walk(reach, T, window, causal, offset, geometry, ends=False):
    """Every reachable pair is visited exactly once by a dk/dv warpgroup that
    does its math; a CTA's walk holds a live group on each of its tiles, a
    group's math runs exactly on the tiles holding a reachable pair of its
    keys, and (``ends``: offset 0) each walk starts on its first key's
    diagonal tile and stops at the last query tile that still sees a key."""
    bkv, group = geometry
    bq = TILES["DKV_BQ"]
    seen = np.zeros((T, T), int)
    for k0, tiles in dkv_walk(T, window, causal, offset, geometry):
        if ends:
            assert tiles[0][0] <= k0 < tiles[0][0] + bq
            after = tiles[-1][0] + bq
            assert after >= T or not reach[after:after + bq, k0:k0 + bkv].any()
        for q0, lives in tiles:
            assert any(lives), (k0, q0)
            for g, lv in zip(range(0, bkv, group), lives):
                assert lv == bool(reach[q0:q0 + bq, k0 + g:k0 + g + group].any()), (k0, g, q0)
                if lv:
                    seen[q0:q0 + bq, k0 + g:k0 + g + group] += 1
    assert (seen[reach] == 1).all()
    assert seen.max() <= 1



# The offset frame: ring chunk displacements (multiples of the chunk, and of
# half a chunk for zig-zag) and offsets that cut tiles, causal and not.
OFFSET_CASES = [
    (128, 0, True, -128), (128, 0, True, 128), (128, 0, True, -64), (128, 40, True, -128), (200, 0, True, 37),
    (200, 0, False, 0), (200, 70, False, -100), (150, 33, True, -150), (129, 48, False, 64), (300, 100, True, -200),
]
OFFSET_IDS = [f"T{T}-w{w}-{'causal' if c else 'full'}-off{o}" for T, w, c, o in OFFSET_CASES]


@pytest.mark.parametrize("dq_bk", sorted(set(DQ_KEY_TILES)))
@pytest.mark.parametrize("T,window,causal,offset", OFFSET_CASES, ids=OFFSET_IDS)
def test_offset_walk_matches_plain_backward(T, window, causal, offset, dq_bk):
    """float32, offset frame: the walk (with its skips, and p = 0 on rows
    that reach no key) gives the plain backward's dq, dk, dv, with nonzero
    cotangents on every row (TOL); rows that reach no key get dq = 0."""
    q, k, v, mask, do, dlse = _torch_case(_inputs(T + abs(offset), T, 16, (0, 9)), torch.float32)
    rows = mask.bool()
    do = torch.from_numpy(np.random.default_rng(T).normal(size=q.shape).astype(np.float32))
    modes = dict(scale=0.25, window=window, causal=causal, offset=offset)
    o, lse = flash_mod.flash_attention_plain(q, k, v, mask, return_lse=True, **modes)
    got = walk_bwd(q, k, v, mask, o, lse, do, dlse, dq_bk=dq_bk, **modes)
    ref = flash_mod.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, **modes)
    # Rows that reach keys but only masked ones carry cotangents here: the
    # walk spreads them over its tiles, the plain backward over every key.
    good = (flash_mod.reachable(T, T, "cpu", causal=causal, window=window, offset=offset)[None]
            & rows[:, None, :]).any(-1)
    reaches = flash_mod.reachable(T, T, "cpu", causal=causal, window=window, offset=offset).any(-1)
    keep = good | ~reaches[None]
    do2, dlse2 = do * keep[:, :, None, None], dlse * keep[:, None, :]
    got = walk_bwd(q, k, v, mask, o, lse, do2, dlse2, dq_bk=dq_bk, **modes)
    ref = flash_mod.flash_attention_bwd_plain(q, k, v, mask, o, lse, do2, dlse2, **modes)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, **TOL)
    assert (got[0][:, ~reaches] == 0).all()


@pytest.mark.parametrize("bk", sorted(set(DQ_KEY_TILES)))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("window", [0, 5, 64, 130])
@pytest.mark.parametrize("offset", [-256, -128, -64, -37, 0, 37, 64, 128, 256])
@pytest.mark.parametrize("T", [64, 129, 256])
def test_offset_walks_visit_every_reachable_pair_once(T, offset, window, causal, bk):
    """The offset twin of ``test_walks_visit_every_reachable_pair_once``:
    every (query, key) pair reachable in the offset frame is visited exactly
    once by a dq warpgroup that does its math and once by a dk/dv warpgroup
    in both dk/dv geometries; every tile whose math runs holds a reachable
    pair, every tile a warpgroup skips holds none, and every walk that is cut
    short stops where the next tile would hold none."""
    reach = flash_mod.reachable(T, T, "cpu", causal=causal, window=window, offset=offset).numpy()
    dq_seen = np.zeros((T, T), int)
    for q0, tiles in dq_walk(T, window, bk, causal, offset):
        for k0, live in tiles:
            for w, lv in enumerate(live):
                r0 = q0 + w * WG_ROWS
                assert lv == bool(reach[r0:r0 + WG_ROWS, k0:k0 + bk].any()), (q0, w, k0)
                if lv:
                    dq_seen[r0:r0 + WG_ROWS, k0:k0 + bk] += 1
        # Tiles outside the walk hold no reachable pair of this CTA's rows.
        walked = {k0 for k0, _ in tiles}
        for k0 in range(0, T, bk):
            if k0 not in walked:
                assert not reach[q0:q0 + TILES["DQ_BQ"], k0:k0 + bk].any(), (q0, k0)
    assert (dq_seen[reach] == 1).all()
    for geometry in DKV_GEOMETRIES.values():
        _check_dkv_walk(reach, T, window, causal, offset, geometry)


def walk_bwd_boxed(q, k, v, kv_mask, o, lse, do, dlse, *, scale, window, causal=True, offset=0):
    """``walk_bwd`` on the kernels' shared-memory layouts at d = 96: dq on q,
    k, v and dO padded with zero columns to whole 64-column boxes (TMA's
    fill past d) with its key tile of this d, its padded columns checked to
    be exactly 0 before they are cut (the kernel does not store them); dk
    and dv on whole BOX_D96-column boxes (no padding) in the d = 96
    geometry."""
    d = q.shape[-1]

    def pad(x, box):
        return torch.nn.functional.pad(x, (0, -(-d // box) * box - d))

    def walk(box):
        return walk_bwd(*(pad(x, box) for x in (q, k, v)), kv_mask, pad(o, box), lse, pad(do, box), dlse,
                        scale=scale, window=window, dq_bk=dq_key_tile(d), causal=causal, offset=offset,
                        dkv=dkv_geometry(d))

    dq = walk(TILES["BOX_COLS"])[0]
    assert (dq[..., d:] == 0).all()
    assert d % TILES["BOX_D96"] == 0
    _, dk, dv = walk(TILES["BOX_D96"])
    return dq[..., :d], dk, dv


@pytest.mark.parametrize("T,window,pads", [(1, 0, (0, 0)), (129, 48, (0, 70)), (200, 5, (3, 130)),
                                           (300, 100, (0, 130))])
def test_walk_at_head_dim_96_matches_plain_and_pallas(T, window, pads):
    """d = 96, float32: the walks on the kernels' layouts (dq: two 64-column
    boxes, the second half zeros, 64-key tiles; dk/dv: three 32-column boxes,
    128-key CTAs of two warpgroup halves) give the plain backward's dq, dk,
    dv and the Pallas backward's (interpret mode, one block of T rows) to
    float32 summation order (TOL)."""
    d = 96
    assert -(-d // TILES["BOX_COLS"]) == 2 and dq_key_tile(d) == TILES["DQ_BK"]
    assert dkv_geometry(d) == (TILES["DKV_BK_D96"], TILES["DKV_WG_KEYS"]) == (128, 64)
    arrays = _inputs(11 * T, T, d, pads)
    q, k, v, mask, do, dlse = _torch_case(arrays, torch.float32)
    scale = d ** -0.5
    o, lse = _plain_fwd(q, k, v, mask, scale, window)
    got = walk_bwd_boxed(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
    ref = flash_mod.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
    rows = mask.bool()
    torch.testing.assert_close(got[0][rows], ref[0][rows], **TOL)
    torch.testing.assert_close(got[1], ref[1], **TOL)
    torch.testing.assert_close(got[2], ref[2], **TOL)
    q_np, k_np, v_np, mask_np, do_np, dlse_np = arrays

    def f(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, jnp.asarray(mask_np), scale=scale, causal=True, window=window,
                                   block_q=T, block_k=T, interpret=True, return_lse=True)

    _, vjp = jax.vjp(f, jnp.asarray(q_np), jnp.asarray(k_np), jnp.asarray(v_np))
    want = [np.asarray(x) for x in vjp((jnp.asarray(do_np), jnp.asarray(dlse_np)))]
    np.testing.assert_allclose(got[0].numpy()[rows.numpy()], want[0][rows.numpy()], **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], **TOL)
    np.testing.assert_allclose(got[2].numpy(), want[2], **TOL)


@pytest.mark.parametrize("T,window,causal,offset", [OFFSET_CASES[i] for i in (0, 4, 6, 9)],
                         ids=[OFFSET_IDS[i] for i in (0, 4, 6, 9)])
def test_offset_walk_at_head_dim_96(T, window, causal, offset):
    """d = 96 in the offset frame, causal and not, bf16 operands: the boxed
    walks against the same walks on the unpadded d = 96 tensors bit for bit
    (dq's zero columns add exact zeros to every sum over d and produce only
    zero columns), the d = 96 dk/dv geometry against the template's bit for
    bit (each key's sums run over the same query tiles in the same order),
    and against the plain backward within 2^-7 of each output's max (one
    bf16 output rounding on each side)."""
    d = 96
    q, k, v, mask, do, dlse = _torch_case(_inputs(T + 96 + abs(offset), T, d, (0, 9)), torch.bfloat16)
    modes = dict(scale=d ** -0.5, window=window, causal=causal, offset=offset)
    o, lse = flash_mod.flash_attention_plain(q, k, v, mask, return_lse=True, **modes)
    reach = flash_mod.reachable(T, T, "cpu", causal=causal, window=window, offset=offset)
    keep = (reach[None] & mask.bool()[:, None, :]).any(-1) | ~reach.any(-1)[None]
    do, dlse = (do * keep[:, :, None, None]).to(torch.bfloat16), dlse * keep[:, None, :]
    boxed = walk_bwd_boxed(q, k, v, mask, o, lse, do, dlse, **modes)
    plain_walk = walk_bwd(q, k, v, mask, o, lse, do, dlse, dq_bk=dq_key_tile(d), **modes)
    template = walk_bwd(q, k, v, mask, o, lse, do, dlse, dq_bk=dq_key_tile(d), dkv=DKV_GEOMETRIES[64], **modes)
    ref = flash_mod.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, **modes)
    for b_, w_, t_, r in zip(boxed, plain_walk, template, ref):
        assert torch.equal(b_, w_) and torch.equal(w_, t_)
        assert float((b_.float() - r.float()).abs().max()) <= 2.0 ** -7 * float(r.float().abs().max())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("window", [0, 48, 300])
@pytest.mark.parametrize("offset", [-1024, -300, 0, 37, 512])
@pytest.mark.parametrize("T", [1, 65, 130, 1000, 1024])
def test_dkv_d96_schedule_completes(T, offset, window, causal):
    """The schedule of every d = 96 dk/dv CTA (``torch_flash_schedule``: the
    producer's Q / dO ring of DKV_STAGES_D96 stages, both warpgroups' rounds
    and turns) runs to its end: each warpgroup takes n + 1 turns, observes
    every phase of the ring, frees every stage once, issues S^T / dP^T and
    dv / dk of each live tile once in order, and no stage is refilled
    before both warpgroups freed it."""
    for k0, tiles in dkv_walk(T, window, causal, offset, DKV_GEOMETRIES[D96]):
        runs = []
        for g in range(2):
            idx = [i for i, (_, lives) in enumerate(tiles) if lives[g]]
            assert idx == list(range(idx[0], idx[-1] + 1)) if idx else True  # one contiguous run
            runs.append((idx[0], idx[-1]) if idx else (len(tiles), -1))
        schedule.simulate(len(tiles), runs, schedule.DKV, TILES["DKV_STAGES_D96"])
