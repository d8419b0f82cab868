"""The walk of the fused-logprob kernels' f32 mode on the CPU: a plain model,
written here, of the thread-level index maps and of the tiles each kernel
visits, held against the plain versions and the JAX package's Pallas
kernels (interpret mode) on f32 inputs. The tile sizes and the operand forms
are read from the sources; the V split is the wrapper's own.

- The forward, ds and dx kernels (``csrc/fused_logprob.cu``
  ``logprob_fwd_f32_kernel``, ``csrc/fused_logprob_bwd.cu``
  ``logprob_ds_f32_kernel`` / ``logprob_dx_f32_kernel``) run on the 3xTF32
  mainloop of ``csrc/logprob_gemm_tf32.cuh``: 128 x 128 tiles, reduction
  chunks of 32 (TMA boxes of 128 bytes under the 128-byte swizzle, zeros
  past the edges), rounded up to whole promotion groups; each operand value
  split into hi = rna_tf32(v), lo = rna_tf32(v - hi), and per chunk
  a_hi·b_hi + a_lo·b_hi + a_hi·b_lo summed into a group accumulator that is
  added into the tile's f32 accumulator after each promotion group. The A
  fragments come from registers (the wgmma register layout), B from shared
  memory K-major: the consumers split the raw B tile into B_hi and B_lo,
  transposing an MN-major tile on the way.
- The dW kernel (``logprob_dw_f32_kernel``, row 6f) runs on the same
  mainloop as one product for both cases, C = xᵀ·ds [D, V] over the rows
  (tied dW = Cᵀ, stored transposed by the epilogue): x is first transposed
  into a scratch [D, rows rounded up to 4] (``transpose_f32_kernel``, 32 x 32
  tiles through shared memory), which the mainloop reads as a K-major A, and
  ds goes in as an MN-major B, as the untied forward takes W. A persistent
  grid of min(tiles, SMs) CTAs walks the 128 x 128 output tiles in groups of
  ``DW_GROUP_M`` m-tiles, the m-tile fastest within a group.
- Forward: one CTA per (128-row tile, V split); a split walks its 128-column
  tiles; per tile and row the max over the quad that holds the row, then the
  online (m, l, r, label score); the merge kernel of the bf16 mode combines
  the splits.
- Backward: per chunk of BWD_CHUNK_ROWS rows, ds in f32 into [C, ldv] (zero
  past V and past the chunk's rows) with the db column partials of each row
  tile (each warp's 16 rows, then the 8 warps in order), dx = ds·Wᵀ (ds·W
  tied) over 128 x 128 tiles, then dW = xᵀ·ds (dsᵀ·x tied) once over every
  row, each element stored once.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.fused_logprob import fused_logprob as jax_fused_logprob
from trlx_tpu_torch.ops import cuda_lib
from trlx_tpu_torch.ops import fused_logprob as flp

torch.set_num_threads(1)

M_INIT, MASK_VAL = -1e30, -1e9
TOL = dict(rtol=1e-4, atol=1e-4)  # float32 on both sides: the summation order differs
F32_REL = 1e-4  # the f32 mode's tolerance on (logprob, lse, entropy): |d| <= 1e-4 * max(1, |ref|)
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may hold on an H100


def _source(name):
    with open(os.path.join(cuda_lib._CSRC, name)) as f:
        return f.read()


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _constants():
    tg, bwd = _source("logprob_gemm_tf32.cuh"), _source("fused_logprob_bwd.cu")
    out = {n: _constant(tg, n) for n in ("TG_BM", "TG_BN", "TG_BK", "TG_STAGES", "TG_SPLITS", "TG_GROUP", "TG_THREADS")}
    out.update({n: _constant(bwd, n) for n in ("XT_TILE", "XT_ROWS", "DW_GROUP_M")})
    return out


K = _constants()
TBM, TBN, TBK, GROUP = K["TG_BM"], K["TG_BN"], K["TG_BK"], K["TG_GROUP"]
XT_TILE, XT_ROWS, DW_GROUP_M = K["XT_TILE"], K["XT_ROWS"], K["DW_GROUP_M"]
MN_BOX = 32 * TBK * 4  # bytes of one MN-major box of B: 32 columns x TBK reduction rows


# ---- the 3xTF32 mainloop ------------------------------------------------------

def rna_tf32(v) -> np.ndarray:
    """cvt.rna.tf32.f32 on the f32 word: add half of the 13 dropped mantissa
    bits' range to the magnitude bits (ties away from zero), clear them."""
    bits = np.asarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(v):
    """(hi, lo) = (rna_tf32(v), rna_tf32(v - hi)); v - hi is exact in f32."""
    v = np.asarray(v, dtype=np.float32)
    hi = rna_tf32(v)
    return hi, rna_tf32(v - hi)


def tg_chunks(k: int) -> int:
    """``tg_chunks``: reduction chunks rounded up to whole promotion groups."""
    return -(-k // (TBK * GROUP)) * GROUP


def swizzle(logical):
    """The 128-byte swizzle on a byte offset from a 1024-aligned base: bits
    4-6 (the 16-byte chunk of a 128-byte row) xor bits 7-9 (the row mod 8),
    as TMA writes a box and the wgmma descriptor reads it."""
    logical = np.asarray(logical)
    return logical ^ (((logical >> 7) & 7) << 4)


def tg_swz(r, c):
    """``tg_swz``: byte offset of element (r, c) of a [rows][32] f32 tile."""
    return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2)


def tg_tile(a, b, b_kmajor, m0, n0, kred):
    """The 128 x 128 f32 tile at (m0, n0) of A·B as the 3xTF32 mainloop
    computes it: A stored [m][k] (K-major), B stored [n][k] when K-major
    else [k][n]; the reduction in TBK chunks over ``tg_chunks`` (zeros past
    every edge, as TMA fills them), each value split into TF32 hi and lo,
    the three products of each promotion group summed into a group
    accumulator rounded to f32, which is added into the f32 tile."""
    nk = tg_chunks(kred)
    kpad = nk * TBK
    ap = np.zeros((TBM, kpad), dtype=np.float32)
    bp = np.zeros((kpad, TBN), dtype=np.float32)
    blk = a[m0:m0 + TBM, :kpad]
    ap[:blk.shape[0], :blk.shape[1]] = blk
    bt = b[n0:n0 + TBN, :kpad].T if b_kmajor else b[:kpad, n0:n0 + TBN]
    bp[:bt.shape[0], :bt.shape[1]] = bt
    (ah, al), (bh, bl) = tf32_split(ap), tf32_split(bp)
    acc = np.zeros((TBM, TBN), dtype=np.float32)
    span = GROUP * TBK
    for k0 in range(0, kpad, span):
        sl = slice(k0, k0 + span)
        h, l, bh64, bl64 = ah[:, sl].astype(np.float64), al[:, sl].astype(np.float64), bh[sl], bl[sl]
        part = (h @ bh64 + l @ bh64 + h @ bl64).astype(np.float32)
        acc = (acc + part).astype(np.float32)
    return acc


def split_pass_map(b_kmajor: bool):
    """``tg_split_b``: for consumer thread ct (0..255), step i (0..3) and
    element e (0..3), the byte offset read in the raw B tile and the byte
    offset written in B_hi and B_lo. Arrays shaped [4, 256, 4]."""
    i, ct, e = np.meshgrid(np.arange(4), np.arange(256), np.arange(4), indexing="ij")
    p = i * 256 + ct
    if b_kmajor:
        src = dst = p * 16 + 4 * e
    else:
        n, kg = p % TBN, p // TBN
        src = (n >> 5) * MN_BOX + tg_swz(4 * kg + e, n & 31)
        dst = tg_swz(n, 4 * kg + e)
    return src, dst


def raw_b_tile(b_tile, b_kmajor: bool):
    """The raw B tile as TMA lands it, one float per 4 bytes: K-major, one
    box [128 columns][32 reductions] (b_tile[k][n] at tg_swz(n, k));
    MN-major, four boxes [32 reductions][32 columns] one after another."""
    raw = np.full(TBN * TBK, np.nan, dtype=np.float32)
    k, n = np.meshgrid(np.arange(TBK), np.arange(TBN), indexing="ij")
    off = tg_swz(n, k) if b_kmajor else (n >> 5) * MN_BOX + tg_swz(k, n & 31)
    raw[off // 4] = b_tile[k, n]
    return raw


def a_fragment_map():
    """``tg_load_a``: for consumer warpgroup cw, warp, lane and k-step kk,
    register e holds A[r][c], r = 64 cw + 16 warp + g + 8 (e & 1), c = 8 kk
    + t + 4 (e >> 1), lane = 4 g + t. Arrays shaped [2, 4, 32, 4, 4]."""
    cw, warp, lane, kk, e = np.meshgrid(np.arange(2), np.arange(4), np.arange(32), np.arange(TBK // 8),
                                        np.arange(4), indexing="ij")
    g, t = lane >> 2, lane & 3
    return cw * 64 + warp * 16 + g + 8 * (e & 1), 8 * kk + t + 4 * (e >> 1)


# ---- row 6f: the transpose, the persistent walk, the epilogue's stores ---------

def transpose_map(rows: int, D: int):
    """``transpose_f32_kernel``'s index map over its grid (ceil(rows / 32),
    ceil(D / 32)) of 32 x 8 threads: for every read, (block, thread, step,
    shared offset, row r, column d of x); for every write, (block, thread,
    step, shared offset, column d, row r of xt). Only in-bounds accesses."""
    bx, by, ty, tx, i = np.meshgrid(np.arange(-(-rows // XT_TILE)), np.arange(-(-D // XT_TILE)),
                                    np.arange(XT_ROWS), np.arange(XT_TILE), np.arange(XT_TILE // XT_ROWS),
                                    indexing="ij")
    j = ty + XT_ROWS * i
    pitch = XT_TILE + 1
    r, d = bx * XT_TILE + j, by * XT_TILE + tx  # the read
    ok = (r < rows) & (d < D)
    reads = (bx[ok], by[ok], ty[ok], tx[ok], i[ok], (j * pitch + tx)[ok], r[ok], d[ok])
    d, r = by * XT_TILE + j, bx * XT_TILE + tx  # the write
    ok = (d < D) & (r < rows)
    writes = (bx[ok], by[ok], ty[ok], tx[ok], i[ok], (tx * pitch + j)[ok], d[ok], r[ok])
    return reads, writes


def _warps(block_x, block_y, ty, step, lane, *values):
    """Group per-access arrays by warp (block, thread row, step): for each
    warp, its accesses' values ordered by lane."""
    order = np.lexsort((lane, step, ty, block_y, block_x))
    key = np.stack([block_x, block_y, ty, step])[:, order]
    cuts = np.flatnonzero(np.any(np.diff(key, axis=1) != 0, axis=0)) + 1
    return [np.split(v[order], cuts) for v in values]


@pytest.mark.parametrize("rows,D", [(50, 64), (97, 256), (1027, 96), (1, 32)])
def test_transpose_covers_a_ragged_x_once(rows, D):
    """Row 6f's transpose of x [rows, D] into the scratch [D, ldr], ldr =
    rows rounded up to 4 (``fused_logprob_bwd_dw_f32``): every element of x
    is read once and lands at xt[d][r] once, through the shared slot its
    block's write step reads back; the pad columns r >= rows are never
    written (the kernel's TMA map of xt ends at rows and fills zeros); each
    warp reads and writes consecutive floats of memory, and its 32 shared
    accesses hit 32 distinct banks of the 33-float-pitch tile."""
    assert (XT_TILE, XT_ROWS) == (32, 8)
    ldr = -(-rows // 4) * 4
    (rb, rby, rty, rtx, ri, roff, r, d), (wb, wby, wty, wtx, wi, woff, wd, wr) = transpose_map(rows, D)
    x = np.random.default_rng(rows).normal(size=(rows, D)).astype(np.float32)
    assert len(set(zip(r.tolist(), d.tolist()))) == r.size == rows * D
    slots = list(zip(rb.tolist(), rby.tolist(), roff.tolist()))
    assert len(set(slots)) == len(slots)
    shared = dict(zip(slots, x[r, d].tolist()))
    xt = np.full((D, ldr), np.nan, dtype=np.float32)
    count = np.zeros((D, ldr), dtype=np.int32)
    np.add.at(count, (wd, wr), 1)
    xt[wd, wr] = [shared[k] for k in zip(wb.tolist(), wby.tolist(), woff.tolist())]
    assert (count[:, :rows] == 1).all() and (count[:, rows:] == 0).all()
    np.testing.assert_array_equal(xt[:, :rows], x.T)
    for (b0, b1, ty, step, lane, off, mem) in ((rb, rby, rty, ri, rtx, roff, r * D + d),
                                                (wb, wby, wty, wi, wtx, woff, wd * ldr + wr)):
        offs, mems = _warps(b0, b1, ty, step, lane, off, mem)
        for o, m in zip(offs, mems):
            assert len(set((o % 32).tolist())) == len(o)
            assert (np.diff(m) == 1).all()


def dw_f32_tile(t: int, m_tiles: int, n_tiles: int, group: int = DW_GROUP_M):
    """``dw_f32_tile``: (m-tile, n-tile) of output tile t, groups of
    ``group`` m-tiles (the last may be narrower), the m-tile fastest in a
    group."""
    per_group = group * n_tiles
    m_first = t // per_group * group
    gm = min(group, m_tiles - m_first)
    local = t % per_group
    return m_first + local % gm, local // gm


def dw_walk(m_tiles: int, n_tiles: int, sms: int, group: int = DW_GROUP_M):
    """Each CTA's tiles in the order it runs them: a grid of min(tiles, sms)
    CTAs, CTA b taking t = b, b + grid, ..."""
    tiles = m_tiles * n_tiles
    grid = min(tiles, sms)
    return [[dw_f32_tile(t, m_tiles, n_tiles, group) for t in range(b, tiles, grid)] for b in range(grid)]


@pytest.mark.parametrize("m_tiles,n_tiles,sms", [(1, 8, 132), (2, 9, 132), (64, 394, 132), (13, 40, 16), (5, 3, 4)],
                         ids=["tiles<sms", "ragged-group<sms", "q-heads", "ragged-last-group", "tiny-grid"])
def test_dw_walk_visits_each_tile_once(m_tiles, n_tiles, sms):
    """Row 6f's persistent walk, in the source's order: every output tile is
    visited by exactly one CTA, the CTAs' loads differ by at most one tile,
    and the walk is the one ``fused_logprob_bwd.cu`` runs (its tile map, its
    loops over t and its grid)."""
    walk = dw_walk(m_tiles, n_tiles, sms)
    assert len(walk) == min(m_tiles * n_tiles, sms)
    seen = [mn for cta in walk for mn in cta]
    assert sorted(seen) == [(m, n) for m in range(m_tiles) for n in range(n_tiles)]
    assert max(map(len, walk)) - min(map(len, walk)) <= 1
    src = _source("fused_logprob_bwd.cu")
    body = src[src.index("void dw_f32_tile("):]
    body = body[:body.index("}")]
    for line in ("const int per_group = DW_GROUP_M * p.n_tiles;",
                 "const int m_first = t / per_group * DW_GROUP_M;",
                 "const int gm = min(DW_GROUP_M, p.m_tiles - m_first);",
                 "const int local = t % per_group;", "mt = m_first + local % gm;", "nt = local / gm;"):
        assert line in body, line
    kernel = src[src.index("logprob_dw_f32_kernel(const __grid_constant__"):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert kernel.count("for (int t = blockIdx.x; t < tiles; t += gridDim.x) {") == 2
    assert kernel.count("dw_f32_tile(p, t, mt, nt);") == 2
    assert "logprob_dw_f32_kernel<<<min(p.m_tiles * p.n_tiles, sms), TG_THREADS, smem, s>>>" in src


def test_dw_walk_keeps_a_wave_in_l2():
    """Why the grouped walk (the reckoning in ``dw_f32_tile``'s comment): at
    the Q heads' D = 8192, V = 50400, rows = 4092 on 132 SMs, the median wave
    (132 consecutive t) touches 23 distinct 128-wide panels of xᵀ and ds,
    each 128 x 4092 f32 (2.1 MB): under the 50 MB L2, and ~9.7 GB over the
    call's waves. Row 6's order (the m-tile fastest over all 64) touches 67:
    more than the L2 holds, and ~2.8x the traffic."""
    m_tiles, n_tiles, sms = 8192 // TBM, -(-50400 // TBN), 132
    panel = TBM * 4092 * 4

    def panels(group):
        out = []
        for w0 in range(0, m_tiles * n_tiles, sms):
            mn = [dw_f32_tile(t, m_tiles, n_tiles, group) for t in range(w0, min(w0 + sms, m_tiles * n_tiles))]
            out.append(len({m for m, _ in mn}) + len({n for _, n in mn}))
        return np.asarray(out)

    grouped, m_fastest = panels(DW_GROUP_M), panels(m_tiles)
    assert np.median(grouped) * panel < 50e6 < np.median(m_fastest) * panel, (np.median(grouped), np.median(m_fastest))
    assert 2.5 * grouped.sum() < m_fastest.sum(), (grouped.sum(), m_fastest.sum())


def dw_stores(mt: int, nt: int, D: int, V: int, tied: bool):
    """The epilogue's stores of output tile (mt, nt) of C = xᵀ·ds: for each
    consumer thread (cw, warp, lane), h and j, accumulator acc[4 j + 2 h + e]
    is C[d][v], d = 128 mt + 64 cw + 16 warp + g + 8 h, v = 128 nt + 8 j +
    2 t4 + e; stored to dW[d][v] untied (a float2 pair where V is even), to
    dW[v][d] tied; nothing past D or V. Returns (tile row, tile column, flat
    offset into dW, stored as part of a float2 pair)."""
    cw, warp, lane, h, j, e = np.meshgrid(np.arange(2), np.arange(4), np.arange(32), np.arange(2),
                                          np.arange(TBN // 8), np.arange(2), indexing="ij")
    g, t4 = lane >> 2, lane & 3
    d = mt * TBM + cw * 64 + warp * 16 + g + 8 * h
    v = nt * TBN + 8 * j + 2 * t4 + e
    ok = (d < D) & (v < V)
    off = v * D + d if tied else d * V + v
    pair = np.zeros_like(ok) if tied else (V % 2 == 0) & (nt * TBN + 8 * j + 2 * t4 + 1 < V)
    return (d - mt * TBM)[ok], (v - nt * TBN)[ok], off[ok], pair[ok]


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("D,V", [(256, 1000), (384, 1027)])
def test_dw_stores_cover_the_output_once(D, V, tied):
    """The dW epilogue over every tile: each element of dW ([D, V] untied,
    [V, D] tied: C stored transposed) is written once with C's element at
    its place, nothing past the edges; a float2 pair starts on an 8-byte
    boundary."""
    C = np.random.default_rng(D + V).normal(size=(D, V)).astype(np.float32)
    dw = np.zeros(D * V, dtype=np.float32)
    count = np.zeros(D * V, dtype=np.int32)
    for mt, nt in (mn for cta in dw_walk(-(-D // TBM), -(-V // TBN), sms=4) for mn in cta):
        r, c, off, pair = dw_stores(mt, nt, D, V, tied)
        np.add.at(count, off, 1)
        dw[off] = C[mt * TBM + r, nt * TBN + c]
        assert (off[pair & (c % 2 == 0)] % 2 == 0).all()
    assert (count == 1).all()
    np.testing.assert_array_equal(dw.reshape((V, D) if tied else (D, V)), C.T if tied else C)


def test_operand_forms_of_the_sources():
    """The kernels instantiate the 3xTF32 mainloop with the operand forms
    the model uses: x K-major with W K-major only when tied (forward, ds);
    ds K-major with W K-major only when untied (dx); for dW, xᵀ K-major from
    the transposed scratch and ds MN-major (``tg_tile<false>``, the untied
    forward's call), over TF32 ``wgmma``. The SIMT SGEMM mainloop is gone:
    no source includes ``sgemm_f32.cuh`` and the file does not exist. Four
    kernels on the 3xTF32 mainloop, one CTA an SM; the wrapper sizes the
    forward and ds grids for that occupancy."""
    fwd, bwd = _source("fused_logprob.cu"), _source("fused_logprob_bwd.cu")
    assert "tg_produce<TIED>(ring, &tx, &tw, m0, vt_lo, vt_hi, nk);" in fwd
    assert "tg_tile<TIED>(ring, acc, cw, ct, nk, it);" in fwd
    assert "tg_produce<TIED>(ring, &tx, &tw, m0, vt_lo, vt_hi, nk);" in bwd
    assert "tg_tile<TIED>(ring, acc, cw, tid, nk, it);" in bwd
    assert "tg_produce<!TIED>(ring, &tds, &tw, m0, dt, dt + 1, nk);" in bwd
    assert "tg_tile<!TIED>(ring, acc, cw, tid, nk, it);" in bwd
    assert "tg_produce_tile<false>(ring, &txt, &tds, mt * TG_BM, nt * TG_BN, p.nk, it);" in bwd
    assert "tg_tile<false>(ring, acc, cw, ct, p.nk, it);" in bwd
    # x^T: (reduction = row of x, output row = column of x) in 128-row boxes; ds: (v, row) in 32 x 32 boxes.
    assert "make_map_2d<4>(&txt, xt, rows, D, ldr, TG_BM)" in bwd
    assert "make_map_2d<4>(&tds, ds, V, rows, ldv, TG_BK)" in bwd
    tg = _source("logprob_gemm_tf32.cuh")
    assert tg.count("wgmma_tf32_rs_n128(") == 3
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in _source("hopper.cuh")
    names = os.listdir(cuda_lib._CSRC)
    assert "sgemm_f32.cuh" not in names
    for name in names:
        if name.endswith((".cu", ".cuh")):
            assert "sgemm" not in _source(name), name
    tgb = re.findall(r"__launch_bounds__\(TG_THREADS, (\d+)\)", fwd + bwd)
    assert len(tgb) == 4 and set(tgb) == {str(flp._F32_CTAS_PER_SM)}
    assert "SG_THREADS" not in fwd + bwd
    assert (flp._F32_BM, flp._F32_BN) == (TBM, TBN)


def test_tf32_mainloop_layout_and_shared_memory():
    """The 3xTF32 mainloop's constants: 128 x 128 tiles in two consumer
    warpgroups of 64 rows, a reduction chunk of one 128-byte swizzle row of
    f32, three split buffers (the one-barrier-a-chunk reuse argument needs
    three), promotion groups that take the two A register sets in turn, and
    a ds kernel (ring, split buffers, barriers, two [8][128] column-sum
    buffers, 1 KB to align) within the 227 KB a CTA may hold."""
    assert (TBM, TBN, TBK, K["TG_THREADS"]) == (128, 128, 32, 384)
    assert K["TG_SPLITS"] == 3 and GROUP % 2 == 0 and K["TG_STAGES"] >= 2
    ring = K["TG_STAGES"] * (TBM + TBN) * TBK * 4
    split = K["TG_SPLITS"] * 2 * TBN * TBK * 4
    ds_smem = ring + split + 16 * K["TG_STAGES"] + 2 * 8 * TBN * 4 + 1024
    assert ds_smem <= SMEM_LIMIT, ds_smem
    # Chunks round up to whole groups; past K they are zeros.
    assert [tg_chunks(k) for k in (32, 64, 96, 8192, 50400)] == [
        -(-c // GROUP) * GROUP for c in (1, 2, 3, 256, 1575)]


def test_swizzle_offsets_are_the_descriptor_layout():
    """``tg_swz`` (the byte offset the kernel computes for element (r, c) of
    a [rows][32] f32 tile) is the 128-byte swizzle of the row-major offset:
    the layout TMA writes and the K-major wgmma descriptor reads (k-step kk
    starts 32 kk bytes into each 128-byte row, 8-row groups 1024 bytes
    apart)."""
    r, c = np.meshgrid(np.arange(256), np.arange(32), indexing="ij")
    np.testing.assert_array_equal(tg_swz(r, c), swizzle(r * 128 + c * 4))
    assert len(np.unique(tg_swz(r, c))) == r.size


@pytest.mark.parametrize("b_kmajor", [True, False], ids=["kmajor", "mn-major"])
def test_split_pass_covers_each_element_once(b_kmajor):
    """``tg_split_b``'s index map: the 256 consumer threads read every float
    of the raw B tile once and write every float of B_hi and B_lo once;
    what lands at (n, k) of the K-major swizzled layout the descriptor reads
    is B[k][n] (an MN-major tile transposed on the way); no bank conflicts:
    a warp's scalar reads hit 32 distinct banks, and the 8 lanes of each
    float4 phase touch 8 distinct 16-byte chunks of a 128-byte line."""
    src, dst = split_pass_map(b_kmajor)
    assert sorted(src.ravel().tolist()) == list(range(0, TBN * TBK * 4, 4))
    assert sorted(dst.ravel().tolist()) == list(range(0, TBN * TBK * 4, 4))
    b_tile = np.random.default_rng(1).normal(size=(TBK, TBN)).astype(np.float32)
    raw = raw_b_tile(b_tile, b_kmajor)
    out = np.full(TBN * TBK, np.nan, dtype=np.float32)
    out[dst.ravel() // 4] = raw[src.ravel() // 4]
    n, k = np.meshgrid(np.arange(TBN), np.arange(TBK), indexing="ij")
    np.testing.assert_array_equal(out[tg_swz(n, k) // 4], b_tile[k, n])
    def phases_distinct(offsets):  # float4 accesses: 4 phases of 8 lanes
        chunks = offsets // 16
        return all(len(set((chunks[8 * ph:8 * ph + 8] % 8).tolist())) == 8 for ph in range(4))

    for i in range(4):
        for w in range(8):
            lanes = slice(32 * w, 32 * w + 32)
            if b_kmajor:  # one float4 read a lane
                assert phases_distinct(src[i, lanes, 0])
            else:  # four scalar reads a lane, down one box
                for e in range(4):
                    assert len(set(((src[i, lanes, e] // 4) % 32).tolist())) == 32
            assert phases_distinct(dst[i, lanes, 0])


def test_a_fragments_cover_the_box_once():
    """``tg_load_a``'s map: each consumer warpgroup's registers hold each
    element of its 64 rows x 32 reductions of the raw A box once, each
    k-step's four registers in the wgmma A layout of hopper.cuh (rows g and
    g + 8, columns t and t + 4 of the k-step's 8); every read of a warp hits
    32 distinct banks."""
    rows, cols = a_fragment_map()
    for cw in range(2):
        r, c = rows[cw], cols[cw]
        assert r.min() == 64 * cw and r.max() == 64 * cw + 63
        assert len(set(zip(r.ravel().tolist(), c.ravel().tolist()))) == 64 * TBK == r.size
    kk = np.arange(TBK // 8)[None, None, None, :, None]
    assert ((cols - 8 * kk >= 0) & (cols - 8 * kk < 8)).all()
    banks = (tg_swz(rows, cols) // 4) % 32
    for idx in np.ndindex(2, 4, 1, TBK // 8, 4):
        cw, w, _, kk_, e = idx
        assert len(set(banks[cw, w, :, kk_, e].tolist())) == 32


def _outputs(s):
    """(lse, entropy, logprob of column 0) of f64 scores [N, V]."""
    s = s.astype(np.float64)
    m = s.max(1, keepdims=True)
    e = np.exp(s - m)
    lse = m[:, 0] + np.log(e.sum(1))
    p = e / e.sum(1, keepdims=True)
    return lse, lse - (p * s).sum(1), s[:, 0] - lse


def _scaled_err(got, ref):
    return max(float((np.abs(g - r) / np.maximum(1.0, np.abs(r))).max()) for g, r in zip(got, ref))


def _q_head_scores(V, seed):
    """x [16, 8192] a ReLU hidden and W [8192, V] with the logit spread of a
    trained Q head (std ~3.5), f32, and their f64 product."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(16, 8192)), 0).astype(np.float32)
    w = (rng.normal(size=(8192, V)) * 3.5 * 8192 ** -0.5).astype(np.float32)
    return x, w, x.astype(np.float64) @ w.astype(np.float64)


def test_three_tf32_passes_meet_the_f32_tolerance_and_one_does_not():
    """Why three passes: rna_tf32 emulated on the f32 words, at D = 8192 on
    inputs at the Q heads' scale, the products a_hi·b_hi + a_lo·b_hi +
    a_hi·b_lo (exact in f64) give (lse, entropy, logprob) within the f32
    mode's 1e-4 · max(1, |ref|) of the f64 reference; one pass (a_hi·b_hi)
    does not."""
    x, w, ref = _q_head_scores(512, seed=0)
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w)
    xh, xl, wh, wl = (t.astype(np.float64) for t in (xh, xl, wh, wl))
    r = _outputs(ref)
    three = _scaled_err(_outputs(xh @ wh + xl @ wh + xh @ wl), r)
    one = _scaled_err(_outputs(xh @ wh), r)
    assert three < 0.01 * F32_REL < F32_REL < one, (three, one)


def _rz_f32(v64):
    """f64 values rounded to f32 toward zero."""
    r = v64.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v64)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def test_promotion_groups_bound_the_truncating_accumulation():
    """Why promotion groups: modelling the tensor core's accumulator as
    adding each k-step's 8 products (exact) and rounding toward zero to f32,
    three passes summed over the whole D = 8192 in one accumulator miss the
    1e-4 tolerance; a group accumulator of TG_GROUP chunks added into an f32
    accumulator that rounds to nearest meets it with 20x to spare."""
    x, w, ref = _q_head_scores(512, seed=0)
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w)
    xh, xl, wh, wl = (t.astype(np.float64) for t in (xh, xl, wh, wl))

    def accumulate(steps_per_group):
        acc = np.zeros(ref.shape, dtype=np.float32)
        part = np.zeros(ref.shape, dtype=np.float32)
        for k in range(0, 8192, 8):
            if (k // 8) % steps_per_group == 0:
                acc = (acc.astype(np.float64) + part).astype(np.float32)
                part[:] = 0
            sl = slice(k, k + 8)
            for a, b in ((xh, wh), (xl, wh), (xh, wl)):
                part = _rz_f32(part.astype(np.float64) + a[:, sl] @ b[sl])
        return (acc.astype(np.float64) + part).astype(np.float32)

    r = _outputs(ref)
    whole = _scaled_err(_outputs(accumulate(8192 // 8)), r)
    grouped = _scaled_err(_outputs(accumulate(GROUP * TBK // 8)), r)
    assert grouped < 0.05 * F32_REL < F32_REL < whole, (grouped, whole)


def _splits(rows, V, sms):
    return flp.split_count(rows, V, flp._F32_CTAS_PER_SM * sms, flp._F32_BM, flp._F32_BN)


def forward_walk(x, w, y, b, tied, sms):
    """(logprob, lse, entropy) [N] as the f32 forward kernel pair computes
    them."""
    N, D = x.shape
    V = w.shape[0] if tied else w.shape[1]
    n_rt, n_vt = -(-N // TBM), -(-V // TBN)
    S = _splits(N, V, sms)
    tps = -(-n_vt // S)
    assert all(sp * tps < n_vt for sp in range(S)), "an empty split"
    part = np.zeros((4, S, N), dtype=np.float32)
    for rt in range(n_rt):
        rows = np.arange(rt * TBM, (rt + 1) * TBM)
        yr = np.where(rows < N, np.concatenate([y, np.full(n_rt * TBM - N, -1)])[rows], -1)
        for sp in range(S):
            m = np.full(TBM, M_INIT, dtype=np.float32)
            l, r, lab = (np.zeros(TBM, dtype=np.float32) for _ in range(3))
            for vt in range(sp * tps, min(sp * tps + tps, n_vt)):
                col = np.arange(vt * TBN, (vt + 1) * TBN)
                valid = col < V
                s = tg_tile(x, w, tied, rt * TBM, vt * TBN, D)
                if b is not None:
                    s = s + np.where(valid, np.concatenate([b, np.zeros(n_vt * TBN - V, np.float32)])[col], 0)
                lab = lab + np.where(valid & (col[None] == yr[:, None]), s, 0).sum(1)
                s = np.where(valid, s, MASK_VAL).astype(np.float32)
                mn = np.maximum(m, s.max(1))
                p = np.where(valid, np.exp(s - mn[:, None]), 0)
                al = np.exp(m - mn)
                l, r, m = al * l + p.sum(1), al * r + (p * s).sum(1), mn
            keep = rows < N
            for i, v in enumerate((m, l, r, lab)):
                part[i, sp, rows[keep]] = v[keep]
    M = part[0].max(0)
    wgt = np.exp(part[0] - M)
    L, R, lab = (wgt * part[1]).sum(0), (wgt * part[2]).sum(0), part[3].sum(0)
    ls = np.maximum(L, 1e-30)
    lse = M + np.log(ls)
    return lab - lse, lse, lse - R / ls


def backward_walk(x, w, b, y, lse, ent, dlp, dlse, dent, tied, sms, chunk):
    """(dx, dW, db) as the f32 ds, dx and dW kernels compute them."""
    N, D = x.shape
    V = w.shape[0] if tied else w.shape[1]
    ldv = -(-V // flp._DS_LD) * flp._DS_LD
    n_vt = -(-V // TBN)
    C = min(chunk, -(-N // TBM) * TBM)
    ds_all = np.full((-(-N // TBM) * TBM, ldv), np.nan, dtype=np.float32)
    dbpart = np.zeros((-(-N // TBM), V), dtype=np.float32)
    dx = np.zeros((N, D), dtype=np.float32)
    bp = None if b is None else np.concatenate([b, np.zeros(n_vt * TBN - V, np.float32)])
    for c0 in range(0, N, C):
        rows = min(C, N - c0)
        n_rt = -(-rows // TBM)
        S = _splits(rows, V, sms)
        tps = -(-n_vt // S)
        xc = x[c0:c0 + rows]
        for rt in range(n_rt):
            rr = np.arange(rt * TBM, (rt + 1) * TBM)
            inr = rr < rows
            gr = np.minimum(c0 + rr, N - 1)  # the rows' global index (masked where out)
            for sp in range(S):
                for vt in range(sp * tps, min(sp * tps + tps, n_vt)):
                    col = np.arange(vt * TBN, (vt + 1) * TBN)
                    ok = (col < V)[None] & inr[:, None]
                    s = tg_tile(xc, w, tied, rt * TBM, vt * TBN, D)
                    if bp is not None:
                        s = s + np.where(col < V, bp[col], 0)
                    lse_r, e_r = lse[gr][:, None], (lse[gr] - ent[gr])[:, None]
                    p = np.exp(s - lse_r)
                    hit = (col[None] == y[gr][:, None]).astype(np.float32)
                    dsv = dlp[gr][:, None] * (hit - p) + dlse[gr][:, None] * p - dent[gr][:, None] * p * (s - e_r)
                    dsv = np.where(ok, dsv, 0).astype(np.float32)
                    ds_all[c0 + rt * TBM:c0 + (rt + 1) * TBM, col] = dsv
                    # db partials: each warp's 16 rows, then the 8 warps in order.
                    warps = dsv.reshape(8, 16, TBN).sum(1)
                    cs = warps.sum(0)
                    keep = col < V
                    if bp is not None:
                        dbpart[c0 // TBM + rt, col[keep]] = cs[keep]
        # dx over 128 x 128 tiles of [rows, D], the vocabulary in TBK chunks.
        ds_c = ds_all[c0:c0 + rows, :V]
        for rt in range(n_rt):
            for dt in range(-(-D // TBN)):
                acc = tg_tile(ds_c, w, not tied, rt * TBM, dt * TBN, V)
                r1, c1 = min(TBM, rows - rt * TBM), min(TBN, D - dt * TBN)
                dx[c0 + rt * TBM:c0 + rt * TBM + r1, dt * TBN:dt * TBN + c1] = acc[:r1, :c1]
    assert not np.isnan(ds_all).any(), "a ds element of a row tile was never written"
    # dW: C = xᵀ·ds over the rows, A the transposed scratch (exact), B = ds
    # MN-major; the persistent walk's tiles stored by the epilogue (tied: Cᵀ).
    xt = np.ascontiguousarray(x.T)
    dw = np.zeros(D * V, dtype=np.float32)
    written = np.zeros(D * V, dtype=np.int32)
    for mt, nt in (mn for cta in dw_walk(-(-D // TBM), -(-V // TBN), sms) for mn in cta):
        acc = tg_tile(xt, ds_all[:N, :V], False, mt * TBM, nt * TBN, N)
        r, c, off, _ = dw_stores(mt, nt, D, V, tied)
        dw[off] = acc[r, c]
        np.add.at(written, off, 1)
    assert (written == 1).all(), "a dW element written twice or never"
    dw = dw.reshape((V, D) if tied else (D, V))
    db = None if b is None else dbpart.sum(0)
    return dx, dw, db


def _inputs(N, D, V, tied, bias, seed):
    """Seeded f32 inputs, x a ReLU hidden as the Q heads see, logits spread
    as a trained head's."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(N, D)), 0).astype(np.float32)
    w = (rng.normal(size=(V, D) if tied else (D, V)) * 3.5 * D ** -0.5).astype(np.float32)
    y = rng.integers(0, V, size=(N,)).astype(np.int32)
    b = (rng.normal(size=(V,)) * 0.1).astype(np.float32) if bias else None
    cts = [rng.normal(size=(N,)).astype(np.float32) for _ in range(3)]
    return x, w, y, b, cts


# (N, D, V, sms): row tails (N not a multiple of 128), vocabulary tails (V
# not a multiple of 128, of 4), several splits or one, and a chunk boundary
# (the backward walked in chunks of 128 rows).
CASES = [(50, 64, 1000, 132), (300, 64, 1027, 132), (130, 96, 2049, 4)]


@pytest.mark.parametrize("tied,bias", [(False, True), (False, False), (True, True)],
                         ids=["untied-bias", "untied", "tied-bias"])
@pytest.mark.parametrize("N,D,V,sms", CASES, ids=[f"N{c[0]}-D{c[1]}-V{c[2]}-sm{c[3]}" for c in CASES])
def test_f32_walk_matches_pallas_and_plain(N, D, V, sms, tied, bias):
    """The f32 walk's (logprob, lse, entropy) and (dx, dW, db) against the
    Pallas kernels' forward and VJP (interpret mode) on f32 inputs and
    against the port's plain versions, within 1e-4."""
    x, w, y, b, cts = _inputs(N, D, V, tied, bias, seed=N + V + D)
    got = forward_walk(x, w, y, b, tied, sms)

    def f(x_, w_, *b_):
        return jax_fused_logprob(x_, w_, jnp.asarray(y), b_[0] if b_ else None, tied=tied, interpret=True)

    args = [jnp.asarray(x), jnp.asarray(w)] + ([jnp.asarray(b)] if bias else [])
    ref, vjp = jax.vjp(f, *args)
    rgrads = vjp(tuple(jnp.asarray(c) for c in cts))
    tx, tw, ty = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y)
    tb = None if b is None else torch.from_numpy(b)
    plain = flp.naive_logprob(tx, tw, ty, tb, tied=tied)
    for name, g, r, p in zip(("logprob", "lse", "entropy"), got, ref, plain):
        np.testing.assert_allclose(g, np.asarray(r), **TOL, err_msg=name)
        np.testing.assert_allclose(g, p.numpy(), **TOL, err_msg=name)
    lse, ent = got[1].astype(np.float32), got[2].astype(np.float32)
    grads = backward_walk(x, w, b, y, lse, ent, *cts, tied, sms, chunk=TBM)
    pgrads = flp.fused_logprob_bwd_plain(tx, tw, tb, ty, torch.from_numpy(lse), torch.from_numpy(ent),
                                         *(torch.from_numpy(c) for c in cts), tied=tied)
    assert (grads[2] is None) == (not bias)
    for name, g, r, p in zip(("dx", "dW", "db"), grads, rgrads, pgrads):
        if g is None:
            continue
        np.testing.assert_allclose(g, np.asarray(r), **TOL, err_msg=name)
        np.testing.assert_allclose(g, p.numpy(), **TOL, err_msg=name)


def test_f32_split_count_fills_two_ctas_an_sm():
    """At the Q heads' shape (N = 4092, V = 50400) on 132 SMs the f32
    forward grid holds about ``_F32_CTAS_PER_SM`` CTAs an SM (one: a CTA of
    the 3xTF32 kernels holds 200 KB of shared memory; the test's name dates
    from the SIMT kernels' two), every split non-empty; the ds grid of a
    1024-row chunk likewise."""
    assert flp._F32_CTAS_PER_SM == 1
    for N in (4092, flp.BWD_CHUNK_ROWS):
        V, sms = 50400, 132
        S = _splits(N, V, sms)
        n_rt, n_vt = -(-N // TBM), -(-V // TBN)
        tps = -(-n_vt // S)
        assert all(sp * tps < n_vt for sp in range(S))
        slots = flp._F32_CTAS_PER_SM * sms
        assert n_rt * S <= slots and n_rt * (S + 1) > slots


def test_f32_weight_gets_a_tma_ready_copy_only_when_needed():
    """``kernel_weight(w, torch.float32)``: a weight whose rows start on
    16-byte boundaries (V = 50400, the Q heads) is returned as it is; one
    whose rows do not (V = 4097, 50257; a column-strided view) comes back
    as a view of a fresh buffer with rows padded to a multiple of 4 floats,
    equal values, and the copy counted."""
    w = torch.randn(8, 50400)
    before = flp.kernel_weight.copies
    assert flp.kernel_weight(w, torch.float32) is w
    assert flp.kernel_weight.copies == before
    for t in (torch.randn(8, 4097), torch.randn(8, 50257), torch.randn(64, 8).t()):
        wk = flp.kernel_weight(t, torch.float32)
        assert wk.dtype == torch.float32 and wk.stride(-1) == 1 and wk.stride(0) % 4 == 0
        assert wk.data_ptr() % 16 == 0 and flp._tma_ready(wk, torch.float32)
        assert torch.equal(wk, t) and wk.data_ptr() != t.data_ptr()
    assert flp.kernel_weight.copies == before + 3
    # The bf16 mode's rule is unchanged: rows of 16 bytes are 8 elements.
    assert flp.kernel_weight(torch.randn(8, 64).to(torch.bfloat16)).stride(0) == 64
    assert flp.kernel_weight(torch.randn(8, 60)).stride(0) == 64
