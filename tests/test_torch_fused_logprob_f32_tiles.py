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
- The dW kernel (``logprob_dw_f32_kernel``, row 6f) runs on the SIMT
  mainloop of ``csrc/sgemm_f32.cuh``: thread (ty, tx) = (tid / 16, tid % 16)
  of 256 fetches two float4 of each 128 x 16 operand tile (K-major: row
  f / 4, reduction 4 (f % 4); MN-major: reduction row f / 32, columns
  4 (f % 32)), zeros past the edges, and stores them into a [k][m] stage of
  row pitch SG_LD; it owns the outputs at rows sg_row(ty, 0..7) and columns
  sg_col(tx, 0..7).
- Forward: one CTA per (128-row tile, V split); a split walks its 128-column
  tiles; per tile and row the max over the quad that holds the row, then the
  online (m, l, r, label score); the merge kernel of the bf16 mode combines
  the splits.
- Backward: per chunk of BWD_CHUNK_ROWS rows, ds in f32 into [C, ldv] (zero
  past V and past the chunk's rows) with the db column partials of each row
  tile (each warp's 16 rows, then the 8 warps in order), dx = ds·Wᵀ (ds·W
  tied) over 128 x 128 tiles, then dW = xᵀ·ds (dsᵀ·x tied) once over every
  row, both operands MN-major, each element stored once.
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


def _constants():
    src = _source("sgemm_f32.cuh")
    out = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
           for n in ("SG_BM", "SG_BN", "SG_BK", "SG_THREADS")}
    out["SG_LD"] = out["SG_BM"] + int(re.search(r"constexpr int SG_LD = SG_BM \+ (\d+);", src).group(1))
    tg = _source("logprob_gemm_tf32.cuh")
    out.update({n: int(re.search(rf"constexpr int {n} = (\d+);", tg).group(1))
                for n in ("TG_BM", "TG_BN", "TG_BK", "TG_STAGES", "TG_SPLITS", "TG_GROUP", "TG_THREADS")})
    return out


K = _constants()
BM, BN, BK, THREADS, LD = K["SG_BM"], K["SG_BN"], K["SG_BK"], K["SG_THREADS"], K["SG_LD"]
TBM, TBN, TBK, GROUP = K["TG_BM"], K["TG_BN"], K["TG_BK"], K["TG_GROUP"]
MN_BOX = 32 * TBK * 4  # bytes of one MN-major box of B: 32 columns x TBK reduction rows


def sg_row(ty, i):
    return (4 * ty if i < 4 else 64 + 4 * ty) + (i & 3)


def sg_col(tx, j):
    return (4 * tx if j < 4 else 64 + 4 * tx) + (j & 3)


def _fetch_map(kmajor: bool):
    """For each of the 2048 elements a block fetches: (row, col) in the
    operand's stored matrix relative to (mn0, k0) for K-major or (k0, mn0)
    for MN-major, and its shared-memory offset in the [k][m] stage."""
    rows, cols, offs = [], [], []
    for tid in range(THREADS):
        for h in range(2):
            f = tid + h * THREADS
            for e in range(4):
                if kmajor:
                    mn, k = f // 4, 4 * (f % 4)
                    rows.append(mn), cols.append(k + e), offs.append((k + e) * LD + mn)
                else:
                    rows.append(f // 32), cols.append(4 * (f % 32) + e), offs.append((f // 32) * LD + 4 * (f % 32) + e)
    return np.asarray(rows), np.asarray(cols), np.asarray(offs)


MAPS = {True: _fetch_map(True), False: _fetch_map(False)}


def stage(a: np.ndarray, kmajor: bool, mn0: int, k0: int) -> np.ndarray:
    """The [BK, LD] shared-memory stage the block builds from operand ``a``
    (stored [mn][k] when K-major, [k][mn] otherwise), zeros past its edges;
    unwritten (pad) entries are NaN."""
    r, c, off = MAPS[kmajor]
    r0, c0 = (mn0, k0) if kmajor else (k0, mn0)
    rr, cc = r + r0, c + c0
    ok = (rr < a.shape[0]) & (cc < a.shape[1])
    vals = np.zeros(len(r), dtype=np.float32)
    vals[ok] = a[rr[ok], cc[ok]]
    s = np.full(BK * LD, np.nan, dtype=np.float32)
    s[off] = vals
    return s.reshape(BK, LD)


def sgemm_tile(a, b, a_kmajor, b_kmajor, m0, n0, Kred):
    """The 128 x 128 f32 tile of A·B over [0, Kred) in BK chunks, read from
    the stages as the threads read them: output (sg_row(ty, i), sg_col(tx,
    j)) from stage columns 4 ty + i (i < 4) or 64 + 4 ty + i - 4."""
    acc = np.zeros((BM, BN), dtype=np.float32)
    for k0 in range(0, Kred, BK):
        sa, sb = stage(a, a_kmajor, m0, k0), stage(b, b_kmajor, n0, k0)
        acc += sa[:, :BM].T @ sb[:, :BN]
    return acc


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


def test_index_maps_cover_each_tile_once():
    """Row 6f's SIMT mainloop: every element of a 128 x 16 operand tile is
    fetched once and lands at its [k][m] place in the stage, for both
    operand forms; the pad columns are never written; each thread's outputs
    are distinct and the 256 threads cover the 128 x 128 tile once; the
    threads' float4 reads of the stage are the rows and columns the outputs
    name."""
    assert (BM, BN, BK, THREADS) == (128, 128, 16, 256) and LD > BM
    rng = np.random.default_rng(0)
    for kmajor in (True, False):
        r, c, off = MAPS[kmajor]
        assert len(set(off.tolist())) == BM * BK
        a = rng.normal(size=(BM, BK) if kmajor else (BK, BM)).astype(np.float32)
        s = stage(a, kmajor, 0, 0)
        assert np.isnan(s[:, BM:]).all()
        np.testing.assert_array_equal(s[:, :BM], a.T if kmajor else a)
    cover = np.zeros((BM, BN), dtype=np.int32)
    for tid in range(THREADS):
        ty, tx = tid // 16, tid % 16
        for i in range(8):
            assert sg_row(ty, i) == (4 * ty + i if i < 4 else 64 + 4 * ty + i - 4)
            for j in range(8):
                assert sg_col(tx, j) == (4 * tx + j if j < 4 else 64 + 4 * tx + j - 4)
                cover[sg_row(ty, i), sg_col(tx, j)] += 1
    assert (cover == 1).all()


def test_operand_forms_of_the_sources():
    """The kernels instantiate the mainloops with the operand forms the
    model uses: x K-major with W K-major only when tied (forward, ds); ds
    K-major with W K-major only when untied (dx); on the 3xTF32 mainloop,
    whose producer loads the same forms; both MN-major on the SIMT one (dW,
    row 6f). The wrapper sizes the forward and ds grids for the kernels'
    occupancy."""
    fwd, bwd = _source("fused_logprob.cu"), _source("fused_logprob_bwd.cu")
    assert "tg_produce<TIED>(ring, &tx, &tw, m0, vt_lo, vt_hi, nk);" in fwd
    assert "tg_tile<TIED>(ring, acc, cw, ct, nk, it);" in fwd
    assert "tg_produce<TIED>(ring, &tx, &tw, m0, vt_lo, vt_hi, nk);" in bwd
    assert "tg_tile<TIED>(ring, acc, cw, tid, nk, it);" in bwd
    assert "tg_produce<!TIED>(ring, &tds, &tw, m0, dt, dt + 1, nk);" in bwd
    assert "tg_tile<!TIED>(ring, acc, cw, tid, nk, it);" in bwd
    assert "sgemm_tile<false, false>(sm, a, b, m0, n0, K, acc);" in bwd
    assert "sgemm_tile<" not in fwd
    # Three kernels on the 3xTF32 mainloop, one CTA an SM; the dW kernel two.
    tg = re.findall(r"__launch_bounds__\(TG_THREADS, (\d+)\)", fwd + bwd)
    assert len(tg) == 3 and set(tg) == {str(flp._F32_CTAS_PER_SM)}
    assert re.findall(r"__launch_bounds__\(SG_THREADS, (\d+)\)", fwd + bwd) == ["2"]
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
    a, bm = (ds_all[:N, :V], x) if tied else (x, ds_all[:N, :V])
    m_valid, n_valid = (V, D) if tied else (D, V)
    dw = np.zeros((m_valid, n_valid), dtype=np.float32)
    written = np.zeros((m_valid, n_valid), dtype=np.int32)
    for mt in range(-(-m_valid // BM)):
        for nt in range(-(-n_valid // BN)):
            acc = sgemm_tile(a, bm, False, False, mt * BM, nt * BN, N)
            r1, c1 = min(BM, m_valid - mt * BM), min(BN, n_valid - nt * BN)
            dw[mt * BM:mt * BM + r1, nt * BN:nt * BN + c1] = acc[:r1, :c1]
            written[mt * BM:mt * BM + r1, nt * BN:nt * BN + c1] += 1
    assert (written == 1).all(), "a dW element written twice or never"
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
    grads = backward_walk(x, w, b, y, lse, ent, *cts, tied, sms, chunk=BM)
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
