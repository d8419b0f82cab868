"""The walk of the fused-logprob kernels' f32 mode (``csrc/fused_logprob.cu``
``logprob_fwd_f32_kernel``, ``csrc/fused_logprob_bwd.cu``
``logprob_ds_f32_kernel`` / ``logprob_dx_f32_kernel`` /
``logprob_dw_f32_kernel``, on the SIMT mainloop of ``csrc/sgemm_f32.cuh``)
on the CPU: a plain model, written here, of the thread-level index maps and
of the tiles each kernel visits, held against the plain versions and the
JAX package's Pallas kernels (interpret mode) on f32 inputs. The tile sizes
and the operand forms are read from the sources; the V split is the
wrapper's own.

- The mainloop: thread (ty, tx) = (tid / 16, tid % 16) of 256 fetches two
  float4 of each 128 x 16 operand tile (K-major: row f / 4, reduction
  4 (f % 4); MN-major: reduction row f / 32, columns 4 (f % 32)), zeros past
  the edges, and stores them into a [k][m] stage of row pitch SG_LD; it owns
  the outputs at rows sg_row(ty, 0..7) and columns sg_col(tx, 0..7), read as
  float4 at 4 ty, 64 + 4 ty (A) and 4 tx, 64 + 4 tx (B).
- Forward: one CTA per (128-row tile, V split); a split walks its 128-column
  tiles; per tile and row the max over the half-warp's 16 threads x 8
  columns, then the online (m, l, r, label score); the merge kernel of the
  bf16 mode combines the splits.
- Backward: per chunk of BWD_CHUNK_ROWS rows, ds in f32 into [C, ldv] (zero
  past V and past the chunk's rows) with the db column partials of each row
  tile (each thread's 8 rows, then the 16 row groups in order), dx = ds·Wᵀ
  (ds·W tied) over 128 x 128 tiles, then dW = xᵀ·ds (dsᵀ·x tied) once over
  every row, both operands MN-major, each element stored once.
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


def _source(name):
    with open(os.path.join(cuda_lib._CSRC, name)) as f:
        return f.read()


def _constants():
    src = _source("sgemm_f32.cuh")
    out = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
           for n in ("SG_BM", "SG_BN", "SG_BK", "SG_THREADS")}
    out["SG_LD"] = out["SG_BM"] + int(re.search(r"constexpr int SG_LD = SG_BM \+ (\d+);", src).group(1))
    return out


K = _constants()
BM, BN, BK, THREADS, LD = K["SG_BM"], K["SG_BN"], K["SG_BK"], K["SG_THREADS"], K["SG_LD"]


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


def test_index_maps_cover_each_tile_once():
    """Every element of a 128 x 16 operand tile is fetched once and lands at
    its [k][m] place in the stage, for both operand forms; the pad columns
    are never written; each thread's outputs are distinct and the 256
    threads cover the 128 x 128 tile once; the threads' float4 reads of the
    stage are the rows and columns the outputs name."""
    assert (BM, BN, BK, THREADS) == (128, 128, 16, 256) and LD > BM
    assert (flp._F32_BM, flp._F32_BN) == (BM, BN)
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
    # The 16 threads that hold the same rows are one half of one warp, closed
    # under the xor shuffles (1, 2, 4, 8) of the row reductions.
    for ty in range(16):
        tids = [ty * 16 + tx for tx in range(16)]
        assert len({t // 32 for t in tids}) == 1
        lanes = {t % 32 for t in tids}
        assert all(lane ^ o in lanes for lane in lanes for o in (1, 2, 4, 8))


def test_operand_forms_of_the_sources():
    """The kernels instantiate the mainloop with the operand forms the model
    uses: x K-major and W K-major only when tied (forward, ds); ds K-major
    and W K-major only when untied (dx); both MN-major (dW)."""
    fwd, bwd = _source("fused_logprob.cu"), _source("fused_logprob_bwd.cu")
    assert "sgemm_tile<true, TIED>(sm, x, w, m0, v0, p.D, acc);" in fwd
    assert "sgemm_tile<true, TIED>(sm, x, w, m0, v0, p.D, acc);" in bwd
    assert "sgemm_tile<true, !TIED>(sm, ds, w, m0, n0, p.V, acc);" in bwd
    assert "sgemm_tile<false, false>(sm, a, b, m0, n0, K, acc);" in bwd
    # The wrapper sizes the forward and ds grids for the kernels' occupancy.
    bounds = re.findall(r"__launch_bounds__\(SG_THREADS, (\d+)\)", fwd + bwd)
    assert len(bounds) == 4 and set(bounds) == {str(flp._F32_CTAS_PER_SM)}


def _splits(rows, V, sms):
    return flp.split_count(rows, V, flp._F32_CTAS_PER_SM * sms, flp._F32_BM, flp._F32_BN)


def forward_walk(x, w, y, b, tied, sms):
    """(logprob, lse, entropy) [N] as the f32 forward kernel pair computes
    them."""
    N, D = x.shape
    V = w.shape[0] if tied else w.shape[1]
    n_rt, n_vt = -(-N // BM), -(-V // BN)
    S = _splits(N, V, sms)
    tps = -(-n_vt // S)
    assert all(sp * tps < n_vt for sp in range(S)), "an empty split"
    part = np.zeros((4, S, N), dtype=np.float32)
    for rt in range(n_rt):
        rows = np.arange(rt * BM, (rt + 1) * BM)
        yr = np.where(rows < N, np.concatenate([y, np.full(n_rt * BM - N, -1)])[rows], -1)
        for sp in range(S):
            m = np.full(BM, M_INIT, dtype=np.float32)
            l, r, lab = (np.zeros(BM, dtype=np.float32) for _ in range(3))
            for vt in range(sp * tps, min(sp * tps + tps, n_vt)):
                col = np.arange(vt * BN, (vt + 1) * BN)
                valid = col < V
                s = sgemm_tile(x, w, True, tied, rt * BM, vt * BN, D)
                if b is not None:
                    s = s + np.where(valid, np.concatenate([b, np.zeros(n_vt * BN - V, np.float32)])[col], 0)
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
    n_vt = -(-V // BN)
    C = min(chunk, -(-N // BM) * BM)
    ds_all = np.full((-(-N // BM) * BM, ldv), np.nan, dtype=np.float32)
    dbpart = np.zeros((-(-N // BM), V), dtype=np.float32)
    dx = np.zeros((N, D), dtype=np.float32)
    bp = None if b is None else np.concatenate([b, np.zeros(n_vt * BN - V, np.float32)])
    for c0 in range(0, N, C):
        rows = min(C, N - c0)
        n_rt = -(-rows // BM)
        S = _splits(rows, V, sms)
        tps = -(-n_vt // S)
        xc = x[c0:c0 + rows]
        for rt in range(n_rt):
            rr = np.arange(rt * BM, (rt + 1) * BM)
            inr = rr < rows
            gr = np.minimum(c0 + rr, N - 1)  # the rows' global index (masked where out)
            for sp in range(S):
                for vt in range(sp * tps, min(sp * tps + tps, n_vt)):
                    col = np.arange(vt * BN, (vt + 1) * BN)
                    ok = (col < V)[None] & inr[:, None]
                    s = sgemm_tile(xc, w, True, tied, rt * BM, vt * BN, D)
                    if bp is not None:
                        s = s + np.where(col < V, bp[col], 0)
                    lse_r, e_r = lse[gr][:, None], (lse[gr] - ent[gr])[:, None]
                    p = np.exp(s - lse_r)
                    hit = (col[None] == y[gr][:, None]).astype(np.float32)
                    dsv = dlp[gr][:, None] * (hit - p) + dlse[gr][:, None] * p - dent[gr][:, None] * p * (s - e_r)
                    dsv = np.where(ok, dsv, 0).astype(np.float32)
                    ds_all[c0 + rt * BM:c0 + (rt + 1) * BM, col] = dsv
                    # db partials: each thread's 8 rows, then the 16 row groups.
                    groups = np.stack([dsv[[sg_row(ty, i) for i in range(8)]].sum(0) for ty in range(16)])
                    cs = groups.sum(0)
                    keep = col < V
                    if bp is not None:
                        dbpart[c0 // BM + rt, col[keep]] = cs[keep]
        # dx over 128 x 128 tiles of [rows, D], the vocabulary in BK chunks.
        ds_c = ds_all[c0:c0 + rows, :V]
        for rt in range(n_rt):
            for dt in range(-(-D // BN)):
                acc = sgemm_tile(ds_c, w, True, not tied, rt * BM, dt * BN, V)
                r1, c1 = min(BM, rows - rt * BM), min(BN, D - dt * BN)
                dx[c0 + rt * BM:c0 + rt * BM + r1, dt * BN:dt * BN + c1] = acc[:r1, :c1]
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
    forward grid holds about two CTAs an SM, every split non-empty."""
    N, V, sms = 4092, 50400, 132
    S = _splits(N, V, sms)
    n_rt, n_vt = -(-N // BM), -(-V // BN)
    tps = -(-n_vt // S)
    assert all(sp * tps < n_vt for sp in range(S))
    assert n_rt * S <= 2 * sms and n_rt * (S + 1) > 2 * sms
