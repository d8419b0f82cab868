"""The walk of the fused-logprob kernels (``csrc/fused_logprob.cu``,
``csrc/fused_logprob_bwd.cu``, on the mainloop of ``csrc/logprob_gemm.cuh``)
on the CPU: a plain model, written here, of which tiles each kernel visits
and what it computes on them, held against the JAX package's Pallas forward
and VJP run in interpret mode, on the same numpy inputs. The tile sizes are
read from the kernels' sources; the V split is the wrapper's own
``split_count``.

- Forward: one CTA per (GEMM_BM = 128-row tile, V split); a split walks
  ceil(n_vt / S) tiles of GEMM_BN = 256 columns, each summed over D in
  GEMM_BK = 64 chunks, and keeps the online (m, l, r, label score) per row;
  a second kernel merges the splits of each row in split order.
- ds: the same walk over a chunk of rows; per tile it writes ds, rounded to
  the activation dtype, into the [C, ldv] scratch (zero past V and for rows
  past the chunk's; nothing past ldv) and the tile's column sums of the f32
  ds into the db partials [row tile, V].
- dx: one CTA per 128 x 256 tile of dx [rows, D], summed over the
  vocabulary in 64-wide chunks of ds and W.
- dW: after the last chunk, once over ds of every row: a
  persistent grid of min(tiles, SMs) CTAs, CTA c taking output tiles c,
  c + grid, ... of 128 x 256, ordered ds panel slowest (untied: dW = xᵀ·ds,
  the 128-row tile of D fastest; tied: dW = dsᵀ·x, the 256-column tile of D
  fastest); each tile sums over the rows in GEMM_BK = 64 chunks of two
  64-wide MN-major A boxes and four 64-wide MN-major B boxes, and is stored
  once, nothing past D or V. db sums the partials of every row tile in
  order.

Every load is modelled as TMA makes it: rows past N, columns past V and
reductions past D or V read as zeros (the tensors are zero-padded to whole
tiles before the walk).
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
# float32 on both sides: what differs is the summation order.
TOL = dict(rtol=2e-4, atol=2e-4)


def _constants():
    """The tile constants of the kernels' sources."""
    out = {}
    for name, fname in (("GEMM_BM", "logprob_gemm.cuh"), ("GEMM_BN", "logprob_gemm.cuh"),
                        ("GEMM_BK", "logprob_gemm.cuh"), ("DS_LD", "fused_logprob_bwd.cu")):
        with open(os.path.join(cuda_lib._CSRC, fname)) as f:
            out[name] = int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))
    return out


K = _constants()
BM, BN, BK = K["GEMM_BM"], K["GEMM_BN"], K["GEMM_BK"]


def test_wrapper_constants_match_the_kernels():
    assert (flp._KERNEL_BM, flp._KERNEL_BN, flp._KERNEL_BK, flp._DS_LD) == (BM, BN, BK, K["DS_LD"])


def _pad(t, rows, cols):
    """t zero-padded to [rows, cols]: TMA's fill past the edges."""
    out = torch.zeros((rows, cols), dtype=t.dtype)
    out[: t.shape[0], : t.shape[1]] = t
    return out


def _ceil(a, b):
    return -(-a // b) * b


def _w_dv(w, tied):
    """W as [D, V], whichever way it is stored."""
    return w.t() if tied else w


def _tile_scores(xp, wdv, rt, vt, D):
    """A 128 x 256 score tile, summed over D in BK chunks (f32)."""
    xs = xp[rt * BM:(rt + 1) * BM]
    ws = wdv[:, vt * BN:(vt + 1) * BN]
    s = torch.zeros((BM, BN), dtype=torch.float32)
    for k0 in range(0, D, BK):
        s += xs[:, k0:k0 + BK].float() @ ws[k0:k0 + BK].float()
    return s


def forward_walk(x, w, y, b, tied, sms):
    """(logprob, lse, entropy) [N] as the forward kernel pair computes them."""
    N, D = x.shape
    V = w.shape[0] if tied else w.shape[1]
    n_rt, n_vt = -(-N // BM), -(-V // BN)
    S = flp.split_count(N, V, sms)
    tps = -(-n_vt // S)
    assert all(sp * tps < n_vt for sp in range(S)), "an empty split"
    xp = _pad(x, n_rt * BM, D)
    wdv = _pad(_w_dv(w, tied), D, n_vt * BN)
    bp = None if b is None else _pad(b[None], 1, n_vt * BN)[0]
    part = torch.zeros((4, S, N))
    for rt in range(n_rt):
        rows = torch.arange(rt * BM, (rt + 1) * BM)
        yr = torch.where(rows < N, torch.as_tensor(_pad(y[None], 1, n_rt * BM)[0])[rows], -1)
        for sp in range(S):
            m = torch.full((BM,), M_INIT)
            l, r, lab = torch.zeros(BM), torch.zeros(BM), torch.zeros(BM)
            for vt in range(sp * tps, min(sp * tps + tps, n_vt)):
                col = torch.arange(vt * BN, (vt + 1) * BN)
                valid = col < V
                s = _tile_scores(xp, wdv, rt, vt, D)
                if bp is not None:
                    s = s + torch.where(valid, bp[col], 0.0)
                lab = lab + torch.where(valid & (col[None] == yr[:, None]), s, 0.0).sum(1)
                s = torch.where(valid, s, MASK_VAL)
                mn = torch.maximum(m, s.max(1).values)
                al = torch.exp(m - mn)
                p = torch.where(valid, torch.exp(s - mn[:, None]), 0.0)
                l = al * l + p.sum(1)
                r = al * r + (p * s).sum(1)
                m = mn
            keep = rows < N
            for i, v in enumerate((m, l, r, lab)):
                part[i, sp, rows[keep]] = v[keep]
    # The merge kernel: splits in order.
    M = part[0].max(0).values
    wgt = torch.exp(part[0] - M)
    L, R, lab = (wgt * part[1]).sum(0), (wgt * part[2]).sum(0), part[3].sum(0)
    ls = torch.clamp(L, min=1e-30)
    lse = M + torch.log(ls)
    return lab - lse, lse, lse - R / ls


def dw_order(m_valid, n_valid, tied):
    """The dW kernel's output tiles (m tile, n tile) in walk order: the ds
    panel slowest (untied: ds is B, the 128-row tile of D fastest; tied: ds
    is A, the 256-column tile of D fastest)."""
    m_tiles, n_tiles = -(-m_valid // BM), -(-n_valid // BN)
    if tied:
        return [(t // n_tiles, t % n_tiles) for t in range(m_tiles * n_tiles)]
    return [(t % m_tiles, t // m_tiles) for t in range(m_tiles * n_tiles)]


def dw_walk(x, ds, rows, V, tied, sms):
    """dW as the dW kernel computes it from ``rows`` rows of x [rows, D] and
    of the bf16-valued ds [>= rows, ldv] (zero past V): [D, V] untied,
    [V, D] tied, CTA c of the persistent grid taking tiles c, c + grid, ...
    of ``dw_order``. Each output element is written by exactly one tile."""
    D = x.shape[1]
    ldv = ds.shape[1]
    a_src, b_src = (ds, x) if tied else (x, ds)  # both [rows, output dim], output dim contiguous
    m_valid, n_valid = (V, D) if tied else (D, V)
    m_tiles, n_tiles = -(-m_valid // BM), -(-n_valid // BN)
    nk = -(-rows // BK)
    # TMA's fills: zero past the rows and past each map's inner extent.
    ap = _pad(a_src[:rows].float(), nk * BK, m_tiles * BM)
    bp = _pad(b_src[:rows].float(), nk * BK, n_tiles * BN)
    out = torch.zeros((m_valid, n_valid))
    written = torch.zeros((m_valid, n_valid), dtype=torch.int32)
    order = dw_order(m_valid, n_valid, tied)
    grid = min(len(order), sms)
    for cta in range(grid):
        for mt, nt in order[cta::grid]:
            _dw_tile(ap, bp, nk, mt, nt, m_valid, n_valid, out, written)
    assert ldv >= V and bool((written == 1).all()), "a dW element written twice or never"
    return out


def _dw_tile(ap, bp, nk, mt, nt, m_valid, n_valid, out, written):
    """One output tile: the products of every 64-row reduction chunk, then
    the store of its part inside dW."""
    acc = torch.zeros((BM, BN))
    for kc in range(nk):
        k0 = kc * BK
        a_boxes = [ap[k0:k0 + BK, mt * BM + 64 * j:mt * BM + 64 * (j + 1)] for j in range(BM // 64)]
        b_boxes = [bp[k0:k0 + BK, nt * BN + 64 * j:nt * BN + 64 * (j + 1)] for j in range(BN // 64)]
        acc += torch.cat(a_boxes, 1).t() @ torch.cat(b_boxes, 1)
    r0, c0 = mt * BM, nt * BN
    r1, c1 = min(BM, m_valid - r0), min(BN, n_valid - c0)
    out[r0:r0 + r1, c0:c0 + c1] = acc[:r1, :c1]
    written[r0:r0 + r1, c0:c0 + c1] += 1


def backward_walk(x, w, b, y, lse, ent, dlp, dlse, dent, tied, sms, chunk):
    """(dx, dW, db) as the ds, dx and dW kernels compute them, walking the
    rows in chunks of ``chunk`` (the wrapper's BWD_CHUNK_ROWS) for ds and dx,
    then dW once over every row's ds."""
    N, D = x.shape
    V = w.shape[0] if tied else w.shape[1]
    ldv = _ceil(V, K["DS_LD"])
    n_vt = -(-V // BN)
    wdv = _pad(_w_dv(w, tied), _ceil(D, BN), n_vt * BN)  # zero past D (dx tiles) and V
    C = min(chunk, _ceil(N, BM))
    dx = torch.zeros((N, D))
    dbpart = torch.zeros((-(-N // BM), V))
    ds_all = torch.full((_ceil(N, BM), ldv), float("nan"))  # the scratch holds garbage before the kernels
    for c0 in range(0, N, C):
        rows = min(C, N - c0)
        n_rt = -(-rows // BM)
        S = flp.split_count(rows, V, sms)
        tps = -(-n_vt // S)
        xp = _pad(x[c0:c0 + rows], n_rt * BM, D)
        vec = [_pad(t[c0:c0 + rows][None].float(), 1, n_rt * BM)[0] for t in (lse, ent, dlp, dlse, dent)]
        yc = _pad(y[c0:c0 + rows][None], 1, n_rt * BM)[0]
        ds = ds_all[c0:]
        for rt in range(n_rt):
            rr = torch.arange(rt * BM, (rt + 1) * BM)
            inr = (rr < rows)[:, None]
            lse_r, ent_r, dlp_r, dlse_r, dent_r = (v[rr][:, None] for v in vec)
            for sp in range(S):
                for vt in range(sp * tps, min(sp * tps + tps, n_vt)):
                    col = torch.arange(vt * BN, (vt + 1) * BN)
                    ok = (col < V)[None] & inr
                    s = _tile_scores(xp, wdv, rt, vt, D)
                    if b is not None:
                        s = s + torch.where(col < V, _pad(b[None], 1, n_vt * BN)[0][col], 0.0)
                    p = torch.exp(s - lse_r)
                    hit = (col[None] == yc[rr][:, None]).float()
                    dsv = dlp_r * (hit - p) + dlse_r * p - dent_r * p * (s - (lse_r - ent_r))
                    dsv = torch.where(ok, dsv, 0.0)
                    wr = col < ldv
                    ds[rt * BM:(rt + 1) * BM, col[wr]] = dsv[:, wr].to(x.dtype).float()
                    if b is not None:
                        dbpart[c0 // BM + rt, col[col < V]] = dsv.sum(0)[col < V]
        assert not torch.isnan(ds[: n_rt * BM]).any(), "a ds element of the chunk's row tiles was never written"
        # dx: 128 x 256 output tiles, the vocabulary in BK chunks, rows past
        # the chunk's read as zeros (the map's extent is `rows`).
        dsr = _pad(ds[:rows], n_rt * BM, ldv)
        for rt in range(n_rt):
            for dt in range(-(-D // BN)):
                acc = torch.zeros((BM, BN))
                for k0 in range(0, _ceil(V, BK), BK):
                    acc += dsr[rt * BM:(rt + 1) * BM, k0:k0 + BK] @ wdv[dt * BN:(dt + 1) * BN, k0:k0 + BK].t()
                r1 = min(BM, rows - rt * BM)
                c1 = min(BN, D - dt * BN)
                dx[c0 + rt * BM:c0 + rt * BM + r1, dt * BN:dt * BN + c1] = acc[:r1, :c1].to(x.dtype).float()
    assert not torch.isnan(ds_all).any(), "a ds row tile the dW kernel reads was never written"
    dw = dw_walk(x.float(), ds_all, N, V, tied, sms)
    db = None if b is None else dbpart.sum(0)
    return dx.to(x.dtype), dw.to(w.dtype), db


def _inputs(N, D, V, tied, bias, seed):
    """Seeded f32 inputs whose values are bf16-representable, logits spread
    as a trained head's."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()

    x = bf(rng.normal(size=(N, D)))
    w = bf(rng.normal(size=(V, D) if tied else (D, V)) * 3.5 * D ** -0.5)
    y = rng.integers(0, V, size=(N,)).astype(np.int32)
    b = bf(rng.normal(size=(V,)) * 0.1) if bias else None
    cts = [rng.normal(size=(N,)).astype(np.float32) for _ in range(3)]
    return x, w, y, b, cts


# (N, D, V, sms): row tails (N not a multiple of 128), vocabulary tails (V
# not a multiple of 256, of 128 or of 8), D not a multiple of dx's 256-wide
# tiles, and card sizes that give one or several tiles a split.
CASES = [(50, 128, 1000, 132), (300, 128, 4097, 132), (300, 384, 4097, 8), (130, 64, 50257, 132)]


@pytest.mark.parametrize("tied,bias", [(False, True), (False, False), (True, False), (True, True)],
                         ids=["untied-bias", "untied", "tied", "tied-bias"])
@pytest.mark.parametrize("N,D,V,sms", CASES, ids=[f"N{c[0]}-D{c[1]}-V{c[2]}-sm{c[3]}" for c in CASES])
def test_walk_matches_pallas_forward_and_vjp(N, D, V, sms, tied, bias):
    """The walk's (logprob, lse, entropy) and (dx, dW, db) against the Pallas
    kernels' forward and VJP (interpret mode), f32, on bf16-representable
    inputs; the backward walked in chunks of 128 rows, so the db partials
    and dW span several chunks."""
    x, w, y, b, cts = _inputs(N, D, V, tied, bias, seed=N + V)
    tx, tw, ty = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y)
    tb = None if b is None else torch.from_numpy(b)

    def f(x_, w_, *b_):
        return jax_fused_logprob(x_, w_, jnp.asarray(y), b_[0] if b_ else None, tied=tied, interpret=True)

    args = [jnp.asarray(x), jnp.asarray(w)] + ([jnp.asarray(b)] if bias else [])
    ref, vjp = jax.vjp(f, *args)
    rgrads = vjp(tuple(jnp.asarray(c) for c in cts))

    got = forward_walk(tx, tw, ty, tb, tied, sms)
    for name, g, r in zip(("logprob", "lse", "entropy"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL, err_msg=name)
    lse, ent = got[1], got[2]
    grads = backward_walk(tx, tw, tb, ty, lse, ent, *(torch.from_numpy(c) for c in cts), tied, sms, chunk=BM)
    assert (grads[2] is None) == (not bias)
    for name, g, r in zip(("dx", "dW", "db"), grads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL, err_msg=name)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_walk_bf16_matches_plain_backward(tied):
    """With bf16 activations the walk rounds ds to bf16 before the products,
    as the kernels and the port's plain backward do: the two agree within a
    bf16 rounding of ds (2^-8 of the largest |dx|, |dW|), and db, which sums
    the f32 ds, within f32 order."""
    N, D, V = 300, 128, 4097
    x, w, y, b, cts = _inputs(N, D, V, tied, True, seed=7)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw, ty, tb = torch.from_numpy(w), torch.from_numpy(y), torch.from_numpy(b)
    lp, lse, ent = flp.naive_logprob(tx, tw, ty, tb, tied=tied)
    cts = [torch.from_numpy(c) for c in cts]
    got = backward_walk(tx, tw, tb, ty, lse, ent, *cts, tied, 132, chunk=flp.BWD_CHUNK_ROWS)
    ref = flp.fused_logprob_bwd_plain(tx, tw, tb, ty, lse, ent, *cts, tied=tied)
    for name, g, r, rel in zip(("dx", "dW"), got, ref, (2e-2, 1e-2)):
        scale = float(r.float().abs().max())
        assert float((g.float() - r.float()).abs().max()) <= rel * scale, name
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(), rtol=1e-4, atol=1e-4)


def test_split_count_fills_the_card_once():
    """One CTA per SM at the smoke's shape (16 row tiles x 8 splits of 25 or
    22 tiles on 132 SMs; 8 x 16 for a 1024-row chunk); every split holds a
    tile; a grid with more row tiles than SMs takes one split."""
    assert flp.split_count(2048, 50400, 132) == 8
    assert flp.split_count(1024, 50400, 132) == 16
    assert flp.split_count(200 * 128, 50400, 132) == 1
    for n_rows in (1, 130, 1024, 2048, 5000):
        for V in (600, 4097, 50257, 50400):
            S = flp.split_count(n_rows, V, 132)
            n_vt = -(-V // BN)
            tps = -(-n_vt // S)
            assert (S - 1) * tps < n_vt <= S * tps
            assert -(-n_rows // BM) * S <= max(132, -(-n_rows // BM))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("N,D,V", [(300, 128, 4097), (130, 384, 1000), (1000, 128, 600)])
def test_dw_walk_one_pass_matches_plain_backward(N, D, V, tied):
    """The one dW pass over the ds of every row, after a ds walk in chunks
    of 128 rows, against the port's plain backward in f32: the same dW and
    db within f32 order, rows not a multiple of 64, several chunks."""
    x, w, y, b, cts = _inputs(N, D, V, tied, True, seed=3)
    tx, tw, ty, tb = (torch.from_numpy(a) for a in (x, w, y, b))
    lp, lse, ent = flp.naive_logprob(tx, tw, ty, tb, tied=tied)
    cts = [torch.from_numpy(c) for c in cts]
    got = backward_walk(tx, tw, tb, ty, lse, ent, *cts, tied, 132, chunk=BM)
    ref = flp.fused_logprob_bwd_plain(tx, tw, tb, ty, lse, ent, *cts, tied=tied)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), **TOL)
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(), **TOL)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_dw_walk_waves_share_ds_panels(tied):
    """At the smoke's shape (D = 4096, V = 50400, 132 SMs: 6304 tiles), the
    tiles of a wave share their ds panels: a wave of 132 tiles touches at
    most ceil(132 / x tiles) + 1 ds panels (5 untied, of 197; 10 tied, of
    394), so ds is read from memory about once while x stays in L2. Only
    the walk's order is modelled here (one reduction chunk of 64 rows)."""
    D, V, sms = 4096, 50400, 132
    order = dw_order(V, D, True) if tied else dw_order(D, V, False)
    panels = [mt if tied else nt for mt, nt in order]
    waves = [panels[i:i + sms] for i in range(0, len(panels), sms)]
    x_tiles = D // BN if tied else D // BM
    assert len(order) == len(set(order)) == 6304
    assert max(len(set(wv)) for wv in waves) <= -(-sms // x_tiles) + 1
