"""The algebra of the decode kernels' split-T walk (``csrc/decode_attn.cu``)
on the CPU: a plain split-and-merge reference, written here, against the
port's plain versions (``decode_attention_plain``,
``paged_decode_attention_plain``) and the JAX package's Pallas kernels run
in interpret mode, on the same numpy inputs.

The reference cuts each row's T keys into splits of ``SPLIT_KEYS``, keeps
per split and head the running max m, the sum l and the unnormalised acc,
skips a split whose bias entries are all masked (<= -5e8) when its row has
a visible key elsewhere, and merges: M = max m_s over the splits read,
L = sum e^(m_s - M) l_s, o = sum e^(m_s - M) acc_s / max(L, 1e-30). It pins
that the skip is exact (bit-equal to reading the split) and that a row with
no visible key reads every split and attends uniformly.

Tolerance: float32 on both sides; what differs is the summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models.lm import quantize_kv as jax_quantize_kv
from trlx_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from trlx_tpu.ops.decode_attention import paged_decode_attention as jax_paged_decode_attention
from trlx_tpu_torch.ops import decode_attention as dec

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
M_INIT = np.float32(-1e30)
SKIP_BIAS = -5e8
H, D, SCALE = 2, 32, 0.25


def split_walk(q, k, v, bias, *, scale, ks=None, vs=None, skip=True):
    """The kernel's walk in f32 numpy. q [B, h, d]; k/v [B, T, h, d];
    ks/vs [B, T, h] or None; bias [B, T]. Returns (out [B, h, d], splits
    read per row)."""
    B, T = bias.shape
    n = -(-T // dec.SPLIT_KEYS)
    f32 = np.float32
    out = np.zeros(q.shape, f32)
    reads = np.zeros(B, int)
    for b in range(B):
        live = bias[b] > SKIP_BIAS
        row_live = live.any()
        parts = []
        for s in range(n):
            sl = slice(s * dec.SPLIT_KEYS, min(T, (s + 1) * dec.SPLIT_KEYS))
            if skip and row_live and not live[sl].any():
                parts.append((np.full(q.shape[1], M_INIT, f32), np.zeros(q.shape[1], f32), None))
                continue
            reads[b] += 1
            sc = np.einsum("hd,thd->ht", q[b], k[b, sl].astype(f32)).astype(f32) * f32(scale)
            if ks is not None:
                sc = sc * ks[b, sl].T
            sc = sc + bias[b, sl][None, :]
            m = np.maximum(M_INIT, sc.max(-1))
            p = np.exp(sc - m[:, None])
            l = p.sum(-1, dtype=f32)
            if vs is not None:
                p = p * vs[b, sl].T
            parts.append((m, l, np.einsum("ht,thd->hd", p, v[b, sl].astype(f32)).astype(f32)))
        read = [part for part in parts if part[2] is not None]
        M = np.max([m for m, _, _ in read], axis=0)
        L = np.zeros(q.shape[1], f32)
        acc = np.zeros(q.shape[1:], f32)
        for m, l, a in read:
            w = np.exp(m - M)
            L = L + w * l
            acc = acc + w[:, None] * a
        out[b] = acc / np.maximum(L, f32(1e-30))[:, None]
    return out, reads


def split_rows(B, T):
    """Row 0: a left pad and, past 256 keys, a whole split masked in the
    middle; row 1: no visible key; row 2: one visible key; row 3: visible
    keys only at the start, masked splits to the end; row 4 (a dead slot
    when paged): visible in its first half."""
    valid = np.ones((B, T), dtype=bool)
    valid[0, : min(5, T - 1)] = False
    if T > 256:
        valid[0, 128:256] = False
    valid[1] = False
    valid[2] = False
    valid[2, T // 2] = True
    valid[3, min(T, 100):] = False
    valid[4, T // 2:] = False
    return valid, np.where(valid, 0.0, -1e9).astype(np.float32)


def expected_reads(valid):
    T = valid.shape[1]
    n = -(-T // dec.SPLIT_KEYS)
    live = [[valid[b, s * dec.SPLIT_KEYS:(s + 1) * dec.SPLIT_KEYS].any() for s in range(n)] for b in range(len(valid))]
    return np.array([sum(r) if any(r) else n for r in live])


def _kv(rng, shape, quant):
    x = rng.normal(size=shape).astype(np.float32)
    if not quant:
        return x, None
    q8, s = jax_quantize_kv(jnp.asarray(x))
    return np.array(q8), np.array(s)


def _check_walk(out, reads, q, k, v, bias, valid, ks, vs):
    """The skip is exact, rows without a visible key read every split and
    attend uniformly, and the walk agrees with the port's plain version."""
    full, full_reads = split_walk(q, k, v, bias, scale=SCALE, ks=ks, vs=vs, skip=False)
    np.testing.assert_array_equal(out, full)
    np.testing.assert_array_equal(reads, expected_reads(valid))
    assert (full_reads == full_reads.max()).all()
    vv = v[1].astype(np.float32) * (vs[1][..., None] if vs is not None else 1.0)
    np.testing.assert_allclose(out[1], vv.mean(0), **TOL)
    t = [torch.from_numpy(x) if x is not None else None for x in (q, k, v, bias, ks, vs)]
    plain = dec.decode_attention_plain(t[0], t[1], t[2], t[3], scale=SCALE, ks=t[4], vs=t[5])
    np.testing.assert_allclose(out, plain.numpy()[:, 0], **TOL)


@pytest.mark.parametrize("T", [1, 127, 128, 129, 300, 1024])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-kernel", "int8-kernel"])
def test_split_walk_matches_plain_and_pallas(quant, T):
    """Rows 7 (``_kernel_plain``) and 8 (``_kernel_quant``): the walk at the
    split edges against the plain version and the Pallas kernel."""
    rng = np.random.default_rng(T + 7 * quant)
    B = 5
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    (k, ks), (v, vs) = _kv(rng, (B, T, H, D), quant), _kv(rng, (B, T, H, D), quant)
    valid, bias = split_rows(B, T)
    out, reads = split_walk(q, k, v, bias, scale=SCALE, ks=ks, vs=vs)
    _check_walk(out, reads, q, k, v, bias, valid, ks, vs)
    args = [jnp.asarray(x) if x is not None else None for x in (q, k, v, ks, vs, bias)]
    ref = jax_decode_attention(*args, scale=SCALE, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref)[:, 0], **TOL)
    before = [f.launches for f in (dec.decode_attention, dec.decode_attention_int8)]
    t = [torch.from_numpy(x) if x is not None else None for x in (q, k, v, bias, ks, vs)]
    dec.decode_attention(t[0], t[1], t[2], t[3], scale=SCALE, ks=t[4], vs=t[5])
    assert [f.launches for f in (dec.decode_attention, dec.decode_attention_int8)] == before


@pytest.mark.parametrize("bs,bps", [(48, 1), (48, 3), (48, 7), (128, 1), (128, 3), (128, 8)])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-kernel", "int8-kernel"])
def test_paged_split_walk_matches_plain_and_pallas(quant, bs, bps):
    """Rows 9 (``_paged_kernel_plain``) and 10 (``_paged_kernel_quant``):
    the walk over the pool read through scrambled tables, slots 0 and 1
    sharing their first block, slot 4 dead on the trash block 0 under a
    stale mask; splits inside one block (bs = 128) and across blocks
    (bs = 48, the algebra only: the CUDA kernel takes such blocks only as
    one block a slot)."""
    rng = np.random.default_rng(100 * bs + bps + quant)
    S = 5
    n_blocks = 1 + S * bps
    q = rng.normal(size=(S, H, D)).astype(np.float32)
    (kp, ks), (vp, vs) = _kv(rng, (n_blocks, bs, H, D), quant), _kv(rng, (n_blocks, bs, H, D), quant)
    tables = (rng.permutation(n_blocks - 1) + 1)[: S * bps].reshape(S, bps).astype(np.int32)
    tables[1, 0] = tables[0, 0]
    tables[S - 1] = 0
    valid, bias = split_rows(S, bs * bps)

    def gather(x):
        return None if x is None else x[tables].reshape((S, bps * bs) + x.shape[2:])

    out, reads = split_walk(q, gather(kp), gather(vp), bias, scale=SCALE, ks=gather(ks), vs=gather(vs))
    _check_walk(out, reads, q, gather(kp), gather(vp), bias, valid, gather(ks), gather(vs))
    args = [jnp.asarray(x) if x is not None else None for x in (q, kp, vp, ks, vs, tables, bias)]
    ref = jax_paged_decode_attention(*args, scale=SCALE, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref)[:, 0], **TOL)
    t = [torch.from_numpy(x) if x is not None else None for x in (q, kp, vp, tables, bias, ks, vs)]
    paged = dec.paged_decode_attention_plain(*t[:5], scale=SCALE, ks=t[5], vs=t[6])
    np.testing.assert_allclose(out, paged.numpy()[:, 0], **TOL)
