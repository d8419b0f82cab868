"""The port's int8 and paged decode-attention plain versions against the JAX
package's Pallas kernels run in interpret mode (``_kernel_quant``,
``_paged_kernel_plain``, ``_paged_kernel_quant``), on the same numpy inputs,
and ``quantize_kv``'s int8 codes against the JAX package's, bit for bit.

On the CPU the port's wrappers take their plain versions, so these tests
also pin what a wrapper returns here and that no launch counter moves.

Tolerances: float32 on both sides, int8 codes identical; what differs is the
summation order (128-key blocks vs one einsum), ~1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models.lm import quantize_kv as jax_quantize_kv
from trlx_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from trlx_tpu.ops.decode_attention import paged_decode_attention as jax_paged_decode_attention
from trlx_tpu_torch.models.lm import quantize_kv
from trlx_tpu_torch.ops import decode_attention as dec

# Tiny shapes: one intra-op thread, so torch's thread pool does not compete
# with the other test files' workers for the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
COUNTERS = (dec.decode_attention, dec.decode_attention_int8, dec.paged_decode_attention,
            dec.paged_decode_attention_int8)


def _launches():
    return [f.launches for f in COUNTERS]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _quant_inputs(B=3, T=200, h=2, d=128, seed=0, fully_masked=False):
    """q, int8 k/v with their [B, T, h] scales (the JAX package's codes),
    and a bias row with left padding, an unwritten tail and, optionally, a
    row whose every key is masked."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, h, d)).astype(np.float32)
    kq, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(rng.normal(size=(B, T, h, d)), jnp.float32)))
    vq, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(rng.normal(size=(B, T, h, d)), jnp.float32)))
    valid = np.ones((B, T), dtype=bool)
    valid[0, : min(7, T - 1)] = False
    valid[1, T - min(60, T - 1):] = False
    if fully_masked:
        valid[B - 1] = False
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    return q, kq, vq, ks, vs, bias


@pytest.mark.parametrize("T,fully_masked", [(64, False), (200, False), (200, True), (384, True)],
                         ids=["one-block", "ragged-tail", "ragged-masked-row", "aligned-masked-row"])
def test_int8_plain_matches_pallas_kernel_quant(T, fully_masked):
    """Row 8 (``_kernel_quant``): scores q.k8 * scale * ks + bias, p * vs
    folded in f32; ragged T (a partial last 128-key block) and a fully
    masked row, which attends over its keys by raw score in both."""
    q, kq, vq, ks, vs, bias = _quant_inputs(T=T, fully_masked=fully_masked)
    ref = jax_decode_attention(*(jnp.asarray(x) for x in (q, kq, vq, ks, vs, bias)), scale=0.125, interpret=True)
    before = _launches()
    tq, tk, tv, tks, tvs, tb = _t(q, kq, vq, ks, vs, bias)
    out = dec.decode_attention(tq, tk, tv, tb, scale=0.125, ks=tks, vs=tvs)
    out_direct = dec.decode_attention_int8(tq, tk, tv, tks, tvs, tb, scale=0.125)
    assert _launches() == before
    assert out.shape == (3, 1, 2, 128) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(out.numpy(), out_direct.numpy())


def test_int8_plain_matches_pallas_at_the_gptj_head_layout():
    """h = 16, d = 256 (GPT-J-6B's heads) at a ragged cache length."""
    q, kq, vq, ks, vs, bias = _quant_inputs(B=2, T=160, h=16, d=256, seed=4)
    ref = jax_decode_attention(*(jnp.asarray(x) for x in (q, kq, vq, ks, vs, bias)), scale=0.0625, interpret=True)
    tq, tk, tv, tks, tvs, tb = _t(q, kq, vq, ks, vs, bias)
    out = dec.decode_attention(tq, tk, tv, tb, scale=0.0625, ks=tks, vs=tvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _paged_inputs(S=6, h=2, d=128, bs=32, bps=4, seed=7, share=True, quant=False):
    """A shared pool and per-slot tables with every row class the engine
    makes: scrambled physical placement, a left pad of one whole block, a
    ragged mid-block pad, frontiers inside the last block, a fully masked
    row, a hole across a block boundary, and (``share``) three slots on the
    same physical prefix block; plus a dead slot whose table is all trash
    block 0 under a stale mask, as after a harvest."""
    rng = np.random.default_rng(seed)
    T = bps * bs
    n_blocks = 1 + S * bps
    q = rng.normal(size=(S, h, d)).astype(np.float32)
    k_pool = rng.normal(size=(n_blocks, bs, h, d)).astype(np.float32)
    v_pool = rng.normal(size=(n_blocks, bs, h, d)).astype(np.float32)
    tables = np.arange(1, 1 + S * bps, dtype=np.int32).reshape(S, bps)
    if share:
        tables[1:3, 0] = tables[0, 0]
    perm = rng.permutation(np.unique(tables))
    remap = dict(zip(np.unique(tables).tolist(), perm.tolist()))
    tables = np.vectorize(remap.get)(tables).astype(np.int32)
    tables[5] = 0  # dead slot on the trash block
    valid = np.ones((S, T), dtype=bool)
    valid[0, :bs] = False
    valid[1, : bs // 2] = False
    valid[2, T - bs - 3:] = False
    valid[3, :] = False
    valid[4, bs - 1 : 2 * bs + 1] = False
    valid[5, T // 2:] = False
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    if not quant:
        return q, k_pool, v_pool, None, None, tables, bias
    kq, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(k_pool)))
    vq, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(v_pool)))
    return q, kq, vq, ks, vs, tables, bias


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-kernel", "int8-kernel"])
@pytest.mark.parametrize("share", [False, True], ids=["private", "shared-prefix"])
def test_paged_plain_matches_pallas(quant, share):
    """Rows 9 (``_paged_kernel_plain``) and 10 (``_paged_kernel_quant``):
    the gathered virtual view pool[tbl], the same body."""
    q, kp, vp, ks, vs, tables, bias = _paged_inputs(share=share, quant=quant, seed=7 + quant)
    jargs = [jnp.asarray(x) if x is not None else None for x in (q, kp, vp, ks, vs, tables, bias)]
    ref = jax_paged_decode_attention(*jargs, scale=0.0625, interpret=True)
    before = _launches()
    tq, tk, tv, tt, tb = _t(q, kp, vp, tables, bias)
    tks, tvs = _t(ks, vs) if quant else (None, None)
    out = dec.paged_decode_attention(tq, tk, tv, tt, tb, scale=0.0625, ks=tks, vs=tvs)
    assert _launches() == before
    assert out.shape == (6, 1, 2, 128) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # The paged plain version is the direct one over the gathered view.
    gv = (lambda x: dec.gather_pool(x, tt) if x is not None else None)
    direct = dec.decode_attention_plain(tq, gv(tk), gv(tv), tb, scale=0.0625, ks=gv(tks), vs=gv(tvs))
    np.testing.assert_array_equal(out.numpy(), direct.numpy())


def test_slot_entries_turn_the_mask_into_the_bias():
    q, kp, vp, ks, vs, tables, bias = _paged_inputs(quant=True, seed=3)
    tq, tk, tv, tks, tvs, tt, tb = _t(q, kp, vp, ks, vs, tables, bias)
    mask = (tb == 0).to(torch.int32)
    got = dec.paged_slot_decode_attention(tq, tk, tv, tt, mask, scale=0.1, ks=tks, vs=tvs)
    want = dec.paged_decode_attention(tq, tk, tv, tt, tb, scale=0.1, ks=tks, vs=tvs)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    k, v, kss, vss = (dec.gather_pool(x, tt) for x in (tk, tv, tks, tvs))
    got = dec.slot_decode_attention(tq, k, v, mask, scale=0.1, ks=kss, vs=vss)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_paged_eligibility_rule():
    """The JAX package's shape rule, with the device condition left to the
    caller: 128-aligned head_dim, n_head a multiple of 8, and a 128-divisible
    block unless a slot is one block."""
    assert dec.paged_decode_eligible(16, 256, 128, 8, True)
    assert not dec.paged_decode_eligible(16, 256, 96, 8, True)
    assert dec.paged_decode_eligible(16, 256, 96, 1, False)
    assert not dec.paged_decode_eligible(16, 200, 128, 8, True)
    assert not dec.paged_decode_eligible(3, 256, 128, 8, True)


@pytest.mark.parametrize("shape,scale", [((2, 5, 3, 16), 1.0), ((3, 7, 4, 64), 40.0), ((1, 4, 16, 256), 1e-3)])
def test_quantize_kv_codes_bit_equal_to_jax(shape, scale):
    """Round half to even and the ±127 clip: the same codes and scales bit
    for bit, on random values and on values placed exactly at .5 code
    boundaries, zeros and a constant row."""
    rng = np.random.default_rng(hash(shape) % 2**32)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = 3.0
    ref_s = np.asarray(jax_quantize_kv(jnp.asarray(x))[1])
    # Values k.5 codes from their row's absmax: ties that round to even.
    half = (np.arange(shape[-1]) % 7 - 3 + 0.5).astype(np.float32)
    x[-1, -1, -1] = half * ref_s[-1, -1, -1]
    for xx in (x, x.astype(np.float32) * np.float32(0.37)):
        jq, js = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(xx)))
        tq, ts = quantize_kv(torch.from_numpy(xx))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), jq)
        np.testing.assert_array_equal(ts.numpy().view(np.int32), js.view(np.int32))
