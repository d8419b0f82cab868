"""The port's plain kernel versions against the JAX package's Pallas kernels
run in interpret mode, on the same numpy inputs, in float32: the forwards,
and the backwards (``jax.vjp`` through the Pallas custom VJPs) against both
the plain backward functions and the CPU path of the autograd Functions.

On the CPU the port's wrappers take their plain versions, so these tests
also pin what a wrapper returns here and that its launch counter stays 0.

Padded query rows: a query row whose every key is masked (a left-pad row)
attends uniformly over the key BLOCKS the kernel visits, while the plain
version spreads it over all keys; only rows with at least one valid key
(every mask-1 row) are compared for flash attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from trlx_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from trlx_tpu.ops.fused_logprob import fused_logprob as jax_fused_logprob
from trlx_tpu.ops.fused_logprob import routed_logprob as jax_routed_logprob
from trlx_tpu_torch.ops import decode_attention as dec_mod
from trlx_tpu_torch.ops import flash_attention as flash_mod
from trlx_tpu_torch.ops import fused_logprob as flp_mod

# Tiny shapes: one intra-op thread, so torch's thread pool does not compete
# with the other test files' workers for the cores.
torch.set_num_threads(1)

# float32 on both sides; the remaining difference is summation order.
TOL = dict(rtol=1e-4, atol=1e-5)


def _flash_inputs(seed=0, b=2, T=64, h=2, d=16, pads=(0, 11)):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, T, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, T), dtype=np.float32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0.0
    return q, k, v, mask


@pytest.mark.parametrize(
    "window,pads",
    [(0, (0, 0)), (0, (0, 11)), (16, (5, 23)), (4, (0, 40))],
    ids=["causal", "causal-leftpad", "window-leftpad", "narrow-window-leftpad"],
)
def test_flash_plain_matches_pallas(window, pads):
    q, k, v, mask = _flash_inputs(pads=pads)
    scale = 0.25
    ref_o, ref_lse = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), scale=scale, causal=True,
        window=window, block_q=32, block_k=32, interpret=True, return_lse=True,
    )
    before = flash_mod.flash_fwd.launches
    o, lse = flash_mod.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask),
        scale=scale, window=window, return_lse=True,
    )
    assert flash_mod.flash_fwd.launches == before
    rows = mask.astype(bool)  # [b, T]: query rows with a valid own key
    np.testing.assert_allclose(o.numpy()[rows], np.asarray(ref_o)[rows], **TOL)
    lse_rows = np.broadcast_to(rows[:, None, :], lse.shape)
    np.testing.assert_allclose(lse.numpy()[lse_rows], np.asarray(ref_lse)[lse_rows], **TOL)


@pytest.mark.parametrize(
    "window,pads", [(0, (0, 11)), (16, (5, 23))], ids=["causal-leftpad", "window-leftpad"],
)
def test_flash_backward_matches_pallas_vjp(window, pads):
    """dq, dk, dv with a nonzero lse cotangent. Padded query rows carry no
    cotangent (as in the model, where no later position reads them), so
    every row of dk/dv and every valid row of dq compare."""
    q, k, v, mask = _flash_inputs(seed=1, pads=pads)
    rng = np.random.default_rng(2)
    rows = mask.astype(bool)
    do = (rng.normal(size=q.shape) * rows[:, :, None, None]).astype(np.float32)
    dlse = (rng.normal(size=(q.shape[0], q.shape[2], q.shape[1])) * rows[:, None, :]).astype(np.float32)
    scale = 0.25

    def f(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, jnp.asarray(mask), scale=scale, causal=True, window=window,
                                   block_q=32, block_k=32, interpret=True, return_lse=True)

    (o_ref, lse_ref), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = flash_mod.flash_attention(tq, tk, tv, torch.from_numpy(mask), scale=scale, window=window,
                                       return_lse=True)
    by_fn = torch.autograd.grad((o, lse), (tq, tk, tv), (torch.from_numpy(do), torch.from_numpy(dlse)))
    plain = flash_mod.flash_attention_bwd_plain(
        tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(mask), o.detach(), lse.detach(),
        torch.from_numpy(do), torch.from_numpy(dlse), scale=scale, window=window,
    )
    for got in (by_fn, plain):
        np.testing.assert_allclose(got[0].numpy()[rows], np.asarray(ref[0])[rows], **TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **TOL)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), **TOL)


def _decode_inputs(seed=0, B=3, T=200, h=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, h, d)).astype(np.float32) for _ in range(2))
    valid = np.ones((B, T), dtype=bool)
    valid[0, :7] = False  # left padding
    valid[1, T - 60:] = False  # unwritten cache tail
    valid[2, :] = False  # every key masked: uniform attention
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    return q, k, v, bias


def test_decode_plain_matches_pallas_ragged_T():
    """T = 200 with 128-wide blocks: the kernel's masked tail block. Row 2
    has every key masked and attends uniformly in both."""
    q, k, v, bias = _decode_inputs()
    ref = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, jnp.asarray(bias),
        scale=0.25, interpret=True, block_t=128,
    )
    before = dec_mod.decode_attention.launches
    out = dec_mod.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(bias), scale=0.25
    )
    assert dec_mod.decode_attention.launches == before
    assert out.shape == (3, 1, 2, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy()[2, 0], v[2].mean(0), rtol=1e-4, atol=1e-5)


def _logprob_inputs(tied, bias, seed=0, N=12, D=32, V=300):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, N // 2, D)).astype(np.float32)
    w = (rng.normal(size=(V, D) if tied else (D, V)) * 0.2).astype(np.float32)
    y = rng.integers(0, V, size=(2, N // 2)).astype(np.int32)
    b = (rng.normal(size=(V,)) * 0.5).astype(np.float32) if bias else None
    return x, w, y, b


@pytest.mark.parametrize("tied,bias", [(False, True), (False, False), (True, False)],
                         ids=["untied-bias", "untied", "tied"])
def test_fused_logprob_plain_matches_pallas_ragged_V(tied, bias):
    """V = 300 over 128-wide vocab tiles: the kernel's masked vocab tail."""
    x, w, y, b = _logprob_inputs(tied, bias)
    ref = jax_fused_logprob(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(y), None if b is None else jnp.asarray(b),
        tied=tied, interpret=True, block_v=128,
    )
    before = flp_mod.fused_logprob_fwd.launches
    got = flp_mod.fused_logprob(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
        None if b is None else torch.from_numpy(b), tied=tied,
    )
    assert flp_mod.fused_logprob_fwd.launches == before
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tied,bias", [(False, True), (False, False), (True, False), (True, True)],
                         ids=["untied-bias", "untied", "tied", "tied-bias"])
def test_fused_logprob_backward_matches_pallas_vjp(tied, bias):
    """dx, dW, db with all three cotangents nonzero; N = 12 rows against
    the kernel's 128-row blocks (ragged N) and V = 300 against 128-wide
    vocabulary tiles (ragged V)."""
    x, w, y, b = _logprob_inputs(tied, bias, seed=3)
    rng = np.random.default_rng(4)
    cts = [rng.normal(size=y.shape).astype(np.float32) for _ in range(3)]

    def f(x_, w_, *b_):
        return jax_fused_logprob(x_, w_, jnp.asarray(y), b_[0] if b_ else None, tied=tied, interpret=True,
                                 block_v=128)

    args = [jnp.asarray(x), jnp.asarray(w)] + ([jnp.asarray(b)] if bias else [])
    _, vjp = jax.vjp(f, *args)
    ref = vjp(tuple(jnp.asarray(c) for c in cts))

    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_() if bias else None
    lp, lse, ent = flp_mod.fused_logprob(tx, tw, torch.from_numpy(y), tb, tied=tied)
    wrt = (tx, tw) + ((tb,) if bias else ())
    by_fn = torch.autograd.grad((lp, lse, ent), wrt, tuple(torch.from_numpy(c) for c in cts))
    plain = flp_mod.fused_logprob_bwd_plain(
        tx.detach(), tw.detach(), None if tb is None else tb.detach(), torch.from_numpy(y), lse.detach(),
        ent.detach(), *(torch.from_numpy(c) for c in cts), tied=tied,
    )
    assert (plain[2] is None) == (not bias)
    for got in (by_fn, plain[: len(wrt)]):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_routed_logprob_masked_matches_pallas(tied):
    """The model layer's entry with a label mask, forced onto the kernel
    path in both packages: masked rows are exact zeros."""
    x, w, y, b = _logprob_inputs(tied, bias=not tied, seed=1)
    m = np.ones(y.shape, dtype=np.int32)
    m[0, -2:] = 0
    m[1, 0] = 0
    ref = jax_routed_logprob(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(y), None if b is None else jnp.asarray(b),
        tied=tied, mode="force", mask=jnp.asarray(m),
    )
    got = flp_mod.routed_logprob(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
        None if b is None else torch.from_numpy(b), tied=tied, mode="force", mask=torch.from_numpy(m),
    )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
        assert np.all(g.numpy()[m == 0] == 0)


def test_shape_rules_match_the_jax_package():
    """The routing rules are carried over word for word (the JAX package adds
    "on a TPU backend", the port "on a CUDA device")."""
    for q_len in (64, 255, 256, 384, 400, 768, 1024):
        assert flash_mod.auto_flash_ok(q_len) == (q_len >= 256 and q_len % 128 == 0)
    for h, d in ((16, 256), (8, 128), (12, 64), (4, 128), (16, 96)):
        assert dec_mod.decode_attn_eligible(h, d) == (d % 128 == 0 and h % 8 == 0)
    for D, V in ((4096, 50400), (64, 512), (96, 50400), (128, 300)):
        assert flp_mod.fused_logprob_eligible(D, V) == (D % 128 == 0 and V >= 512)
