"""The flash kernels' key-offset and non-causal modes (ring attention's per-chunk
attention), plain versions against the JAX package's Pallas kernels.

The same seeded numpy q/k/v, key mask and cotangents go through
``trlx_tpu.ops.flash_attention.flash_attention(..., offset=, causal=,
return_lse=True)`` in interpret mode (blocks of 16 over T = 32, so the JAX
kernel skips whole blocks) and the port's ``FlashAttentionFn`` on the CPU
(its plain forward and backward), for offsets {-2t, -t, 0, +t} x causal
{True, False} x window {0, 12}.

- Rows with a valid reachable key: o and lse agree within 1e-5 (float32 on
  both sides; only the summation order differs), as the JAX ring tests hold
  their op.
- Rows with no reachable key (a wholly future chunk under causality, or keys
  beyond the window): the port returns o = 0 and lse = M_INIT, the JAX
  forward's finalisation where every key block of the row was skipped; the
  JAX kernel returns exactly that where it skipped the row's block, and
  elsewhere (a live block whose other rows reach keys) a uniform mix with
  lse <= -1e9 + log T. Either way a log-sum-exp combine with any row that
  has a real key gives the chunk weight exactly 0 in float32, so its
  cotangents are 0, as here: dq, dk and dv then agree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from trlx_tpu_torch.ops import flash_attention as flash_mod

torch.set_num_threads(1)

T, B, H, D, W, BLK = 32, 2, 2, 16, 12, 16
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(off, causal, window) for off in (-2 * T, -T, 0, T) for causal in (True, False) for window in (0, W)]
IDS = [f"off{off}-{'causal' if c else 'full'}-w{w}" for off, c, w in CASES]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, T), np.float32)
    mask[1, :5] = 0.0  # left padding of the visiting chunk's keys
    do = rng.normal(size=q.shape).astype(np.float32)
    dlse = rng.normal(size=(B, H, T)).astype(np.float32)
    return q, k, v, mask, do, dlse


def _row_classes(mask, causal, window, offset):
    """[B, T] bool: rows with a valid reachable key; [T] bool: rows that
    reach a key by position at all."""
    reach = flash_mod.reachable(T, T, "cpu", causal=causal, window=window, offset=offset).numpy()
    good = (reach[None] & (mask[:, None, :] > 0.5)).any(-1)
    return good, reach.any(-1)


def _jax_block_live(causal, window, offset):
    """[T] bool: the JAX kernel visits some key block of the row's query
    block (its _run_if_live over blocks of BLK)."""
    live = np.zeros(T, bool)
    for q0 in range(0, T, BLK):
        for k0 in range(0, T, BLK):
            ok = True
            if causal:
                ok &= k0 + offset <= q0 + BLK - 1
            if window > 0:
                ok &= k0 + BLK - 1 + offset > q0 - window
            live[q0:q0 + BLK] |= ok
    return live


def _jax(q, k, v, mask, do, dlse, causal, window, offset):
    def f(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, jnp.asarray(mask), scale=D ** -0.5, causal=causal, window=window,
                                   offset=offset, block_q=BLK, block_k=BLK, interpret=True, return_lse=True)

    (o, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def _port(q, k, v, mask, do, dlse, causal, window, offset):
    q_, k_, v_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = flash_mod.FlashAttentionFn.apply(q_, k_, v_, torch.from_numpy(mask), D ** -0.5, causal, window, offset)
    torch.autograd.backward((o, lse), (torch.from_numpy(do), torch.from_numpy(dlse)))
    return o.detach().numpy(), lse.detach().numpy(), [x.grad.numpy() for x in (q_, k_, v_)]


@pytest.mark.parametrize("offset,causal,window", CASES, ids=IDS)
def test_plain_modes_match_pallas(offset, causal, window):
    q, k, v, mask, do, dlse = _inputs(abs(offset) + 3 * causal + window)
    good, reaches = _row_classes(mask, causal, window, offset)
    # Rows without a valid reachable key carry no cotangent (their combine weight is 0).
    do = do * good[:, :, None, None]
    dlse = dlse * good[:, None, :]
    jo, jlse, jg = _jax(q, k, v, mask, do, dlse, causal, window, offset)
    po, plse, pg = _port(q, k, v, mask, do, dlse, causal, window, offset)

    gq = np.broadcast_to(good[:, :, None, None], po.shape)
    np.testing.assert_allclose(po[gq], jo[gq], **TOL)
    gl = np.broadcast_to(good[:, None, :], plse.shape)
    np.testing.assert_allclose(plse[gl], jlse[gl], **TOL)
    for got, ref in zip(pg, jg):
        np.testing.assert_allclose(got, ref, **TOL)

    # Rows that reach no key: the port's o = 0 and lse = M_INIT; the JAX
    # kernel's where it skipped their block, a zero-weight lse elsewhere.
    dead = ~reaches
    assert (po[:, dead] == 0).all() and (plse[:, :, dead] == flash_mod.M_INIT).all()
    skipped = dead & ~_jax_block_live(causal, window, offset)
    assert (jo[:, skipped] == 0).all() and (jlse[:, :, skipped] == flash_mod.M_INIT).all()
    bad = ~np.broadcast_to(good[:, None, :], plse.shape)
    assert (jlse[bad] <= flash_mod.MASK_VAL + np.log(T) + 1).all()
    assert (plse[bad] <= flash_mod.MASK_VAL + np.log(T) + 1).all()
    # ... so the ring's combine (logaddexp with a row that has a real key)
    # gives them weight exactly 0 in float32.
    for lse_c in (jlse[bad], plse[bad]):
        lse_c = torch.from_numpy(np.ascontiguousarray(lse_c))
        real = torch.zeros_like(lse_c)
        assert (torch.exp(lse_c - torch.logaddexp(real, lse_c)) == 0).all()


def test_future_chunk_gives_zero_gradient_even_with_cotangents():
    """A wholly future chunk (offset +t, causal): every row reaches no key,
    so even nonzero cotangents give dq = dk = dv = 0 (p = 0 from lse =
    M_INIT, in the plain backward as in the kernels), where exp(s - lse)
    would otherwise be inf."""
    q, k, v, mask, do, dlse = _inputs(11)
    po, plse, pg = _port(q, k, v, mask, do, dlse, True, 0, T)
    assert (po == 0).all() and (plse == flash_mod.M_INIT).all()
    for g in pg:
        assert np.isfinite(g).all() and (g == 0).all()


def test_flash_attention_entry_takes_the_modes_without_grad():
    """``flash_attention`` without grad takes the plain forward with the same
    modes as the autograd Function."""
    q, k, v, mask, _, _ = (torch.from_numpy(x) for x in _inputs(5))
    for causal, window, offset in ((False, 0, -T), (True, W, -T), (True, 0, 8)):
        o, lse = flash_mod.flash_attention(q, k, v, mask, scale=0.25, causal=causal, window=window, offset=offset,
                                           return_lse=True)
        ro, rlse = flash_mod.FlashAttentionFn.apply(q, k, v, mask, 0.25, causal, window, offset)
        assert torch.equal(o, ro) and torch.equal(lse, rlse)
