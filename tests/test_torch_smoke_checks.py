"""``chip_smoke.py``'s comparison of the fused-logprob backward sees a ds
that loses or flips one of its softmax terms, at a small shape on the CPU:
the plain backward is the reference, and a copy with a mutated ds plays the
kernel. The unmutated copy must pass."""

import pytest
import torch

import chip_smoke
from trlx_tpu_torch.ops.fused_logprob import fused_logprob_bwd_plain, naive_logprob


def _bwd(x, w, bias, labels, lse, ent, dlp, dlse, dent, mutation):
    """The plain backward written out again, with ds mutated."""
    s = x.float() @ w.to(x.dtype).float() + bias.float()
    lse, ent, dlp, dlse, dent = (t[:, None].float() for t in (lse, ent, dlp, dlse, dent))
    p = torch.exp(s - lse)
    hit = torch.nn.functional.one_hot(labels.long(), s.shape[-1]).float()
    ent_term = dent * p * (s - (lse - ent))
    ds = {
        "none": dlp * (hit - p) + dlse * p - ent_term,
        "drop_softmax_terms": dlp * hit,
        "flip_entropy_term": dlp * (hit - p) + dlse * p + ent_term,
        "drop_lse_term": dlp * (hit - p) - ent_term,
    }[mutation]
    dsc = ds.to(x.dtype).float()
    dx = (dsc @ w.to(x.dtype).float().t()).to(x.dtype)
    return dx, x.float().t() @ dsc, ds.sum(0)


@pytest.mark.parametrize("mutation", ["none", "drop_softmax_terms", "flip_entropy_term", "drop_lse_term"])
def test_head_grad_check_sees_a_mutated_ds(mutation):
    """As the smoke's phase: logits of std ~3.5, bias, three cotangents of
    0.1. dx alone, and dW/db alone, must each reject every mutation."""
    g = torch.Generator().manual_seed(0)
    N, D, V = 256, 256, 8192
    x = torch.randn((N, D), generator=g).to(torch.bfloat16)
    w = torch.randn((D, V), generator=g) * (3.5 * D ** -0.5)
    b = torch.randn((V,), generator=g) * 0.1
    y = torch.randint(0, V, (N,), generator=g)
    _, lse, ent = naive_logprob(x, w, y, b)
    cts = [torch.randn((N,), generator=g) * 0.1 for _ in range(3)]
    ref = fused_logprob_bwd_plain(x, w, b, y, lse, ent, *cts)
    dx, dw, db = _bwd(x, w, b, y, lse, ent, *cts, mutation=mutation)
    if mutation == "none":
        chip_smoke.check_head_grads((dx, dw, db), ref, y)
        return
    with pytest.raises(AssertionError, match="logprob_bwd.dx"):
        chip_smoke.check_head_grads((dx, ref[1], ref[2]), ref, y)
    with pytest.raises(AssertionError, match=r"logprob_bwd.d[wb]"):
        chip_smoke.check_head_grads((ref[0], dw, db), ref, y)
