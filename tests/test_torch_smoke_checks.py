"""``chip_smoke.py``'s checks on the CPU. Its comparison of the
fused-logprob backward sees a ds that loses or flips one of its softmax
terms, at a small shape: the plain backward is the reference, and a copy
with a mutated ds plays the kernel; the unmutated copy must pass. Its
comparison of the launches a trace shows with the wrappers' counters sees
a kernel launched once too often or too rarely."""

from types import SimpleNamespace

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


def _events(**counts):
    """Profiler-like kernel events, named as the card's trace names them."""
    names = {"decode_split": "void (anonymous namespace)::decode_split_kernel<256, false, false>(DecodeParams)",
             "decode_merge": "void (anonymous namespace)::decode_merge_kernel<256>(float const*, bf16*, int)",
             "flash_fwd": "void (anonymous namespace)::flash_fwd_kernel<256>(CUtensorMap, FwdParams)",
             "torch_flash": "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<256>>(Params)",
             "gemm": "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT"}
    return [SimpleNamespace(key=names[k], count=n) for k, n in counts.items()]


@pytest.mark.parametrize("case", ["equal", "one_replay_short", "one_launch_extra", "none_traced"])
def test_traced_launch_check(case):
    """Replayed launches are counted from the trace: equal counts pass and
    report the port's kernels only (PyTorch's own flash kernel and cuBLAS
    left out); a trace with a decode kernel fewer or a flash launch more
    than the counters, or with none of the port's kernels, is refused."""
    counted = {"decode_attention": 224, "flash_attention_fwd": 28, "fused_logprob_fwd": 0}
    traced = {"equal": dict(decode_split=224, decode_merge=224, flash_fwd=28, torch_flash=3, gemm=900),
              "one_replay_short": dict(decode_split=223, decode_merge=223, flash_fwd=28),
              "one_launch_extra": dict(decode_split=224, decode_merge=224, flash_fwd=29),
              "none_traced": dict(gemm=900)}[case]
    if case == "none_traced":
        counted = {}
    if case == "equal":
        got = chip_smoke.traced_launches(_events(**traced), counted)
        assert got == {"decode_split_kernel": 224, "decode_merge_kernel": 224, "flash_fwd_kernel": 28}
        return
    with pytest.raises(AssertionError, match="launches in the trace"):
        chip_smoke.traced_launches(_events(**traced), counted)
