"""``chip_smoke.py``'s checks on the CPU. Its comparison of the
fused-logprob backward sees a ds that loses or flips one of its softmax
terms, at a small shape: the plain backward is the reference, and a copy
with a mutated ds plays the kernel; the unmutated copy must pass. Its
comparison of the launches a trace shows with the wrappers' counters sees
a kernel launched once too often or too rarely, beyond the device records
the trace proves it lost."""

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


@pytest.mark.parametrize("case", ["equal", "one_replay_short", "one_launch_extra", "none_traced",
                                  "short_within_proven_loss", "short_beyond_proven_loss", "extra_despite_loss"])
def test_traced_launch_check(case):
    """Replayed launches are counted from the trace: equal counts pass and
    report the port's kernels only (PyTorch's own flash kernel and cuBLAS
    left out); a trace with a decode kernel fewer or a flash launch more
    than the counters, or with none of the port's kernels, is refused. A
    trace that proves device records lost may fall short by no more than
    those in all, and may exceed the counters by none."""
    counted = {"decode_attention": 224, "flash_attention_fwd": 28, "fused_logprob_fwd": 0}
    traced = {"equal": dict(decode_split=224, decode_merge=224, flash_fwd=28, torch_flash=3, gemm=900),
              "one_replay_short": dict(decode_split=223, decode_merge=223, flash_fwd=28),
              "one_launch_extra": dict(decode_split=224, decode_merge=224, flash_fwd=29),
              "none_traced": dict(gemm=900),
              "short_within_proven_loss": dict(decode_split=221, decode_merge=223, flash_fwd=28, gemm=880),
              "short_beyond_proven_loss": dict(decode_split=221, decode_merge=220, flash_fwd=28, gemm=880),
              "extra_despite_loss": dict(decode_split=222, decode_merge=222, flash_fwd=29, gemm=880)}[case]
    lost = 0 if case in ("equal", "one_replay_short", "one_launch_extra", "none_traced") else 4
    if case == "none_traced":
        counted = {}
    if case in ("equal", "short_within_proven_loss"):
        got = chip_smoke.traced_launches(_events(**traced), counted, lost)
        assert got == {"decode_split_kernel": traced["decode_split"], "decode_merge_kernel": traced["decode_merge"],
                       "flash_fwd_kernel": 28}
        return
    with pytest.raises(AssertionError, match="launches in the trace"):
        chip_smoke.traced_launches(_events(**traced), counted, lost)


def _raw(device_type, name, corr):
    """A kineto raw event as ``prof.profiler.kineto_results.events()`` gives it."""
    return SimpleNamespace(device_type=lambda: device_type, name=lambda: name, correlation_id=lambda: corr)


@pytest.mark.parametrize("case", ["complete", "kernel_records_lost", "graph_replay_short", "replay_runs_another"])
def test_lost_device_records(case):
    """A trace proves records lost from its own host records: a kernel
    launch with no device record of its correlation id, and a graph launch
    with fewer device records than the fullest launch of the trace; memset
    and memcpy calls and device records of other launches prove nothing.
    The port's kernels in each complete graph launch are counted by kernel:
    one count where every whole replay ran the same, two where one whole
    replay ran another kernel in place of one of them."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    raw = [_raw(cpu, "cudaMemsetAsync", 1), _raw(cuda, "Memset (Device)", 1)]
    for corr in range(10, 20):
        raw.append(_raw(cpu, "cudaLaunchKernel" if corr % 2 else "cuLaunchKernelEx", corr))
        if case != "kernel_records_lost" or corr not in (12, 13, 17):
            raw.append(_raw(cuda, "decode_split_kernel", corr))
    for corr in range(30, 34):
        raw.append(_raw(cpu, "cudaGraphLaunch", corr))
        n = 8 - 3 * (case == "graph_replay_short" and corr == 32)
        other = int(case == "replay_runs_another" and corr == 31)
        raw.extend(_raw(cuda, "decode_merge_kernel", corr) for _ in range(n - other))
        raw.extend(_raw(cuda, "void (anonymous namespace)::w8a16_swap_kernel<8, 2, 64>(CUtensorMap_st)", corr)
                   for _ in range(other))
    got = chip_smoke.lost_device_records(raw)
    assert got["complete_graph_launches"] == (3 if case == "graph_replay_short" else 4)
    assert got["kernels_per_complete_graph_launch"] == (
        {"decode_merge_kernel": [7, 8], "w8a16_": [0, 1]} if case == "replay_runs_another"
        else {"decode_merge_kernel": [8]})
    assert got["lost"] == {"complete": 0, "kernel_records_lost": 3, "graph_replay_short": 3, "replay_runs_another": 0}[case]
    assert (got["kernel_launch_records"], got["graph_launch_records"]) == (10, 4)
    assert got["device_records_per_graph_launch"] == [5 if case == "graph_replay_short" else 8, 8]


def test_device_events_group_raw_records_as_key_averages_does():
    """The smoke reads a trace's device records from kineto's raw events:
    grouped by kernel name with their counts and summed durations (us), host
    records left out; ``traced_launches`` takes them as it takes
    ``key_averages``' device events."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def raw(device_type, name, ns):
        return SimpleNamespace(device_type=lambda: device_type, name=lambda: name, duration_ns=lambda: ns)

    records = [raw(cpu, "cudaLaunchKernel", 5000), raw(cuda, "flash_fwd_kernel", 2000), raw(cpu, "aten::mm", 9000),
               raw(cuda, "flash_fwd_kernel", 3000), raw(cuda, "decode_split_kernel", 1500),
               raw(cuda, "decode_merge_kernel", 500)]
    got = {e.key: (e.count, e.self_device_time_total) for e in chip_smoke.device_events(records)}
    assert got == {"flash_fwd_kernel": (2, 5.0), "decode_split_kernel": (1, 1.5), "decode_merge_kernel": (1, 0.5)}
    counted = {"flash_attention_fwd": 2, "decode_attention": 1}
    assert chip_smoke.traced_launches(chip_smoke.device_events(records), counted) == {
        "flash_fwd_kernel": 2, "decode_split_kernel": 1, "decode_merge_kernel": 1}


def test_smoke_gptj_checkpoint_layout(tmp_path):
    """The HF directory the smoke writes: the published GPT-J-6B config maps
    to the smoke's GPT-J-6B architecture, and its tensor names are exactly
    the HF GPT-J state dict the port's exporter checks against."""
    import json

    from trlx_tpu_torch.models.hf_export import hf_state_keys
    from trlx_tpu_torch.models.hf_import import lm_config_from_hf, read_hf_config

    (tmp_path / "config.json").write_text(json.dumps(chip_smoke.GPTJ_6B_HF_CONFIG))
    cfg = lm_config_from_hf(read_hf_config(str(tmp_path)))
    arch = {k: v for k, v in chip_smoke.GPTJ_6B_ARCH.items() if k not in ("eos_token_id", "d_ff")}
    assert cfg.ff_dim == chip_smoke.GPTJ_6B_ARCH["d_ff"]  # n_inner null: 4 x n_embd
    for k, v in arch.items():
        assert getattr(cfg, k) == (tuple(v) if isinstance(v, list) else v), k
    for n_layer in (2, 28):
        assert set(chip_smoke.gptj_hf_shapes(n_layer)) == hf_state_keys("gptj", cfg.replace(n_layer=n_layer))


def test_smoke_byte_tokenizer_round_trip():
    """The smoke's byte-level tokenizer: text → its bytes → the same text;
    BOS / EOS / pad (50256) are skipped when decoding."""
    tok = chip_smoke.ByteTokenizer()
    text = "".join(chip_smoke.seeded_texts(1, 0))
    ids = tok(text)["input_ids"]
    assert len(ids) == len(text) and max(ids) < 127
    assert tok.batch_decode([[50256, 50256, *ids, 50256]]) == [text]
