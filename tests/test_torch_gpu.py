"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. Every test here needs a CUDA device and skips without one;
on a machine with a card run them with

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: inputs and outputs are bf16 (one ulp is 2^-8 relative); the
kernels and the plain versions sum in another order, and the fused-logprob
plain version rounds its logits to bf16 where the kernel keeps f32.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


def _cuda():
    """Decided inside each test, never at import: every worker must collect
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("T,window,pads", [(128, 0, (0, 37)), (200, 0, (5, 0)), (256, 64, (0, 90)), (200, 8, (0, 37))])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_kernel_matches_plain(T, window, pads, d):
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain, flash_fwd

    g = torch.Generator(device=dev).manual_seed(0)
    b, h = 2, 4
    q, k, v = (torch.randn((b, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    before = flash_fwd.launches
    o, lse = flash_attention(q, k, v, mask, scale=d ** -0.5, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    ro, rlse = flash_attention_plain(q, k, v, mask, scale=d ** -0.5, window=window, return_lse=True)
    rows = mask.bool()
    torch.testing.assert_close(o[rows].float(), ro[rows].float(), rtol=0, atol=2e-2)
    lrows = rows[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[lrows], rlse[lrows], rtol=0, atol=1e-2)


def test_flash_kernel_strided_inputs():
    """q/k/v as views of one fused [b, T, 3, h, d] projection (strided rows)."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((2, 256, 3, 4, 128), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    mask = torch.ones((2, 256), device=dev)
    o = flash_attention(q, k, v, mask, scale=0.1)
    ro = flash_attention_plain(q, k, v, mask, scale=0.1)
    torch.testing.assert_close(o.float(), ro.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("T", [1, 77, 128, 300, 1024])
@pytest.mark.parametrize("d", [128, 256])
def test_decode_kernel_matches_plain(T, d):
    dev = _cuda()
    from trlx_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain

    g = torch.Generator(device=dev).manual_seed(2)
    B, h = 3, 8
    q = torch.randn((B, h, d), generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((B, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    valid[0, : T // 3] = False
    valid[1, T - T // 4:] = False
    if T > 1:
        valid[2] = False  # every key masked: uniform weights
    bias = torch.where(valid, 0.0, -1e9).float()
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, bias, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_plain(q, kc, vc, bias, scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)


@pytest.mark.parametrize("tied,bias,wdtype", [(False, True, torch.float32), (False, False, torch.bfloat16),
                                              (True, False, torch.float32)])
@pytest.mark.parametrize("N,V", [(50, 1000), (300, 4097)])
def test_fused_logprob_kernel_matches_plain(tied, bias, wdtype, N, V):
    dev = _cuda()
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob, fused_logprob_fwd, naive_logprob

    g = torch.Generator(device=dev).manual_seed(3)
    D = 256
    x = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((V, D) if tied else (D, V), generator=g, device=dev) * D ** -0.5).to(wdtype)
    b = torch.randn((V,), generator=g, device=dev) * 0.1 if bias else None
    y = torch.randint(0, V, (N,), generator=g, device=dev)
    before = fused_logprob_fwd.launches
    got = fused_logprob(x, w, y, b, tied=tied)
    torch.cuda.synchronize()
    assert fused_logprob_fwd.launches == before + 1
    ref = naive_logprob(x, w, y, b, tied=tied)
    for gv, rv in zip(got, ref):
        torch.testing.assert_close(gv, rv, rtol=0, atol=5e-2)


def _close(got, ref, rel):
    """Max |got - ref| within ``rel`` of max |ref| (bf16 outputs whose
    scale depends on the shape)."""
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    scale = float(ref.abs().max()) + 1e-6
    err = float((got - ref).abs().max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("T,window,pads", [(128, 0, (0, 37)), (200, 0, (5, 0)), (256, 64, (0, 90)), (77, 8, (0, 30))])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_kernels_match_plain(T, window, pads, d):
    """dq and dk/dv against the plain backward, with the lse cotangent on.
    Padded query rows carry no cotangent, as in the model (no later position
    reads them), so every row of dk/dv and every valid row of dq compare."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_bwd_dkv, flash_bwd_dq, flash_fwd,
    )

    g = torch.Generator(device=dev).manual_seed(4)
    b, h, scale = 2, 4, d ** -0.5
    q, k, v = (torch.randn((b, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    rows = mask.bool()
    o, lse = flash_fwd(q, k, v, mask, scale=scale, window=window)
    do = (torch.randn((b, T, h, d), generator=g, device=dev) * rows[:, :, None, None]).to(torch.bfloat16)
    dlse = torch.randn((b, h, T), generator=g, device=dev) * rows[:, None, :]
    n_dq, n_dkv = flash_bwd_dq.launches, flash_bwd_dkv.launches
    dq, dk, dv = flash_attention_bwd(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (n_dq + 1, n_dkv + 1)
    rq, rk, rv = flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
    # bf16 outputs and bf16 P / dS in the products on both sides; the sums
    # run in another order (64-wide tiles vs one einsum).
    _close(dq[rows], rq[rows], 2e-2)
    _close(dk, rk, 2e-2)
    _close(dv, rv, 2e-2)


@pytest.mark.parametrize("tied,bias,wdtype", [(False, True, torch.float32), (False, False, torch.bfloat16),
                                              (True, False, torch.float32), (True, True, torch.float32)])
@pytest.mark.parametrize("N,V", [(50, 1000), (1300, 4097)])
def test_fused_logprob_bwd_kernels_match_plain(tied, bias, wdtype, N, V):
    """dx, dW and db against the plain backward with all three cotangents:
    ragged N (1300 rows are two chunks of 1024), V not a multiple of the
    128-wide tile, logits spread as a trained head's (std ~3.5). dW and db
    are also held on the columns no label hits, where ds is only the small
    softmax terms."""
    dev = _cuda()
    from trlx_tpu_torch.ops.fused_logprob import (
        BWD_CHUNK_ROWS, fused_logprob_bwd, fused_logprob_bwd_dw, fused_logprob_bwd_dx, fused_logprob_bwd_plain,
        fused_logprob_fwd,
    )

    g = torch.Generator(device=dev).manual_seed(5)
    D = 256
    x = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((V, D) if tied else (D, V), generator=g, device=dev) * (3.5 * D ** -0.5)).to(wdtype)
    b = torch.randn((V,), generator=g, device=dev) * 0.1 if bias else None
    y = torch.randint(0, V, (N,), generator=g, device=dev)
    _, lse, ent = fused_logprob_fwd(x, w, y, b, tied=tied)
    dlp, dlse, dent = (torch.randn((N,), generator=g, device=dev) for _ in range(3))
    n_dx, n_dw = fused_logprob_bwd_dx.launches, fused_logprob_bwd_dw.launches
    dx, dw, db = fused_logprob_bwd(x, w, b, y, lse, ent, dlp, dlse, dent, tied=tied)
    torch.cuda.synchronize()
    chunks = -(-N // BWD_CHUNK_ROWS)
    assert (fused_logprob_bwd_dx.launches, fused_logprob_bwd_dw.launches) == (n_dx + chunks, n_dw + chunks)
    assert dx.dtype == torch.bfloat16 and dw.dtype == wdtype
    rdx, rdw, rdb = fused_logprob_bwd_plain(x, w, b, y, lse, ent, dlp, dlse, dent, tied=tied)
    # ds is rounded to bf16 on both sides before the products, and a sum in
    # another order can flip that rounding; dx comes back in bf16.
    _close(dx, rdx, 2e-2)
    _close(dw, rdw, 1e-2)
    if bias:
        _close(db, rdb, 1e-3)
    else:
        assert db is None
    unhit = torch.ones(V, dtype=torch.bool, device=dev)
    unhit[y] = False
    _close(dw[unhit] if tied else dw[:, unhit], rdw[unhit] if tied else rdw[:, unhit], 1e-2)
    if bias:
        _close(db[unhit], rdb[unhit], 1e-3)


def test_wrappers_raise_instead_of_falling_back():
    """A CUDA tensor the kernel does not take raises; nothing drops to the
    plain version."""
    dev = _cuda()
    from trlx_tpu_torch.ops.decode_attention import decode_attention
    from trlx_tpu_torch.ops.flash_attention import flash_attention
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob

    q = torch.randn((1, 64, 2, 64), device=dev)  # float32: the kernels take bf16
    with pytest.raises(TypeError):
        flash_attention(q, q, q, torch.ones((1, 64), device=dev), scale=1.0)
    with pytest.raises(TypeError):
        decode_attention(q[:, 0], q, q, torch.zeros((1, 64), device=dev), scale=1.0)
    with pytest.raises(TypeError):
        fused_logprob(torch.randn((4, 64), device=dev), torch.randn((64, 600), device=dev),
                      torch.zeros((4,), dtype=torch.int32, device=dev))
    qb = q.to(torch.bfloat16)[..., :48]  # head_dim 48: no kernel instance
    with pytest.raises(ValueError):
        flash_attention(qb, qb, qb, torch.ones((1, 64), device=dev), scale=1.0)


def test_model_routes_through_kernels():
    """A bf16 model on the card: a long aligned prefill goes through the
    flash kernel in every layer, each decode step through the decode kernel,
    and the eligible fused head through the logprob kernel."""
    dev = _cuda()
    from trlx_tpu_torch.models.heads import LMWithValueHead
    from trlx_tpu_torch.models.hf_import import init_params
    from trlx_tpu_torch.models.lm import LMConfig, init_cache
    from trlx_tpu_torch.ops.decode_attention import decode_attention
    from trlx_tpu_torch.ops.flash_attention import flash_fwd
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_fwd

    cfg = LMConfig(vocab_size=1024, n_layer=2, n_head=8, d_model=1024, max_position=512, pos_type="rotary",
                   rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                   tie_word_embeddings=False, extra={"lm_head_bias": True})
    model = LMWithValueHead(cfg, branch_layer=1, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    B, P = 2, 256
    ids = torch.randint(0, 1024, (B, P), device=dev, dtype=torch.int32)
    pmask = torch.ones((B, P), dtype=torch.int32, device=dev)
    cache = init_cache(cfg, B, P + 1, dev)
    cmask = torch.cat([pmask, torch.zeros((B, 1), dtype=torch.int32, device=dev)], 1)
    f0, d0, l0 = flash_fwd.launches, decode_attention.launches, fused_logprob_fwd.launches
    with torch.no_grad():
        out = model(ids, pmask, cache=cache, cache_index=0, cache_mask=cmask)
        cmask[:, P] = 1
        step = model(ids[:, :1], torch.ones((B, 1), dtype=torch.int32, device=dev), cache=out["cache"],
                     cache_index=P, cache_mask=cmask)
        lp = model(ids, pmask, labels=ids[:, 1:])["logprobs"]
    torch.cuda.synchronize()
    assert flash_fwd.launches - f0 == 2 * cfg.n_layer
    assert decode_attention.launches - d0 == cfg.n_layer
    assert fused_logprob_fwd.launches - l0 == 1
    assert torch.isfinite(step["logits"].float()).all() and torch.isfinite(lp).all()


def test_generate_eos_exit_on_the_card():
    """With eos set, the decode loop on the card polls "every row finished"
    without waiting for the device. Tokens, mask and stats equal the CPU
    run's, which checks the flag at once, and the loop still stops well
    before max_new_tokens. Float32 model, too small for any kernel."""
    dev = _cuda()
    from trlx_tpu_torch.models.hf_import import init_params
    from trlx_tpu_torch.models.lm import LMConfig, TransformerLM
    from trlx_tpu_torch.ops.generate import generate
    from trlx_tpu_torch.ops.sampling import GenerateConfig, make_bigram_mask_processor

    V, eos, N = 64, 40, 48
    cfg = LMConfig.from_dict(dict(vocab_size=V, n_layer=2, n_head=2, d_model=32, max_position=128,
                                  dtype="float32", param_dtype="float32"))
    cpu_model = TransformerLM(cfg, device="cpu")
    init_params(cpu_model, torch.Generator().manual_seed(0))
    gpu_model = TransformerLM(cfg, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    # Each token's one allowed successor is the next id: a row whose prompt
    # ends in token t emits eos at step eos - t - 1.
    forbid = torch.ones((V, V), dtype=torch.bool)
    forbid[torch.arange(V), (torch.arange(V) + 1) % V] = False
    ids = torch.tensor([[3, 5, 30], [7, 9, 35], [1, 2, 38]])
    gcfg = GenerateConfig(max_new_tokens=N, do_sample=True, eos_token_id=eos)

    def stats_fn(tok, s):
        return {"lp": torch.log_softmax(s["last_logits"], -1).gather(-1, tok[:, None].long())[:, 0]}

    runs = []
    for model, gen in ((cpu_model, torch.Generator()), (gpu_model, torch.Generator(device=dev))):
        calls = [0]
        hook = model.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
        with torch.no_grad():
            tokens, mask, stats = generate(model, ids, torch.ones_like(ids), gen.manual_seed(0), gcfg=gcfg,
                                           processor=make_bigram_mask_processor(forbid), step_stats_fn=stats_fn)
        hook.remove()
        runs.append((tokens.cpu(), mask.cpu(), stats["lp"].cpu(), calls[0]))
    (ct, cm, clp, c_calls), (gt, gm, glp, g_calls) = runs
    assert torch.equal(ct, gt) and torch.equal(cm, gm)
    assert cm[:, 3:].sum(1).tolist() == [10, 5, 2]
    torch.testing.assert_close(glp, clp, rtol=0, atol=1e-4)
    assert c_calls == 1 + 10  # prefill, then steps 0..9; all rows finished at step 9
    assert 1 + 10 <= g_calls < 1 + N


def test_train_on_the_card(tmp_path):
    """A small end-to-end ``trlx_tpu_torch.train`` on the card, at widths
    every kernel takes (T = 256, head_dim 128, d_model 1024, V = 1024): the
    train steps go through the flash and fused-logprob backward kernels,
    every logged loss is finite, no step is skipped, and step 1's ratio is
    1 (the policy is the rollout policy)."""
    dev = _cuda()
    import json

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_bwd_dw, fused_logprob_bwd_dx

    P, R, V = 192, 64, 1024
    arch = dict(vocab_size=V, n_layer=2, n_head=8, d_model=1024, max_position=512, pos_type="rotary",
                rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                tie_word_embeddings=False, extra={"lm_head_bias": True})
    config = TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1, model_arch=arch,
                      dtype="bfloat16", param_dtype="float32", remat=True),
        "train": dict(total_steps=8, seq_length=P + R, epochs=2, batch_size=8, lr_ramp_steps=1, lr_decay_steps=100,
                      weight_decay=1e-6, learning_rate_init=1e-4, learning_rate_target=1e-4,
                      checkpoint_interval=10**6, eval_interval=10**6, checkpoint_dir=str(tmp_path), seed=3),
        "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=2,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    })
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, size=int(rng.integers(100, P + 1))).tolist() for _ in range(16)]
    counters = (flash_bwd_dq, flash_bwd_dkv, fused_logprob_bwd_dx, fused_logprob_bwd_dw)
    before = [c.launches for c in counters]
    trainer = trlx_tpu_torch.train(reward_fn=lambda s: [float(np.mean(np.asarray(x) % 2)) for x in s],
                                   prompts=prompts, config=config)
    torch.cuda.synchronize()
    assert trainer.device == dev and trainer.iter_count == 8
    assert [c.launches - b for c, b in zip(counters, before)] == [8 * 2, 8 * 2, 8, 8]
    with open(tmp_path / "metrics.jsonl") as f:
        steps = [r for r in map(json.loads, f) if "loss" in r]
    assert len(steps) == 8
    assert all(np.isfinite(r["loss"]) and r["resilience/nonfinite"] == 0.0 for r in steps)
    assert abs(steps[0]["mean_ratio"] - 1.0) < 0.05
