"""Offline ILQL in the port against the JAX package.

- The losses: the golden case and the dense wrapper against the gathered
  terms (twins of ``tests/test_losses.py``), and the label-logit identity
  Q = logprob + logsumexp at float32, through the port's fused route and
  the JAX package's Pallas kernel (interpret mode).
- ``LMWithILQLHeads`` on the JAX model's parameters: shapes and values
  (twin of ``tests/test_model.py::test_ilql_heads_shapes``).
- The f32 route of the fused head on the CPU: f32 activations through
  ``fused_logprob`` and ``FusedLogprobFn`` equal ``naive_logprob`` and the
  plain backward, and every output and gradient stays float32.
- A tuple carry (two Q heads) through the port's sampler against the JAX
  sampler, greedy and steered by the advantage.
- ``OfflineOrchestrator`` with prompt-only and over-truncated samples (twin
  of ``tests/test_e2e.py::test_offline_orchestrator_degenerate_samples``)
  and the storage's loader order against the JAX storage's.
- The whole slice: the same tiny config, token-array samples, rewards and
  bigram logit mask go through ``trlx_tpu.train(dataset=...)`` and
  ``trlx_tpu_torch.train(dataset=...)``, the port starting from the JAX
  trainer's initial parameters and target heads. Four steps (2 epochs of
  2 batches of 8) with a Polyak sync after each, then a greedy
  ``evaluate()``; once on the dense route,
  once with ``fused_logprob="force"`` + flash attention + remat (the JAX side
  runs its Pallas kernels in interpret mode, the port its plain versions
  through the autograd Functions). Every logged loss term, ``grad_norm`` and
  the learning rate agree within 1e-5 at step 1 and 2e-4 after (float32
  differences compound over the updates); the final online and target Q
  heads within 2e-4; the greedy eval tokens are equal.
- A torch twin of ``tests/test_e2e.py::test_ilql_learns_randomwalks``
  (marked slow, like its JAX twin).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.models.heads import LMWithILQLHeads as JaxLMWithILQLHeads
from trlx_tpu.models.lm import LMConfig as JaxLMConfig
from trlx_tpu.ops.fused_logprob import routed_logprob as jax_routed_logprob
from trlx_tpu.ops.generate import make_generate_fn as jax_make_generate_fn
from trlx_tpu.ops.ilql_loss import ilql_loss as jax_ilql_loss
from trlx_tpu.ops.modeling import topk_mask as jax_topk_mask
from trlx_tpu.ops.sampling import GenerateConfig as JaxGenerateConfig
from trlx_tpu.pipeline.ilql_pipeline import ILQLRolloutStorage as JaxILQLRolloutStorage
from trlx_tpu.trainer.ilql import ILQLTrainer as JaxILQLTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.heads import LMWithILQLHeads
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.models.lm import LMConfig
from trlx_tpu_torch.ops.fused_logprob import (
    FusedLogprobFn, fused_logprob, fused_logprob_bwd_plain, naive_logprob, routed_logprob,
)
from trlx_tpu_torch.ops.generate import make_generate_fn
from trlx_tpu_torch.ops.ilql_loss import action_tokens, ilql_loss, ilql_loss_terms
from trlx_tpu_torch.ops.modeling import logprobs_from_logits, topk_mask
from trlx_tpu_torch.ops.sampling import GenerateConfig
from trlx_tpu_torch.orchestrator.offline_orchestrator import OfflineOrchestrator
from trlx_tpu_torch.pipeline.ilql_pipeline import ILQLRolloutStorage
from trlx_tpu_torch.trainer import register_model
from trlx_tpu_torch.trainer.ilql import ILQLTrainer

torch.set_num_threads(1)

V, T = 31, 12
ARCH = dict(vocab_size=V, n_layer=2, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
            parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
            extra={"lm_head_bias": True}, dtype="float32", param_dtype="float32")


# ------------------------------------------------------------------ losses


def test_ilql_loss_golden():
    """Hand-computable single-sample case: 2 tokens, 1 action (the JAX
    test's numbers)."""
    logits = torch.zeros((1, 2, 3))
    qs = (torch.tensor([[[0.0, 0.0, 1.0]]]), torch.tensor([[[0.0, 0.0, 0.5]]]))
    target_qs = (torch.tensor([[[0.0, 0.0, 2.0]]]), torch.tensor([[[0.0, 0.0, 1.5]]]))
    vs = torch.tensor([[0.5, 9.9]])
    loss, stats = ilql_loss(logits, qs, target_qs, vs, torch.tensor([[1, 2]]), torch.ones((1, 2), dtype=torch.int32),
                            torch.tensor([[0]]), torch.tensor([[1.0]]), torch.tensor([[1, 0]]),
                            gamma=0.9, tau=0.7, cql_scale=0.0, awac_scale=0.0)
    # loss_q = (1 - 1)^2 + (0.5 - 1)^2; targetQ 1.5 >= V 0.5, so loss_v = 0.7 * 1^2.
    np.testing.assert_allclose(float(stats["losses/loss_q"]), 0.25, rtol=1e-5)
    np.testing.assert_allclose(float(stats["losses/loss_v"]), 0.7, rtol=1e-5)
    np.testing.assert_allclose(float(loss), 0.95, rtol=1e-5)


def _dense_case(seed=6):
    rng = np.random.default_rng(seed)
    b, Tn, A, Vn = 2, 8, 3, 11
    arrays = dict(
        logits=rng.normal(size=(b, Tn, Vn)).astype(np.float32),
        qs=tuple(rng.normal(size=(b, A, Vn)).astype(np.float32) for _ in range(2)),
        tqs=tuple(rng.normal(size=(b, A, Vn)).astype(np.float32) for _ in range(2)),
        vs=rng.normal(size=(b, A + 1)).astype(np.float32),
        ids=rng.integers(0, Vn, size=(b, Tn)).astype(np.int32),
        attn=np.ones((b, Tn), dtype=np.int32),
        aix=np.asarray([[1, 2, 3], [2, 3, 4]], dtype=np.int32),
        rew=rng.normal(size=(b, A)).astype(np.float32),
        dones=np.concatenate([np.ones((b, A)), np.zeros((b, 1))], 1).astype(np.float32),
    )
    arrays["attn"][1, -2:] = 0
    return arrays


def test_ilql_loss_terms_matches_dense_wrapper():
    """``ilql_loss`` equals ``ilql_loss_terms`` fed with the gathered Q,
    target Q and CQL NLL and the AWAC scalar (exactly as in the JAX test,
    rtol 1e-6), and both equal the JAX package's ``ilql_loss`` on the same
    arrays within 1e-6."""
    a = _dense_case()
    t = {k: (tuple(torch.from_numpy(x) for x in v) if isinstance(v, tuple) else torch.from_numpy(v))
         for k, v in a.items()}
    kw = dict(gamma=0.9, tau=0.7, cql_scale=0.3, awac_scale=0.5)
    loss_d, st_d = ilql_loss(t["logits"], t["qs"], t["tqs"], t["vs"], t["ids"], t["attn"], t["aix"], t["rew"],
                             t["dones"], **kw)
    actions = action_tokens(t["ids"], t["aix"])

    def gather(q):
        return torch.gather(q, -1, actions.long()[..., None])[..., 0]

    nlls = [-logprobs_from_logits(q, actions) for q in t["qs"]]
    attn1 = t["attn"][:, 1:].float()
    nll = -logprobs_from_logits(t["logits"][:, :-1], t["ids"][:, 1:])
    awac = (nll * attn1).sum() / torch.clamp(attn1.sum(), min=1.0)
    loss_t, st_t = ilql_loss_terms([gather(q) for q in t["qs"]], [gather(q) for q in t["tqs"]], nlls, t["vs"],
                                   t["rew"], t["dones"], awac, **kw)
    np.testing.assert_allclose(float(loss_d), float(loss_t), rtol=1e-6)
    j = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v)) for k, v in a.items()}
    loss_j, st_j = jax_ilql_loss(j["logits"], j["qs"], j["tqs"], j["vs"], j["ids"], j["attn"], j["aix"], j["rew"],
                                 j["dones"], **kw)
    np.testing.assert_allclose(float(loss_d), float(loss_j), rtol=1e-6)
    for k in st_j:
        np.testing.assert_allclose(float(st_d[k]), float(st_t[k]), rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(st_d[k]), float(st_j[k]), rtol=1e-6, err_msg=k)


def _head_case(seed=3, N=12, D=32, Vh=200):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(N, D)), 0).astype(np.float32)  # a relu hidden, as the Q heads see
    w = (rng.normal(size=(D, Vh)) * 3.5 / np.sqrt(D)).astype(np.float32)
    b = (rng.normal(size=(Vh,)) * 0.1).astype(np.float32)
    y = rng.integers(0, Vh, size=(N,)).astype(np.int32)
    return x, w, b, y


def test_label_logit_identity_lp_plus_lse():
    """The fused ILQL identity at float32: the gathered label LOGIT equals
    logprob + logsumexp from the fused route (1e-5), and the port's (lp,
    lse) equal the JAX Pallas kernel's in interpret mode (1e-5)."""
    x, w, b, y = _head_case()
    lp, lse, _ = routed_logprob(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
                                torch.from_numpy(b), tied=False, mode="force")
    assert lp.dtype == lse.dtype == torch.float32
    logits = x @ w + b
    np.testing.assert_allclose((lp + lse).numpy(), logits[np.arange(len(y)), y], rtol=1e-5, atol=1e-5)
    jlp, jlse, _ = jax_routed_logprob(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y), jnp.asarray(b), tied=False,
                                      mode="force")
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_f32_route_on_the_cpu_is_the_plain_version_in_f32(bias):
    """f32 activations through ``fused_logprob`` (no grad) and
    ``FusedLogprobFn`` (grad) give ``naive_logprob``'s outputs exactly and
    the plain backward's gradients exactly (the CPU route IS the plain
    version), and nothing comes back in bfloat16."""
    x, w, b, y = _head_case(seed=4)
    xt, wt, yt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y)
    bt = torch.from_numpy(b) if bias else None
    ref = naive_logprob(xt, wt, yt, bt)
    with torch.no_grad():
        got = fused_logprob(xt, wt, yt, bt)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert torch.equal(g, r)
    xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    bg = None if bt is None else bt.clone().requires_grad_()
    lp, lse, ent = FusedLogprobFn.apply(xg, wg, bg, yt, False)
    rng = np.random.default_rng(5)
    cts = [torch.from_numpy(rng.normal(size=(len(y),)).astype(np.float32)) for _ in range(3)]
    (lp * cts[0] + lse * cts[1] + ent * cts[2]).sum().backward()
    rdx, rdw, rdb = fused_logprob_bwd_plain(xt, wt, bt, yt, lse.detach(), ent.detach(), *cts)
    assert xg.grad.dtype == wg.grad.dtype == torch.float32
    assert torch.equal(xg.grad, rdx) and torch.equal(wg.grad, rdw)
    if bias:
        assert bg.grad.dtype == torch.float32 and torch.equal(bg.grad, rdb)


# ------------------------------------------------------------------- model


def _jax_ilql_pair(seed=0):
    jmodel = JaxLMWithILQLHeads(JaxLMConfig.from_dict(ARCH), two_qs=True)
    ids0 = jnp.ones((1, 4), dtype=jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), ids0, jnp.ones_like(ids0))["params"])
    tmodel = LMWithILQLHeads(LMConfig.from_dict(ARCH), two_qs=True, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tmodel))
    tmodel.requires_grad_(False)
    return jmodel, params, tmodel


def test_ilql_heads_shapes():
    """Shapes of the JAX test, and the values of every output (logits, both
    Q heads at the actions, V at the states, the hidden states, the fused
    AWAC logprobs) against the JAX model within 1e-5."""
    jmodel, params, tmodel = _jax_ilql_pair()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, size=(2, 8)).astype(np.int32)
    mask = np.ones((2, 8), dtype=np.int32)
    mask[1, :2] = 0
    aix = np.tile(np.arange(7)[None], (2, 1)).astype(np.int32)
    six = np.tile(np.arange(8)[None], (2, 1)).astype(np.int32)
    out = tmodel(torch.from_numpy(ids), torch.from_numpy(mask), states_ixs=torch.from_numpy(six),
                 actions_ixs=torch.from_numpy(aix))
    assert out["qs"][0].shape == out["qs"][1].shape == (2, 7, V)
    assert out["vs"].shape == (2, 8)
    jout = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), states_ixs=jnp.asarray(six),
                        actions_ixs=jnp.asarray(aix))
    for key in ("logits", "vs", "hidden"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(jout[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    for q, jq in zip(out["qs"], jout["qs"]):
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
    labels, lmask = ids[:, 1:], mask[:, 1:]
    lp = tmodel(torch.from_numpy(ids), torch.from_numpy(mask), labels=torch.from_numpy(labels),
                labels_mask=torch.from_numpy(lmask), compute_q_heads=False)
    assert lp["qs"] is None and lp["logits"] is None
    jlp = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), labels=jnp.asarray(labels),
                       labels_mask=jnp.asarray(lmask), compute_q_heads=False)
    np.testing.assert_allclose(lp["logprobs"].detach().numpy(), np.asarray(jlp["logprobs"]), rtol=1e-5, atol=1e-5)


def test_tuple_carry_matches_jax_sampler():
    """Both Q heads' last-position values carried as a tuple through the
    port's sampler, read by an advantage-steered processor (ILQL's: log
    softmax + beta * (min(Q1, Q2) - V), top-k) and by the step stats,
    against the JAX sampler on the same weights, greedy: tokens and masks
    equal, the stats within 1e-4."""
    jmodel, params, tmodel = _jax_ilql_pair(seed=1)
    rng = np.random.default_rng(3)
    B, P, N = 3, 6, 5
    ids = rng.integers(1, V, size=(B, P)).astype(np.int32)
    pmask = np.ones((B, P), dtype=np.int32)
    pmask[2, :3] = 0
    ids[2, :3] = 0
    gen_kwargs = dict(max_new_tokens=N, do_sample=False)
    beta, k = 3.0, 6

    def jproc(logits, st):
        qs, vs = st["carry"]["qs"], st["carry"]["vs"]
        adv = jnp.minimum(qs[0], qs[1]) - vs[..., None]
        return jnp.maximum(jax_topk_mask(jax.nn.log_softmax(logits, -1) + beta * adv, k), -1e9)

    def tproc(logits, st):
        qs, vs = st["carry"]["qs"], st["carry"]["vs"]
        adv = torch.minimum(qs[0], qs[1]) - vs[..., None]
        return torch.clamp(topk_mask(torch.log_softmax(logits, -1) + beta * adv, k), min=-1e9)

    def jstats(tok, st):
        q = jnp.minimum(*st["carry"]["qs"])
        return {"q": jnp.take_along_axis(q, tok[:, None].astype(jnp.int32), -1)[:, 0], "v": st["carry"]["vs"]}

    def tstats(tok, st):
        q = torch.minimum(*st["carry"]["qs"])
        return {"q": torch.gather(q, -1, tok[:, None].long())[:, 0], "v": st["carry"]["vs"]}

    jfn = jax_make_generate_fn(jmodel, JaxGenerateConfig.from_gen_kwargs(gen_kwargs, prompt_len=P), jproc,
                               carry_keys=("qs", "vs"), step_stats_fn=jstats)
    jt, jm, js = jfn({"params": params}, jnp.asarray(ids), jnp.asarray(pmask), jax.random.PRNGKey(0))
    tfn = make_generate_fn(tmodel, GenerateConfig.from_gen_kwargs(gen_kwargs, prompt_len=P), tproc,
                           carry_keys=("qs", "vs"), step_stats_fn=tstats)
    for _ in range(2):  # the second call reuses the static buffers, the tuple included
        tt, tm, ts = tfn(torch.from_numpy(ids), torch.from_numpy(pmask), None)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        for key in ("q", "v"):
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), rtol=1e-4, atol=1e-4, err_msg=key)


# ------------------------------------------------------- orchestrator, store


def _trainer_config(tmp_path, kernels: bool = False, **train):
    extra = {"lm_head_bias": True}
    arch = dict(ARCH, extra=extra, eos_token_id=0)
    arch.pop("dtype"), arch.pop("param_dtype")
    if kernels:
        arch["attn_impl"] = "flash"
        extra["fused_logprob"] = "force"
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ilql", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32", remat=kernels),
        "train": dict(dict(total_steps=4, seq_length=T, epochs=2, batch_size=8, lr_ramp_steps=2, lr_decay_steps=12,
                           weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4,
                           checkpoint_interval=10**6, eval_interval=100, checkpoint_dir=str(tmp_path), seed=11,
                           orchestrator="OfflineOrchestrator"), **train),
        "method": dict(name="ilqlconfig", tau=0.7, gamma=0.99, cql_scale=0.1, awac_scale=1.0, alpha=0.1,
                       steps_for_target_q_sync=1, betas=[2.0], two_qs=True,
                       gen_kwargs=dict(prompt_length=5, max_new_tokens=6, top_k=8, do_sample=False)),
    }


def _samples(n=16, seed=0):
    rng = np.random.default_rng(seed)
    samples = [rng.integers(1, V, size=int(rng.integers(3, T + 4))).astype(np.int32) for _ in range(n)]
    rewards = rng.normal(size=(n,)).astype(np.float32).tolist()
    return samples, rewards


def test_offline_orchestrator_degenerate_samples(tmp_path):
    """Prompt-only and over-truncated samples build a store (empty action
    rows are padded no-ops) equal, array for array, to the JAX package's
    for the same samples; a text sample on a trainer without a tokenizer
    raises ValueError naming the tokenizer (text mode needs one)."""
    samples = [np.asarray([3]), np.arange(1, T + 5) % V, np.asarray([4, 5, 6]), np.asarray([], dtype=np.int32)]
    rewards = [0.5, 1.0, -1.0, 2.0]
    config = TRLConfig.from_dict(_trainer_config(tmp_path))
    model = ILQLTrainer(config, device="cpu")
    with pytest.warns(UserWarning, match="no continuation tokens"):
        OfflineOrchestrator(model).make_experience(samples, rewards)
    assert len(model.store) == 4
    from trlx_tpu.orchestrator.offline_orchestrator import OfflineOrchestrator as JaxOfflineOrchestrator

    jmodel = JaxILQLTrainer(JaxTRLConfig.from_dict(_trainer_config(tmp_path)))
    with pytest.warns(UserWarning):
        JaxOfflineOrchestrator(jmodel).make_experience(samples, rewards)
    for key in ("input_ids", "attention_mask", "rewards", "states_ixs", "actions_ixs", "dones"):
        np.testing.assert_allclose(getattr(model.store, key), getattr(jmodel.store, key), rtol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="text samples need a tokenizer"):
        OfflineOrchestrator(model).make_experience(["a walk"], [1.0])


def test_storage_loader_order_matches_jax():
    """The store's shuffled loader yields the JAX store's batches, in the
    same order, from the same seed."""
    samples, rewards = _samples(n=10, seed=4)
    args = ([s for s in samples], [np.ones(len(s), dtype=np.int32) for s in samples],
            [np.full(max(len(s) - 1, 0), r, dtype=np.float32) for s, r in zip(samples, rewards)],
            [np.arange(len(s)) for s in samples], [np.arange(max(len(s) - 1, 0)) for s in samples],
            [np.ones(len(s), dtype=np.int32) for s in samples])
    ours = ILQLRolloutStorage(*args, seq_length=T).create_loader(3, shuffle=True, seed=7)
    theirs = JaxILQLRolloutStorage(*args, seq_length=T).create_loader(3, shuffle=True, seed=7)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("input_ids", "attention_mask", "rewards", "states_ixs", "actions_ixs", "dones"):
            np.testing.assert_array_equal(getattr(g, key), np.asarray(getattr(w, key)), err_msg=key)


# ------------------------------------------------------------ whole slice


_JAX_INIT = {}


@register_model("ILQLFromJaxInit")
class _ILQLFromJaxInit(ILQLTrainer):
    """The port's ILQL trainer starting from the JAX trainer's initial
    parameters and target heads."""

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        self.load_params(params_from_jax(_JAX_INIT["params"], self.model),
                         params_from_jax(_JAX_INIT["extras"], self.model))


def _step_stats(path):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "losses/loss" in rec:
                out[rec["step"]] = rec
    return out


STAT_KEYS = ("losses/loss", "losses/loss_q", "losses/loss_v", "losses/loss_cql", "losses/loss_awac", "grad_norm",
             "learning_rate")


@pytest.mark.parametrize("kernels", [False, True], ids=["dense", "kernel-route"])
def test_train_matches_jax(tmp_path, kernels):
    samples, rewards = _samples()
    rng = np.random.default_rng(9)
    logit_mask = rng.random((V, V)) < 0.3  # forbid ~30% of the transitions
    eval_prompts = [rng.integers(1, V, size=int(rng.integers(1, 6))).tolist() for _ in range(6)]
    runs = {}
    for name in ("jax", "torch"):
        cfg = _trainer_config(tmp_path / name, kernels)
        evals = []

        def metric_fn(samples_):
            evals.append([np.asarray(s).astype(np.int64).tolist() for s in samples_])
            return {"length": [float(len(s)) for s in samples_]}

        if name == "jax":
            init = JaxILQLTrainer(JaxTRLConfig.from_dict(cfg))
            _JAX_INIT["params"] = jax.device_get(init.state.params)
            _JAX_INIT["extras"] = jax.device_get(init.state.extras)
            del init
            model = trlx_tpu.train(dataset=(samples, rewards), eval_prompts=eval_prompts, metric_fn=metric_fn,
                                   config=JaxTRLConfig.from_dict(cfg), logit_mask=logit_mask)
            heads = jax.device_get(model.state.params)
            heads = {**params_from_jax({k: heads[k] for k in ("q1_head", "q2_head")}),
                     **{f"target.{k}": v for k, v in params_from_jax(jax.device_get(model.state.extras)).items()}}
        else:
            cfg["model"]["model_type"] = "ILQLFromJaxInit"
            model = trlx_tpu_torch.train(dataset=(samples, rewards), eval_prompts=eval_prompts, metric_fn=metric_fn,
                                         config=TRLConfig.from_dict(cfg), logit_mask=logit_mask, device="cpu")
            own = dict(model.model.named_parameters())
            heads = {**{k: own[k].detach() for k in own if k.startswith(("q1_head.", "q2_head."))},
                     **{f"target.{k}": v for k, v in model.extras.items()}}
        runs[name] = (model, _step_stats(os.path.join(tmp_path, name, "metrics.jsonl")), heads, evals)

    (jm, js, jh, je), (tm, ts, th, te) = runs["jax"], runs["torch"]
    assert tm.iter_count == jm.iter_count == 4
    assert sorted(ts) == sorted(js) == [1, 2, 3, 4]
    for step in range(1, 5):
        tol = 1e-5 if step == 1 else 2e-4
        for k in STAT_KEYS:
            np.testing.assert_allclose(ts[step][k], js[step][k], rtol=tol, atol=tol, err_msg=f"step {step} {k}")
        assert ts[step]["resilience/nonfinite"] == 0.0
    assert sorted(th) == sorted(jh) and len(th) == 16
    for k in th:
        np.testing.assert_allclose(np.asarray(th[k]), np.asarray(jh[k]), rtol=2e-4, atol=2e-4, err_msg=k)
    start = params_from_jax(_JAX_INIT["extras"])
    assert not np.allclose(np.asarray(th["target.q1_head.layers_1.kernel"]),
                           start["q1_head.layers_1.kernel"].numpy()), "the target heads never moved"
    assert len(te) == len(je) == 1 and len(te[0]) == len(eval_prompts)
    assert te == je


def test_decode_weight_quant_is_accepted_and_ignored(tmp_path):
    """``model.decode_weight_quant`` on an ILQL config trains as the JAX
    ILQL trainer does, which never reads the knob: the same step stats, bit
    for bit, as with the knob off, and no int8 copies are made."""
    samples, rewards = _samples()
    stats = {}
    for quant in (False, True):
        cfg = _trainer_config(tmp_path / str(quant), total_steps=2)
        cfg["model"]["decode_weight_quant"] = quant
        model = trlx_tpu_torch.train(dataset=(samples, rewards), eval_prompts=[[1, 2]], config=TRLConfig.from_dict(cfg),
                                     device="cpu")
        assert not any(getattr(m, "w8", None) is not None for m in model.model.modules())
        stats[quant] = _step_stats(os.path.join(tmp_path, str(quant), "metrics.jsonl"))
    assert sorted(stats[True]) == sorted(stats[False]) == [1, 2]
    for step in (1, 2):
        for k in STAT_KEYS:
            assert stats[True][step][k] == stats[False][step][k], (step, k)


def test_fleet_knobs_are_ignored_as_in_jax(tmp_path, monkeypatch):
    """The fleet is PPO's: an ILQL config with ``train.fleet_*`` set (and the
    role's environment switch) trains in both packages as it does without
    them. The JAX ILQL trainer never reads the knobs; the port's trains the
    same steps as the JAX one (the twin's tolerances) and as its own run
    without the knobs (bit for bit), and neither makes a fleet directory."""
    samples, rewards = _samples()
    fleet = dict(fleet_role="rollout", fleet_dir=str(tmp_path / "fleet"), fleet_episode_timeout=5.0)
    monkeypatch.setenv("TRLX_TPU_FLEET_ROLE", "rollout")
    stats = {}
    for name in ("jax", "torch", "torch-plain"):
        cfg = _trainer_config(tmp_path / name, total_steps=2, **({} if name == "torch-plain" else fleet))
        if name == "jax":
            init = JaxILQLTrainer(JaxTRLConfig.from_dict(cfg))
            _JAX_INIT["params"] = jax.device_get(init.state.params)
            _JAX_INIT["extras"] = jax.device_get(init.state.extras)
            del init
            trlx_tpu.train(dataset=(samples, rewards), eval_prompts=[[1, 2]], config=JaxTRLConfig.from_dict(cfg))
        else:
            cfg["model"]["model_type"] = "ILQLFromJaxInit"
            model = trlx_tpu_torch.train(dataset=(samples, rewards), eval_prompts=[[1, 2]],
                                         config=TRLConfig.from_dict(cfg), device="cpu")
            assert model.iter_count == 2 and not hasattr(model, "fleet_role")
        stats[name] = _step_stats(os.path.join(tmp_path, name, "metrics.jsonl"))
    assert not os.path.exists(tmp_path / "fleet")
    assert sorted(stats["torch"]) == sorted(stats["jax"]) == sorted(stats["torch-plain"]) == [1, 2]
    for step in (1, 2):
        tol = 1e-5 if step == 1 else 2e-4
        for k in STAT_KEYS:
            np.testing.assert_allclose(stats["torch"][step][k], stats["jax"][step][k], rtol=tol, atol=tol,
                                       err_msg=f"step {step} {k}")
            assert stats["torch"][step][k] == stats["torch-plain"][step][k], (step, k)


# --------------------------------------------------------------- learning


@pytest.mark.slow
def test_ilql_learns_randomwalks(tmp_path):
    """Learning-quality gate, the torch twin of the JAX package's: ILQL on
    the offline dataset of the port's randomwalks example
    (``trlx_tpu_torch.examples.randomwalks``) beats the random-walk baseline
    (~0.55 optimality) by a clear margin, with the example config and the
    JAX test's sizes."""
    from trlx_tpu_torch.examples.randomwalks import base_config, main

    n_nodes, max_length = 21, 10
    config = base_config("ilql", n_nodes, max_length)
    config.train.total_steps = 100
    config.train.eval_interval = 25
    config.train.checkpoint_interval = 10**6
    config.train.checkpoint_dir = str(tmp_path)
    config.train.batch_size = 48

    history = []

    def recording(metric_fn):
        def recording_metric(samples):
            m = metric_fn(samples)
            history.append(float(np.mean(m["optimality"])))
            return m
        return recording_metric

    main("ilql", device="cpu", config=config, metric_fn=recording)
    assert history, "evaluate() never ran"
    assert max(history) >= 0.70, f"ILQL failed to learn: optimality history {history}"
