"""``train()`` on an sp mesh, the port's side of ``tests/test_torch_sp_train.py``:
the configs, the reward, and one PPO and one ILQL run, in this process or as
one rank of a gloo group (``tests/torch_sp_worker.py train``). Imports torch
and the port only."""

import json
import os

import numpy as np
import torch

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.trainer import register_model
from trlx_tpu_torch.trainer.ppo import PPOTrainer

V, P, R = 31, 8, 8  # train sequences of P + R = 16: the zig-zag ring at sp = 2 (16 % 4 == 0)
STEPS = 2
ILQL_T = 16
PPO_STAT_KEYS = ("loss", "pg_loss", "vf_loss", "pg_clipfrac", "vf_clipfrac", "mean_kl", "mean_ratio", "mean_return",
                 "mean_advantage", "mean_entropy", "explained_variance", "grad_norm", "learning_rate")
ILQL_STAT_KEYS = ("losses/loss", "losses/loss_q", "losses/loss_v", "losses/loss_cql", "losses/loss_awac", "grad_norm",
                  "learning_rate")

_INIT = {}


@register_model("PPOFromGivenInit")
class PPOFromGivenInit(PPOTrainer):
    """The port's PPO trainer starting from given parameters and reference
    (the JAX trainer's initial ones)."""

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        self.load_params(params_from_jax(_INIT["params"], self.model), params_from_jax(_INIT["extras"], self.model))


def _arch():
    return dict(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
                extra={"lm_head_bias": True})


def ppo_config(ckpt_dir: str, mesh, remat: bool = True, arch=None):
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=2,
                      model_arch=arch or _arch(),
                      dtype="float32", param_dtype="float32", remat=remat),
        "train": dict(total_steps=STEPS, seq_length=P + R, epochs=1, batch_size=8, lr_ramp_steps=0, lr_decay_steps=12,
                      weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4,
                      checkpoint_interval=10**6, eval_interval=100, checkpoint_dir=ckpt_dir, seed=11,
                      mesh=list(mesh)),
        "method": dict(name="ppoconfig", num_rollouts=8, chunk_size=8, ppo_epochs=2, init_kl_coef=0.3, target=1.0,
                       horizon=50, vf_coef=0.5,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    }


def ilql_config(ckpt_dir: str, mesh, arch=None):
    arch = dict(arch or _arch(), eos_token_id=0)
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ilql", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32"),
        "train": dict(total_steps=3, seq_length=ILQL_T, epochs=2, batch_size=8, lr_ramp_steps=2, lr_decay_steps=12,
                      weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4,
                      checkpoint_interval=10**6, eval_interval=100, checkpoint_dir=ckpt_dir, seed=11,
                      orchestrator="OfflineOrchestrator", mesh=list(mesh)),
        "method": dict(name="ilqlconfig", tau=0.7, gamma=0.99, cql_scale=0.1, awac_scale=1.0, alpha=0.1,
                       steps_for_target_q_sync=1, betas=[2.0], two_qs=True,
                       gen_kwargs=dict(prompt_length=5, max_new_tokens=6, top_k=8, do_sample=False)),
    }


def reward_fn(samples):
    return [float(np.sum(s) % 7) - 3.0 for s in samples]


def task(seed: int = 0, vocab: int = V):
    """Prompts, eval prompts, a forced-bigram logit mask (one allowed
    successor a token), and ILQL's samples and rewards."""
    rng = np.random.default_rng(seed)
    succ = rng.permutation(vocab)
    logit_mask = np.ones((vocab, vocab), dtype=bool)
    logit_mask[np.arange(vocab), succ] = False
    prompts = [rng.integers(1, vocab, size=int(rng.integers(3, P + 1))).tolist() for _ in range(8)]
    samples = [rng.integers(1, vocab, size=int(rng.integers(3, ILQL_T + 4))).astype(np.int32) for _ in range(16)]
    rewards = rng.normal(size=(16,)).astype(np.float32).tolist()
    return dict(prompts=prompts, eval_prompts=prompts[:4], logit_mask=logit_mask, samples=samples, rewards=rewards)


def step_stats(path: str, keys):
    """{step: stats} of a run's ``metrics.jsonl``; a step logged twice (two
    writers) raises."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if keys[0] in rec:
                assert rec["step"] not in out, f"step {rec['step']} logged twice in {path}"
                out[rec["step"]] = {k: rec[k] for k in keys}
    return out


def _params(trainer):
    return {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}


def run_ppo(data, ckpt_dir: str, mesh_shape, mesh=None):
    """PPO ``train()`` from ``data``'s initial parameters: (step stats of the
    main process, final parameters, iter_count)."""
    _INIT["params"], _INIT["extras"] = data["params"], data["extras"]
    cfg = ppo_config(ckpt_dir, mesh_shape)
    cfg["model"]["model_type"] = "PPOFromGivenInit"
    t = data["task"]
    if mesh is None:
        trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=t["prompts"], eval_prompts=t["eval_prompts"],
                                       config=TRLConfig.from_dict(cfg), logit_mask=t["logit_mask"], device="cpu")
    else:
        trainer = _train_on_mesh(cfg, t, mesh)
    stats = step_stats(os.path.join(ckpt_dir, "metrics.jsonl"), PPO_STAT_KEYS)
    return {"stats": stats, "params": _params(trainer), "iter_count": trainer.iter_count}


def _train_on_mesh(cfg, t, mesh):
    """``train()``'s PPO dispatch with a prebuilt mesh handed to the
    trainer (a ``LocalSpGroup`` mesh is never built from a config)."""
    from trlx_tpu_torch.trainer import get_model

    base = get_model(cfg["model"]["model_type"])
    name = f"{base.__name__}OnMesh"
    register_model(name)(type(name, (base,), {"__init__": lambda self, c, **kw: base.__init__(self, c, mesh=mesh,
                                                                                              **kw)}))
    cfg["model"]["model_type"] = name
    return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=t["prompts"], eval_prompts=t["eval_prompts"],
                                config=TRLConfig.from_dict(cfg), logit_mask=t["logit_mask"], device="cpu")


def run_ilql(data, ckpt_dir: str, mesh_shape):
    cfg = ilql_config(ckpt_dir, mesh_shape)
    t = data["task"]
    trainer = trlx_tpu_torch.train(dataset=(t["samples"], t["rewards"]), eval_prompts=[[1], [2]],
                                   config=TRLConfig.from_dict(cfg), logit_mask=t["logit_mask"], device="cpu")
    stats = step_stats(os.path.join(ckpt_dir, "metrics.jsonl"), ILQL_STAT_KEYS)
    return {"stats": stats, "params": _params(trainer), "iter_count": trainer.iter_count}


def train_case(data):
    """One rank of the gloo run: PPO, then ILQL, on train.mesh [1, 1, 1, world]."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    n = dist.get_world_size()
    root = data["dir"]
    return {"ppo": run_ppo(data, os.path.join(root, f"ppo_sp{n}"), (1, 1, 1, n)),
            "ilql": run_ilql(data, os.path.join(root, f"ilql_sp{n}"), (1, 1, 1, n))}
