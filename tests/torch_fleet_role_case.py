"""One process of a port fleet whose roles may be worlds of several
processes, run by ``tests/test_torch_fleet_role.py`` (not collected)::

    python tests/torch_fleet_role_case.py ROLE CKPT FLEET_DIR RANK WORLD INIT_FILE MESH INIT_WEIGHTS

ROLE is ``rollout`` or ``learner``; a WORLD above 1 joins a gloo group
through the ``file://`` store INIT_FILE as rank RANK, with ``train.mesh``
MESH (e.g. ``2,1,1,1``: dp 2; ``1,2,1,1``: fsdp 2). The forced-bigram PPO
task of ``tests/test_torch_numerics.py`` (each token has one allowed
successor, so the sampled tokens do not depend on the batch a rank
decodes) at 2 layers and d 32, through the rollout engine, from the whole
initial weights in INIT_WEIGHTS (``torch.save`` of {"params", "extras"}).
Environment: STALENESS, GRAFTFLEET, INFLIGHT (in-flight weight pushes),
TOTAL / EPOCHS (steps), REWARD_SLEEP (seconds a reward call), KNOBS (a JSON
object of ``train``'s fleet timing), STALL_LEAD (seconds a learner's rank 0
hangs, alive, where it waits for the next batch) and the role's
``TRLX_TPU_FAULTS`` (torchrun's ``LOCAL_WORLD_SIZE`` and ``GROUP_RANK``
simulate nodes). The learner's rank 0 writes
``CKPT/final.pt`` (the whole trained parameters); a rollout rank writes each
phase's store as ``CKPT/rank<r>_phase<k>.npz``; every process prints
``THREADS [...]`` (the trlx-* threads still alive) and ``DONE``.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import trlx_tpu_torch  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.trainer import register_model  # noqa: E402
from trlx_tpu_torch.trainer.ppo import PPOTrainer  # noqa: E402

V, P, R = 31, 10, 6
_INIT = {}


@register_model("PPOFleetRoleInit")
class PPOFleetRoleInit(PPOTrainer):
    """PPO from the given whole initial weights (each rank keeps its pieces)."""

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        self.load_params(_INIT["params"], _INIT["extras"])


def bigram_task(reward_sleep: float = 0.0):
    """(logit_mask, prompts, reward_fn) of the forced-bigram task."""
    rng = np.random.default_rng(0)
    succ = rng.permutation(V)
    logit_mask = np.ones((V, V), dtype=bool)
    logit_mask[np.arange(V), succ] = False
    prompts = [rng.integers(1, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(16)]

    def reward_fn(samples):
        time.sleep(reward_sleep)
        return [float(np.sum(s) % 7) - 3.0 for s in samples]

    return logit_mask, prompts, reward_fn


def role_config(ckpt, fleet_dir=None, **kw):
    """The task's port config (``role_dict``)."""
    return TRLConfig.from_dict(role_dict(ckpt, fleet_dir, **kw))


def role_dict(ckpt, fleet_dir=None, mesh=(1, 1, 1, 1), staleness=0, graftfleet=False, model_type="PPOFleetRoleInit",
              inflight=False, total_steps=8, epochs=4, knobs=None):
    """The task's config as a dict (the JAX package reads it too); without
    ``fleet_dir`` the fleet is off (the initial weights' trainer).
    ``knobs`` overrides ``train``'s fleet timing."""
    arch = dict(vocab_size=V, n_layer=2, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
                extra={"lm_head_bias": True})
    fleet_train = {} if fleet_dir is None else {
        **dict(fleet_dir=str(fleet_dir), heartbeat_interval=0.2, fleet_episode_timeout=5.0, fleet_stream_retries=2,
               fleet_stream_backoff=0.2, fleet_heartbeat_timeout=30.0, fleet_broadcast_deadline=120.0),
        **(knobs or {})}
    return {
        "model": dict(model_path="", tokenizer_path="", model_type=model_type, num_layers_unfrozen=1,
                      model_arch=arch, dtype="float32", param_dtype="float32"),
        "train": dict(total_steps=int(total_steps), seq_length=P + R, epochs=int(epochs), batch_size=8, lr_ramp_steps=2, lr_decay_steps=12,
                      weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4,
                      checkpoint_interval=10**6, eval_interval=100, checkpoint_dir=str(ckpt), seed=11,
                      mesh=list(mesh), graftfleet=bool(graftfleet), **fleet_train),
        "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=2, init_kl_coef=0.3, target=1.0,
                       horizon=50, vf_coef=0.5, rollout_engine=True, engine_steps_per_sync=2,
                       fleet_disaggregate=fleet_dir is not None, max_staleness=int(staleness),
                       fleet_inflight_weights=bool(inflight),
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    }


def main():
    role, ckpt, fleet_dir, rank, world, init_file, mesh, init_weights = sys.argv[1:9]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    os.makedirs(ckpt, exist_ok=True)
    if world > 1:
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    _INIT.update(torch.load(init_weights, weights_only=False))
    os.environ["TRLX_TPU_FLEET_ROLE"] = role
    env = os.environ
    logit_mask, prompts, reward_fn = bigram_task(float(env.get("REWARD_SLEEP", "0")))
    config = role_config(ckpt, fleet_dir, mesh=[int(x) for x in mesh.split(",")],
                         staleness=int(env.get("STALENESS", "0")), graftfleet=bool(int(env.get("GRAFTFLEET", "0"))),
                         inflight=bool(int(env.get("INFLIGHT", "0"))), total_steps=int(env.get("TOTAL", "8")),
                         epochs=int(env.get("EPOCHS", "4")), knobs=json.loads(env.get("KNOBS", "{}")))
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator

    make, phases = PPOOrchestrator.make_experience, []

    def recorded(self, num_rollouts=1024, iter_count=0, store=None, **kw):
        out = make(self, num_rollouts, iter_count, store=store, **kw)
        if out is not None and store is not None:
            np.savez(os.path.join(ckpt, f"rank{rank}_phase{len(phases)}.npz"), **store.columns())
            phases.append(len(store))
        return out

    PPOOrchestrator.make_experience = recorded
    if role == "learner" and rank == 0 and float(env.get("STALL_LEAD", "0")):
        from trlx_tpu_torch.fleet.runner import FleetLearnerFeed

        FleetLearnerFeed._next_columns = lambda self: time.sleep(float(env["STALL_LEAD"]))
    model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:4], config=config,
                                 logit_mask=logit_mask, device="cpu")
    if role == "learner":
        whole = {n: t.numpy().copy() for n, t in model.full_params().items()}
        if rank == 0:
            torch.save(whole, os.path.join(ckpt, "final.pt"))
    print("THREADS", json.dumps([t.name for t in threading.enumerate() if t.name.startswith("trlx-")]))
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
