"""The port's side of the dp / fsdp / tp tests (``tests/test_torch_dist.py``,
``tests/test_torch_dist_resilience.py``): one function a case, run as one
rank of a gloo group by ``tests/torch_sp_worker.py dist`` (or in the pytest
process on an unsplit mesh). Imports torch and the port only; the JAX side
is computed by the tests and handed over in the case's data."""

import os

import numpy as np
import torch

import trlx_tpu_torch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.heads import LMWithValueHead
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.models.lm import LMConfig, gather_tensor, shard_tensor
from trlx_tpu_torch.ops.generate import make_generate_fn
from trlx_tpu_torch.ops.modeling import set_loss_group
from trlx_tpu_torch.ops.rl_losses import ppo_loss
from trlx_tpu_torch.ops.sampling import GenerateConfig
from trlx_tpu_torch.parallel import collectives as coll
from trlx_tpu_torch.parallel.mesh import is_main_process, make_mesh, set_mesh
from trlx_tpu_torch.trainer import get_model, register_model
from trlx_tpu_torch.trainer.base import reduce_gradients
from trlx_tpu_torch.trainer.ilql import ILQLTrainer
from trlx_tpu_torch.trainer.ppo import PPOTrainer

import torch_sp_train_case as sp_case

_INIT = {}


@register_model("PPOFromGivenWhole")
class PPOFromGivenWhole(PPOTrainer):
    """PPO from given whole parameters and reference (the JAX trainer's
    initial ones, a Flax tree): each rank keeps its pieces."""

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        if _INIT:
            self.load_params(params_from_jax(_INIT["params"], self.model),
                             params_from_jax(_INIT["extras"], self.model))


@register_model("ILQLFromGivenWhole")
class ILQLFromGivenWhole(ILQLTrainer):
    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        if _INIT.get("ilql"):
            self.load_params(params_from_jax(_INIT["ilql"]["params"], self.model),
                             params_from_jax(_INIT["ilql"]["extras"], self.model))


def _mesh(shape):
    mesh = make_mesh(tuple(shape))
    set_mesh(mesh)
    return mesh


def _whole(model, named):
    return {n: gather_tensor(model, n, t.detach()).numpy().copy() for n, t in named.items()}


def _sharded_model(arch, shape, whole_params, cls=LMWithValueHead, **kw):
    cfg = LMConfig(**arch).with_mesh(tp=shape[2], fsdp=shape[1])
    model = cls(cfg, device="cpu", **kw)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(shard_tensor(model, n, torch.as_tensor(np.asarray(whole_params[n]))))
    return model


def _rows(mesh, x):
    b = x.shape[0] // mesh.data_size
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


def case_grad(d):
    """test_mesh.py's sharded train step: loss = mean(logits²) + mean(values²)
    over the global batch, its gradients gathered whole."""
    mesh = _mesh(d["shape"])
    model = _sharded_model(d["arch"], d["shape"], d["params"])
    ids, mask = torch.as_tensor(_rows(mesh, d["ids"])), torch.as_tensor(_rows(mesh, d["mask"]))
    B, T = d["ids"].shape
    out = model(ids, mask)
    V = out["logits"].shape[-1]
    loss = (out["logits"].float() ** 2).sum() / (B * T * V) + (out["values"] ** 2).sum() / (B * T)
    loss.backward()
    names = [n for n, _ in model.named_parameters()]
    grads = reduce_gradients(model, mesh, names, [p.grad for _, p in model.named_parameters()])
    total = coll.all_reduce(loss.detach(), mesh.group("data"))
    whole = {n: gather_tensor(model, n, g).numpy() for n, g in zip(names, grads)}
    return {"loss": float(total), "grads": whole}


def case_forward(d):
    """Teacher-forced logits of a tp-sharded model over the whole batch."""
    _mesh(d["shape"])
    model = _sharded_model(d["arch"], d["shape"], d["params"])
    with torch.no_grad():
        out = model(torch.as_tensor(d["ids"]), torch.as_tensor(d["mask"]))
    return {"logits": out["logits"].numpy(), "values": out["values"].numpy()}


def case_generate(d):
    """Greedy decode on the sharded mesh, each data rank its rows; the rows
    gathered back in order."""
    mesh = _mesh(d["shape"])
    model = _sharded_model(d["arch"], d["shape"], d["params"])
    gcfg = GenerateConfig(max_new_tokens=d["new"], do_sample=False, eos_token_id=None, pad_token_id=0)
    gen = make_generate_fn(model, gcfg)
    toks, _ = gen(torch.as_tensor(_rows(mesh, d["ids"])), torch.as_tensor(_rows(mesh, d["mask"])), None)
    rows = coll.all_gather_object(toks.numpy(), mesh.group("data"))
    return {"tokens": np.concatenate(rows, axis=0)}


def case_uneven(d):
    """``ppo_loss`` over each data rank's rows of a batch whose valid-token
    counts differ by rank: loss, statistics and the gradient of the
    logprobs, summed over the data ranks."""
    mesh = _mesh(d["shape"])
    set_loss_group(mesh.group("data"))
    try:
        t = {k: torch.as_tensor(_rows(mesh, v)) for k, v in d["batch"].items()}
        lp = t["logprobs"].clone().requires_grad_()
        vp = t["vpred"].clone().requires_grad_()
        loss, stats = ppo_loss(lp, vp, t["old_logprobs"], t["old_values"], t["rewards"], t["mask"], **d["kw"])
        loss.backward()
        grads = [coll.all_gather_object(g.numpy(), mesh.group("data")) for g in (lp.grad, vp.grad)]
    finally:
        set_loss_group(None)
    return {"loss": float(loss), "stats": {k: float(v) for k, v in stats.items()},
            "grad_lp": np.concatenate(grads[0]), "grad_vp": np.concatenate(grads[1])}


def _train_config(d, ckpt_dir):
    cfg = {k: dict(v) for k, v in d["config"].items()}
    cfg["train"]["checkpoint_dir"] = ckpt_dir
    cfg["train"]["mesh"] = list(d["shape"])
    return cfg


def case_ppo(d):
    """PPO ``train()`` on the mesh from the given whole initial weights:
    the main process's step statistics, the whole parameters (every rank's,
    for bit-equality of the replicas) and, with ``save``, a checkpoint."""
    _INIT.clear()
    if "params" in d:
        _INIT.update(params=d["params"], extras=d["extras"])
    ckpt = os.path.join(d["dir"], d.get("name", "ppo"))
    cfg = _train_config(d, ckpt)
    cfg["model"]["model_type"] = "PPOFromGivenWhole"
    t = d["task"]
    trainer = trlx_tpu_torch.train(reward_fn=sp_case.reward_fn, prompts=t["prompts"], eval_prompts=t["eval_prompts"],
                                   config=TRLConfig.from_dict(cfg), logit_mask=t.get("logit_mask"), device="cpu")
    out = {"iter_count": trainer.iter_count, "params": _whole(trainer.model, dict(trainer.model.named_parameters())),
           "mesh": dict(trainer.mesh.shape)}
    if is_main_process():
        out["stats"] = sp_case.step_stats(os.path.join(ckpt, "metrics.jsonl"), sp_case.PPO_STAT_KEYS)
    if d.get("save"):
        trainer.save(os.path.join(d["dir"], "saved"))
        out["moments"] = _whole(trainer.model, trainer.optimizer.state_dict()["mu"])
    return out


def case_load(d):
    """A PPO trainer on this mesh restoring ``d["from"]``: its whole
    parameters, first moments and step."""
    _INIT.clear()
    cfg = _train_config(d, os.path.join(d["dir"], "load_run"))
    cfg["model"]["model_type"] = "PPOFromGivenWhole"
    trainer = get_model("PPOFromGivenWhole")(TRLConfig.from_dict(cfg), device="cpu")
    trainer.load(d["from"])
    return {"params": _whole(trainer.model, dict(trainer.model.named_parameters())),
            "moments": _whole(trainer.model, trainer.optimizer.state_dict()["mu"]), "step": trainer.step}


def case_ilql(d):
    """ILQL ``train(dataset=...)`` on the mesh from given whole weights."""
    _INIT.clear()
    if "params" in d:
        _INIT["ilql"] = {"params": d["params"], "extras": d["extras"]}
    ckpt = os.path.join(d["dir"], d.get("name", "ilql"))
    cfg = _train_config(d, ckpt)
    cfg["model"]["model_type"] = "ILQLFromGivenWhole"
    t = d["task"]
    trainer = trlx_tpu_torch.train(dataset=(t["samples"], t["rewards"]), eval_prompts=[[1], [2]],
                                   config=TRLConfig.from_dict(cfg), logit_mask=t["logit_mask"], device="cpu")
    out = {"iter_count": trainer.iter_count, "params": _whole(trainer.model, dict(trainer.model.named_parameters()))}
    if is_main_process():
        out["stats"] = sp_case.step_stats(os.path.join(ckpt, "metrics.jsonl"), sp_case.ILQL_STAT_KEYS)
    return out


def _drill_config(d, total_steps, resume):
    cfg = {k: dict(v) for k, v in d["config"].items()}
    cfg["model"]["model_type"] = "ppo"
    cfg["train"].update(
        total_steps=total_steps, epochs=100, eval_interval=10**6, checkpoint_interval=10**6,
        # log_interval huge: nothing flushes across ranks mid-drill, so the
        # first blocking op after a wedged rank is a guarded collective.
        log_interval=10**6, checkpoint_dir=d["dir"], mesh=list(d["shape"]), resume_from_checkpoint=resume,
        heartbeat_interval=0.2, collective_deadline=float(d.get("deadline", 20.0)),
        desync_check_interval=2 if d["mode"] == "desync" else 1, preempt_check_interval=1)
    return TRLConfig.from_dict(cfg)


def case_drill(d):
    """One rank of a multi-process drill (tests/test_torch_dist_resilience.py):
    each rank's faults come from its own ``TRLX_TPU_FAULTS``. Prints its
    verdict; the test reads the output and the exit code."""
    from trlx_tpu_torch.resilience import distributed as dist_res
    from trlx_tpu_torch.parallel.mesh import barrier, process_rank

    mode, rank = d["mode"], process_rank()
    t = d["task"]

    def run(total_steps, resume=False):
        return trlx_tpu_torch.train(reward_fn=sp_case.reward_fn, prompts=t["prompts"], eval_prompts=t["eval_prompts"],
                                    config=_drill_config(d, total_steps, resume), logit_mask=t["logit_mask"],
                                    device="cpu")

    if mode in ("hang", "kill"):
        run(10)
        print(f"{mode} rank {rank} FINISHED WITHOUT ABORT", flush=True)
    elif mode == "preempt":
        model = run(10)
        assert model.iter_count == 2, model.iter_count
        with open(os.path.join(d["dir"], "latest.txt")) as f:
            assert f.read().strip() == "state_2"
        states = [e for e in os.listdir(d["dir"]) if e.startswith("state_") and os.path.isdir(os.path.join(d["dir"], e))]
        assert states == ["state_2"], states
        print(f"preempt rank {rank} SAVED state_2", flush=True)
        os.environ.pop("TRLX_TPU_FAULTS", None)
        model2 = run(4, resume=True)
        assert model2._resumed and model2.iter_count == 4, model2.iter_count
        dist_res.verify_fingerprints(dist_res.host_fingerprint(model2.iter_count, model2.model, 0))
        assert all(bool(torch.isfinite(p).all()) for p in model2.model.parameters())
        print(f"preempt rank {rank} OK", flush=True)
    elif mode == "desync":
        try:
            run(10)
        except dist_res.HostDesync as e:
            assert "rank 1" in str(e) and "param replica crc32" in str(e), str(e)
            print(f"desync rank {rank} OK", flush=True)
        else:
            print(f"desync rank {rank} GUARD MISSED THE DIVERGENCE", flush=True)
    elif mode == "slow":
        model = run(3)
        barrier("drill")  # every rank has written its exit beat
        beats = dist_res.read_heartbeats(os.path.join(d["dir"], "heartbeats"))
        assert model.iter_count == 3 and sorted(beats) == [0, 1], beats
        assert all(b["phase"] == "exited" for b in beats.values()), beats
        print(f"slow rank {rank} OK", flush=True)
    return {}


def case_engine_mesh(d):
    """The rollout engine on the mesh: every rank builds the sharded model
    from the given whole weights (int8 decode copies with ``w8``), submits
    every prompt and drains greedily. Returns the episodes in completion
    order, the schedule crc and, with ``w8``, this rank's int8 copies with
    their placements."""
    from trlx_tpu_torch.engine import RolloutEngine
    from trlx_tpu_torch.models.lm import placement_of
    from trlx_tpu_torch.ops.w8a16 import quantize_weights, quantized_weights

    mesh = _mesh(d["shape"])
    model = _sharded_model(d["arch"], d["shape"], d["params"])
    model.requires_grad_(False)
    out = {"coords": dict(mesh.coords)}
    if d.get("w8"):
        quantize_weights(model)
        out["w8"] = {}
        for name, (kq, sc) in quantized_weights(model).items():
            pl = placement_of(model, name + ".kernel")
            out["w8"][name] = (kq.numpy().copy(), sc.numpy().copy(),
                               None if pl is None else dict(full_shape=pl.full_shape, fsdp_dim=pl.fsdp_dim,
                                                            tp_dim=pl.tp_dim, qkv=pl.qkv, fsdp=pl.fsdp, tp=pl.tp))
    engine = RolloutEngine(model, GenerateConfig(**d["gcfg"]), **d["engine"])
    engine.update_weights(model, version=1)
    engine.submit(d["prompts"], d["pmask"])
    episodes = []
    for _ in range(300):
        episodes.extend(engine.step())
        if engine.idle:
            break
    out["episodes"] = [(e.prompt_ids, e.prompt_mask, e.response_ids, e.response_mask) for e in episodes]
    out["crc"] = engine.schedule_fingerprint()
    engine.shutdown()
    return out


def _engine_config(d, ckpt_dir):
    cfg = _train_config(d, ckpt_dir)
    cfg["model"]["model_type"] = "PPOFromGivenWhole"
    cfg["train"].update(d.get("train", {}))
    cfg["method"].update(d.get("method", {}))
    cfg["model"].update(d.get("model", {}))
    return TRLConfig.from_dict(cfg)


def case_engine_drill(d):
    """One rank of an engine drill (tests/test_torch_dist_engine.py): PPO
    ``train()`` through the rollout engine on the mesh, graftfleet armed.
    Prints its verdict and the schedule crc of each engine phase."""
    from trlx_tpu_torch.parallel.mesh import process_rank
    from trlx_tpu_torch.resilience import distributed as dist_res

    _INIT.clear()  # the trainer's own seeded weights
    mode, rank = d["mode"], process_rank()
    t = d["task"]
    config = _engine_config(d, d["dir"])
    try:
        trainer = trlx_tpu_torch.train(reward_fn=sp_case.reward_fn, prompts=t["prompts"],
                                       eval_prompts=t["eval_prompts"], config=config, logit_mask=t.get("logit_mask"),
                                       device="cpu")
    except dist_res.HostDesync as e:
        ok = "rank 1" in str(e) and "slot schedule crc32" in str(e) and "engine slot-schedule check failed" in str(e)
        print(f"engine {mode} rank {rank} {'DESYNC NAMED' if ok else 'DESYNC UNNAMED'}: {e}", flush=True)
        return {"desync": str(e)}
    crcs = trainer.orch.schedule_crcs
    print(f"engine {mode} rank {rank} DONE crcs={crcs}", flush=True)
    return {"crcs": crcs, "iter_count": trainer.iter_count, "store": trainer.store.columns()}


def case_overlap_mesh(d):
    """``train()`` once a run of ``d["runs"]`` (method and model overrides
    each) on the mesh, from the trainer's seeded weights: serial, overlapped
    at staleness 0, at staleness 1. Returns each run's whole parameters,
    main-process statistics, recorded staleness and step count."""
    out = {}
    _INIT.clear()  # the trainer's own seeded weights
    for name, over in d["runs"].items():
        ckpt = os.path.join(d["dir"], name)
        config = _engine_config(dict(d, method=dict(d.get("method", {}), **over.get("method", {})),
                                     model=over.get("model", {})), ckpt)
        t = d["task"]
        trainer = trlx_tpu_torch.train(reward_fn=sp_case.reward_fn, prompts=t["prompts"],
                                       eval_prompts=t["eval_prompts"], config=config, logit_mask=t.get("logit_mask"),
                                       device="cpu")
        snap = trainer._snapshot_weights
        run = {"iter_count": trainer.iter_count, "params": _whole(trainer.model, dict(trainer.model.named_parameters())),
               "producer_groups": trainer.mesh.producer_groups is not None, "crcs": trainer.orch.schedule_crcs,
               "snapshot_held": 0 if snap is None else len(snap._held),
               "snapshot_w8": 0 if snap is None else len(snap._quant)}
        if is_main_process():
            run["stats"] = sp_case.step_stats(os.path.join(ckpt, "metrics.jsonl"), sp_case.PPO_STAT_KEYS)
            run["staleness"] = [r.get("staleness/max") for r in _records(os.path.join(ckpt, "metrics.jsonl"))
                                if "staleness/max" in r]
        out[name] = run
    return out


def _records(path):
    import json

    with open(path) as f:
        return [json.loads(line) for line in f]


CASES = {"drill": case_drill, "engine_mesh": case_engine_mesh, "engine_drill": case_engine_drill,
         "overlap_mesh": case_overlap_mesh, "grad": case_grad, "forward": case_forward, "generate": case_generate, "uneven": case_uneven,
         "ppo": case_ppo, "load": case_load, "ilql": case_ilql}


def dist_case(data):
    torch.set_num_threads(1)
    return CASES[data["case"]](data)
