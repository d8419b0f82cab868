"""The trainer base (the counterpart of ``trlx_tpu.trainer.base``): the
learning-rate schedule, the optimizer, evaluation and the ``learn()`` loop,
plus what every trainer shares on the rollout side.

A trainer owns one device, the model and its parameters, the seeded
generators, the optimizer state (its step counts and moments), the
consecutive-skip count of the non-finite guard, and the host hooks
(``reward_fn``, ``metric_fn``, ``logit_mask``). There is one device and no
mesh: ``train.mesh`` is read by the JAX package only. Prompts are token ids:
loading a tokenizer is not ported yet, so ``model.tokenizer_path`` must be
empty. Checkpointing (save, load, resume) is not ported either; every knob
whose feature is missing is refused by ``refuse_unported``.
"""

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import PPOConfig
from trlx_tpu_torch.device import resolve_device
from trlx_tpu_torch.resilience.guard import check_bad_steps, guarded_update
from trlx_tpu_torch.trainer import intervals
from trlx_tpu_torch.utils.logging import Tracker


def lr_schedule(train_cfg) -> Callable[[int], float]:
    """Linear warmup from 0 over ``lr_ramp_steps``, then cosine decay from
    ``learning_rate_init`` to ``learning_rate_target`` over
    ``lr_decay_steps`` (optax's ``join_schedules`` of a linear and a cosine
    schedule, written out)."""
    init, target = float(train_cfg.learning_rate_init), float(train_cfg.learning_rate_target)
    decay_steps = max(train_cfg.lr_decay_steps, 1)
    alpha = target / max(init, 1e-12)
    ramp = int(train_cfg.lr_ramp_steps)

    def cosine(count: int) -> float:
        count = min(count, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * decay + alpha)

    def schedule(count: int) -> float:
        if ramp > 0:
            if count < ramp:
                frac = 1 - min(max(count, 0), ramp) / ramp
                return (0.0 - init) * frac + init
            return cosine(count - ramp)
        return cosine(count)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (0-dim)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class ClippedAdamW:
    """Global-norm clip, then AdamW with a schedule: optax's
    ``chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    weight_decay=wd))`` over the trainable parameters, written out.

    - The clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
      (no ``+1e-6``, unlike ``torch.nn.utils.clip_grad_norm_``).
    - Adam: eps 1e-8 outside the square root, bias correction by the applied
      step count; decoupled weight decay on every trainable parameter, then
      ``-schedule(k)`` times the update, where k counts APPLIED updates (a
      skipped step does not advance it).

    Moments are kept in the parameters' dtype (f32 masters) and updated in
    place; ``step`` clips the gradients it is given in place."""

    def __init__(self, params: List[torch.Tensor], schedule: Callable[[int], float], b1: float, b2: float,
                 weight_decay: float, max_norm: float, eps: float = 1e-8):
        self.schedule = schedule
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay, self.max_norm = float(weight_decay), float(max_norm)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0  # applied updates: Adam's bias-correction count and the schedule's

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        norm = global_norm(grads)
        clip = norm >= self.max_norm
        for g in grads:  # clipped in place: no second copy of every gradient at once
            g.copy_(torch.where(clip, g / norm * self.max_norm, g))
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)


def build_optimizer(train_cfg, params: List[torch.Tensor]):
    """(optimizer, schedule): global-norm clip then AdamW over ``params``
    (the trainable parameters only; frozen ones get no moments)."""
    schedule = lr_schedule(train_cfg)
    opt = ClippedAdamW(params, schedule, train_cfg.opt_betas[0], train_cfg.opt_betas[1],
                       train_cfg.weight_decay, train_cfg.grad_clip)
    return opt, schedule


def refuse_unported(config: TRLConfig):
    """Raise on every knob whose feature is not ported yet, so no config
    silently runs a different algorithm, or records less, than it asks
    for. The one list of such knobs: those every trainer shares, then the
    PPO method's own (a method config without them has none to refuse)."""
    m, mc, t = config.method, config.model, config.train
    unported = {
        "model.decode_weight_quant": mc.decode_weight_quant,
        # checkpointing and resume
        "train.resume_from_checkpoint": t.resume_from_checkpoint,
        "train.keep_checkpoints": t.keep_checkpoints > 0,
        # resilience beyond the non-finite guard
        "train.watchdog_threshold": t.watchdog_threshold > 0,
        "train.fault_plan": bool(t.fault_plan),
        "train.reward_fn_timeout": t.reward_fn_timeout > 0,
        "train.heartbeat_interval": t.heartbeat_interval > 0,
        "train.collective_deadline": t.collective_deadline > 0,
        "train.desync_check_interval": t.desync_check_interval > 0,
        "train.preempt_check_interval": t.preempt_check_interval > 0,
        "train.fleet_role": bool(t.fleet_role),
        "train.fleet_dir": bool(t.fleet_dir),
        # profiling and observability
        "train.profile_dir": bool(t.profile_dir),
        "train.watch_interval": t.watch_interval > 0,
        "train.trace_spans": t.trace_spans,
        "train.device_telemetry": t.device_telemetry,
        "train.anomaly_factor": t.anomaly_factor > 0,
        "train.health_monitor": t.health_monitor,
        "train.metrics_port": t.metrics_port > 0,
        "train.graftscope": t.graftscope,
        "train.graftfleet": t.graftfleet,
        "train.fleet_resync_interval": t.fleet_resync_interval > 0,
        "train.graftnum": t.graftnum,
    }
    if isinstance(m, PPOConfig):
        unported.update({
            "method.spec_decode": bool(m.spec_decode),
            "method.rollout_overlap": m.rollout_overlap,
            "method.max_staleness": m.max_staleness > 0,
            "method.pack_train_batch": m.pack_train_batch,
            "method.fleet_disaggregate": m.fleet_disaggregate,
            "method.fleet_elastic": m.fleet_elastic,
            "method.gen_kwargs.prompt_buckets": bool(m.gen_kwargs.get("prompt_buckets")),
            "model.reward_model": mc.has_reward_model,
        })
    on = [k for k, v in unported.items() if v]
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)}")


class BaseTrainer:
    def __init__(self, config: TRLConfig, device: Optional[Union[str, torch.device]] = None, **kwargs):
        self.config = config
        self.device = resolve_device(device)
        if config.model.tokenizer_path:
            raise NotImplementedError(
                "tokenizers are not ported yet: set model.tokenizer_path to '' and pass token-id prompts"
            )
        refuse_unported(config)
        self.tokenizer = None
        self.reward_fn = kwargs.pop("reward_fn", None)
        self.metric_fn = kwargs.pop("metric_fn", None)
        self.logit_mask = kwargs.pop("logit_mask", None)
        if kwargs:
            raise TypeError(f"unexpected trainer arguments: {sorted(kwargs)}")
        self.orch = None
        self.iter_count = 0
        self._tracker = None

    @property
    def tracker(self) -> Tracker:
        """The run's tracker (``<train.checkpoint_dir>/metrics.jsonl``),
        opened at first use."""
        if self._tracker is None:
            self._tracker = Tracker(self.config.train.checkpoint_dir, config=self.config.to_dict())
        return self._tracker

    def seeded_generator(self, *key: int) -> torch.Generator:
        """A generator on the trainer's device seeded from (train.seed,
        *key) through numpy's SeedSequence, so distinct keys give unrelated
        streams."""
        seed = np.random.SeedSequence([int(self.config.train.seed), *[int(k) for k in key]])
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        return g

    def chunk_rng(self, chunk: int) -> torch.Generator:
        """Sampling generator for absolute prompt chunk ``chunk``: a pure
        function of (train.seed, chunk), so chunk c samples the same tokens
        whatever was drawn before it."""
        return self.seeded_generator(0, chunk)

    def put(self, x, dtype=None) -> torch.Tensor:
        """A host array (or tensor) on the trainer's device."""
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=dtype, device=self.device)

    def put_batch(self, batch):
        """A batch dataclass of host arrays → the same dataclass of device
        tensors (the one place a train batch crosses to the device); the
        host-only ``extras`` stay behind."""
        fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
        return dataclasses.replace(
            batch, **{k: (None if k == "extras" or v is None else self.put(v)) for k, v in fields.items()}
        )

    @staticmethod
    def to_host(tree):
        """Tensors (or a tuple / list / dict of them) → numpy. Reading a CUDA
        tensor waits for the work that produces it."""
        if torch.is_tensor(tree):
            return tree.detach().cpu().numpy()
        if isinstance(tree, (tuple, list)):
            return type(tree)(BaseTrainer.to_host(t) for t in tree)
        if isinstance(tree, dict):
            return {k: BaseTrainer.to_host(v) for k, v in tree.items()}
        return tree

    def decode(self, tokens, mask=None):
        """Token grids → per-row token arrays, trimmed to the mask (the
        no-tokenizer mode of the JAX package's ``decode``)."""
        tokens = self.to_host(tokens)
        if mask is None:
            return [t for t in tokens]
        mask = self.to_host(mask)
        return [t[m.astype(bool)] for t, m in zip(tokens, mask)]

    @staticmethod
    def rollout_decode_stats(mask_h, prompt_length: int):
        """Decode-loop counts for one rollout chunk from the host mask:
        generated tokens, the decode steps the loop ran (the highest response
        position any row was live at), the step budget, and each row's
        steps."""
        resp = np.asarray(mask_h)[:, prompt_length:]
        return {
            "gen_tokens": int(resp.sum()),
            "decode_steps": int(resp.any(axis=0).sum()),
            "decode_step_budget": int(resp.shape[1]),
            "episode_steps": resp.sum(axis=1).astype(np.int64),
        }

    # ------------------------------------------------------------ training

    def intervals(self, steps: int) -> Dict[str, bool]:
        return intervals(self.config.train, steps)

    def prepare_learning(self):
        """Build the train/eval loaders; set n_updates_per_batch and
        total_steps."""
        raise NotImplementedError

    def make_extras(self) -> Dict[str, torch.Tensor]:
        """The trainer's frozen tensors beside the model (PPO: the reference;
        ILQL: the target Q heads), fresh copies of the model's."""
        raise NotImplementedError

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor], extras: Optional[Dict[str, torch.Tensor]] = None):
        """Copy a full state dict into the model (every parameter must be
        given) and set the frozen extras to ``extras``, or to a fresh
        ``make_extras()`` of the loaded parameters."""
        own = dict(self.model.named_parameters())
        missing = sorted(set(own) - set(params))
        extra = sorted(set(params) - set(own))
        if missing or extra:
            raise KeyError(f"load_params: missing {missing[:4]}, unexpected {extra[:4]}")
        for name, t in params.items():
            own[name].copy_(torch.as_tensor(t))
        if extras is None:
            self.extras = self.make_extras()
        else:
            self.extras = {
                n: torch.as_tensor(t).to(device=own[n].device, dtype=own[n].dtype).clone()
                for n, t in extras.items()
            }

    def build_train_step(self):
        """Set ``self._loss_fn(batch) -> (loss, stats)`` for this trainer's
        model and config; returns ``train_step``."""
        raise NotImplementedError

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One update on a device batch: loss, backward, the non-finite
        guard, clip + AdamW over the trainable parameters. Returns the loss
        stats plus ``grad_norm`` (before clipping), ``learning_rate`` (the
        schedule at this step) and the guard's ``resilience/*`` counters, as
        device scalars."""
        if getattr(self, "_loss_fn", None) is None:
            self.build_train_step()
        params = self.trainable
        for p in params:
            p.grad = None
        loss, stats = self._loss_fn(batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for p in params:
            p.grad = None
        stats = dict(stats)
        stats["grad_norm"] = global_norm(grads)
        if self.config.train.nonfinite_guard:
            self.bad_steps, applied = guarded_update(self.optimizer, params, grads, loss.detach(), self.bad_steps)
            stats["resilience/nonfinite"] = torch.tensor(0.0 if applied else 1.0)
            stats["resilience/bad_steps"] = torch.tensor(float(self.bad_steps))
        else:
            self.optimizer.step(params, grads)
        stats["learning_rate"] = torch.tensor(self.schedule(self.step), dtype=torch.float32)
        self.step += 1
        return stats

    def post_backward_callback(self, stats=None):
        """Called with every step's stats (device scalars)."""

    def post_epoch_callback(self):
        """Called after every epoch of the train loader."""

    def add_eval_pipeline(self, eval_pipeline):
        self.eval_pipeline = eval_pipeline

    def eval_generate(self, input_ids, attention_mask, batch_index: int):
        """(tokens, mask) for one eval batch; the trainer defines how."""
        raise NotImplementedError

    def evaluate(self):
        """Sample the eval prompts, score them with ``reward_fn`` and
        ``metric_fn``, and log a table. Statistics run over exactly the valid
        eval rows: the loader's fixed-shape wrap-around duplicates are
        dropped first."""
        eval_t0 = time.time()
        stats = {}
        all_texts = []
        t0 = time.time()
        for i, (batch, n_valid) in enumerate(self.eval_dataloader.iter_with_valid()):
            tokens, mask = self.eval_generate(batch["input_ids"], batch["attention_mask"], i)
            t, m = self.to_host((tokens, mask))
            all_texts.extend(self.decode(t[:n_valid], m[:n_valid]))
        stats["generate_time"] = time.time() - t0

        columns = ["sample"]
        rows = [[t] for t in all_texts]
        if self.reward_fn is not None:
            t0 = time.time()
            rewards = np.asarray(self.reward_fn(all_texts), dtype=np.float32)
            stats["reward_time"] = time.time() - t0
            stats["mean_reward"] = float(np.mean(rewards))
            columns.append("reward")
            for row, r in zip(rows, rewards):
                row.append(float(r))
        if self.metric_fn is not None:
            t0 = time.time()
            metrics = self.metric_fn(all_texts)
            stats["metric_time"] = time.time() - t0
            for k, v in metrics.items():
                v = np.asarray(v)
                stats[f"metrics/{k}"] = float(np.mean(v))
                if v.ndim > 0 and len(v) == len(rows):
                    columns.append(k)
                    for row, item in zip(rows, v):
                        row.append(float(item))
        self.tracker.log_table("samples", columns, rows, step=self.iter_count)
        stats["eval_wall_time"] = time.time() - eval_t0
        return stats

    def _check_resilience(self, stats):
        """Stop after ``train.max_bad_steps`` consecutive skipped updates."""
        if "resilience/bad_steps" in stats:
            check_bad_steps(int(stats["resilience/bad_steps"]), self.config.train.max_bad_steps, self.iter_count)

    def learn(self):
        """The training loop: epochs × store batches × n_updates_per_batch
        steps, ``post_backward_callback`` after every step, the log and eval
        cadence of ``train.log_interval`` / ``train.eval_interval``,
        ``post_epoch_callback`` after every epoch (PPO: the next rollout
        phase), and a stop at ``total_steps`` followed by ``evaluate()``.

        No checkpoint is saved, at an interval or at the end: checkpointing
        is not ported yet (``train.checkpoint_interval`` is not read).
        Returns the final ``evaluate()`` stats."""
        self.prepare_learning()
        self.iter_count = 0
        if self.iter_count >= self.total_steps:
            return self.evaluate()
        for _ in range(self.config.train.epochs):
            for batch in self.train_dataloader:
                device_batch = self.put_batch(batch)
                for _ in range(self.n_updates_per_batch):
                    forward_t0 = time.time()
                    stats = self.train_step(device_batch)
                    self.iter_count += 1
                    self.post_backward_callback(stats)
                    self._check_resilience(stats)
                    iv = self.intervals(self.iter_count)
                    if iv["do_log"] or iv["do_eval"]:
                        stats_host = {k: float(v) for k, v in stats.items()}
                        stats_host["step_time"] = time.time() - forward_t0
                        stats_host["samples_per_sec"] = self.config.train.batch_size / max(
                            stats_host["step_time"], 1e-9
                        )
                        if iv["do_eval"]:
                            stats_host.update(self.evaluate())
                        self.tracker.log(stats_host, step=self.iter_count)
                    if self.iter_count >= self.total_steps:
                        return self.evaluate()
            self.post_epoch_callback()
        return self.evaluate()
