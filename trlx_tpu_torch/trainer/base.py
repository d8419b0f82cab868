"""The trainer base (the counterpart of ``trlx_tpu.trainer.base``): the
learning-rate schedule, the optimizer, evaluation, checkpointing and the
``learn()`` loop, plus what every trainer shares on the rollout side.

A trainer owns one device, the model and its parameters, the seeded
generators, the optimizer state (its step counts and moments), the
consecutive-skip count of the non-finite guard, the tokenizer, and the host
hooks (``reward_fn``, ``metric_fn``, ``logit_mask``). There is one device and
no mesh: ``train.mesh`` is read by the JAX package only. With
``model.tokenizer_path`` the trainer runs in text mode (``_build_tokenizer``:
``transformers.AutoTokenizer``, imported when called, or any object with the
same interface a subclass returns): prompts are strings, ``decode`` gives
text to ``reward_fn`` and ``metric_fn``; without one, prompts and samples
are token ids. ``save_pretrained`` exports the trunk as an HF checkpoint
(``models/hf_export.py``). Every knob whose feature is missing is refused
by ``refuse_unported``.

Checkpoints (``save`` / ``load``) are the port's own format, not the JAX
package's orbax directory: ``<train.checkpoint_dir>/state_<step>/`` holds
``torch.save`` files of every named parameter (f32 masters, frozen ones
included), the frozen extras (PPO's reference branch, ILQL's target Q
heads), the optimizer's moments by parameter name with its applied-update
count, and the step with the guard's skip count; beside it sit
``state_<step>.host.json`` (host state), ``state_<step>.manifest.json``
(every file's size and crc32) and, written last, ``latest.txt``.
"""

import dataclasses
import json
import math
import os
import shutil
import signal
import sys
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import PPOConfig
from trlx_tpu_torch.device import resolve_device
from trlx_tpu_torch.models.hf_export import export_hf
from trlx_tpu_torch.models.lm import refresh_weight_copies
from trlx_tpu_torch.resilience import checkpoint as ckpt_util
from trlx_tpu_torch.resilience.checkpoint import CheckpointError
from trlx_tpu_torch.resilience.guard import check_bad_steps, guarded_update
from trlx_tpu_torch.trainer import BaseRLTrainer
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
    place; ``step`` clips the gradients it is given in place. ``names``
    (the parameters' names) key the moments in ``state_dict``; an optimizer
    built without them steps, but has no state to save or load."""

    def __init__(self, params: List[torch.Tensor], schedule: Callable[[int], float], b1: float, b2: float,
                 weight_decay: float, max_norm: float, eps: float = 1e-8, names: Optional[List[str]] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay, self.max_norm = float(weight_decay), float(max_norm)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.names = None if names is None else list(names)
        if self.names is not None and len(self.names) != len(params):
            raise ValueError(f"{len(self.names)} names for {len(params)} parameters")
        self.count = 0  # applied updates: Adam's bias-correction count and the schedule's

    def _require_names(self):
        if self.names is None:
            raise ValueError("this optimizer was built without parameter names: its moments cannot be saved or "
                             "loaded (give build_optimizer the names)")

    def state_dict(self) -> Dict:
        """The live moments by parameter name, and the applied-update
        count."""
        self._require_names()
        return {"mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu)), "count": self.count}

    def check_state_dict(self, state: Dict):
        """Raise ValueError unless ``state`` has exactly this optimizer's
        names, each moment of its shape."""
        self._require_names()
        for key, own in (("mu", self.mu), ("nu", self.nu)):
            got = state[key]
            if set(got) != set(self.names):
                missing, extra = sorted(set(self.names) - set(got)), sorted(set(got) - set(self.names))
                raise ValueError(f"optimizer {key}: missing {missing[:4]}, unexpected {extra[:4]}")
            for name, m in zip(self.names, own):
                if tuple(got[name].shape) != tuple(m.shape):
                    raise ValueError(f"optimizer {key} {name}: shape {tuple(got[name].shape)} != {tuple(m.shape)}")

    @torch.no_grad()
    def load_state_dict(self, state: Dict):
        """Copy ``state`` (``state_dict``'s layout) into the existing moment
        tensors, in place, after checking its names and shapes."""
        self.check_state_dict(state)
        for key, own in (("mu", self.mu), ("nu", self.nu)):
            for name, m in zip(self.names, own):
                m.copy_(state[key][name])
        self.count = int(state["count"])

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


def build_optimizer(train_cfg, params: List[torch.Tensor], names: List[str]):
    """(optimizer, schedule): global-norm clip then AdamW over ``params``
    (the trainable parameters only; frozen ones get no moments), keyed by
    ``names``."""
    schedule = lr_schedule(train_cfg)
    opt = ClippedAdamW(params, schedule, train_cfg.opt_betas[0], train_cfg.opt_betas[1],
                       train_cfg.weight_decay, train_cfg.grad_clip, names=names)
    return opt, schedule


def refuse_unported(config: TRLConfig):
    """Raise on every knob whose feature is not ported yet, so no config
    silently runs a different algorithm, or records less, than it asks
    for. The one list of such knobs: those every trainer shares, then the
    PPO method's own (a method config without them has none to refuse).
    Int8 decode weights are PPO's rollout feature: other trainers refuse
    them."""
    m, mc, t = config.method, config.model, config.train
    unported = {
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
            "method.rollout_overlap": m.rollout_overlap,
            "method.max_staleness": m.max_staleness > 0,
            "method.pack_train_batch": m.pack_train_batch,
            "method.fleet_disaggregate": m.fleet_disaggregate,
            "method.fleet_elastic": m.fleet_elastic,
            "method.gen_kwargs.prompt_buckets": bool(m.gen_kwargs.get("prompt_buckets")),
        })
    else:
        unported["model.decode_weight_quant"] = mc.decode_weight_quant
    on = [k for k, v in unported.items() if v]
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)}")


class BaseTrainer(BaseRLTrainer):
    def __init__(self, config: TRLConfig, device: Optional[Union[str, torch.device]] = None, **kwargs):
        super().__init__(config)
        self.device = resolve_device(device)
        refuse_unported(config)
        self.tokenizer = self._build_tokenizer(config.model.tokenizer_path)
        self.reward_fn = kwargs.pop("reward_fn", None)
        self.metric_fn = kwargs.pop("metric_fn", None)
        self.logit_mask = kwargs.pop("logit_mask", None)
        if kwargs:
            raise TypeError(f"unexpected trainer arguments: {sorted(kwargs)}")
        self.orch = None
        self.iter_count = 0
        self._tracker = None
        # Checkpoint and resilience host state: at most one save in flight;
        # the guard's total skips; the watchdog's rollback count and LR
        # scale (no watchdog is ported: they stay 0 and 1.0, and are saved
        # under the JAX package's names).
        self._pending_save = None
        self._saved = None  # (directory, name, host state) of the last finalized save, while the state is unchanged
        self.skipped_steps = 0
        self._rollbacks = 0
        self._lr_scale = 1.0
        self._resumed = False
        self._preempted = False
        self.last_restore_fallback = False  # load() fell past latest.txt
        self.checkpoint_log: List[Dict] = []  # one record per save and per load: bytes and seconds

    def build_train_state(self):
        """The train state beside the model: the trainable parameters (and
        their names), the optimizer over them, the step count and the
        guard's consecutive skips."""
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.trainable = [p for _, p in named]
        self.optimizer, self.schedule = build_optimizer(self.config.train, self.trainable, [n for n, _ in named])
        self.step = 0
        self.bad_steps = 0

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

    def _build_tokenizer(self, tokenizer_path: str):
        """The tokenizer at ``tokenizer_path`` (None for ""): pad = eos, left
        padding, as the JAX package sets them. ``transformers`` is imported
        here, only when a path is given; a subclass may return any object
        with the same interface (``__call__``, ``batch_decode``,
        ``bos_token_id``, ``eos_token_id``, ``pad_token_id``)."""
        if not tokenizer_path:
            return None
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(tokenizer_path)
        tokenizer.pad_token = tokenizer.eos_token
        tokenizer.padding_side = "left"
        return tokenizer

    def tokenize(self, texts):
        """BOS + text, truncated to ``train.seq_length`` keeping the trailing
        tokens (the prompts' keep-last rule)."""
        assert self.tokenizer is not None, "tokenize() requires a tokenizer"
        out = []
        for text in texts:
            ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
            if self.tokenizer.bos_token_id is not None:
                ids = [self.tokenizer.bos_token_id] + ids
            out.append(ids[-self.config.train.seq_length:])
        return out

    def decode(self, tokens, mask=None):
        """Token grids → text with a tokenizer (special tokens skipped), else
        per-row token arrays trimmed to the mask."""
        tokens = self.to_host(tokens)
        if self.tokenizer is not None:
            return self.tokenizer.batch_decode(tokens, skip_special_tokens=True)
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
        self._saved = None
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
            self.skipped_steps += 0 if applied else 1
            stats["resilience/nonfinite"] = torch.tensor(0.0 if applied else 1.0)
            stats["resilience/bad_steps"] = torch.tensor(float(self.bad_steps))
        else:
            self.optimizer.step(params, grads)
        stats["learning_rate"] = torch.tensor(self.schedule(self.step), dtype=torch.float32)
        self.step += 1
        self._saved = None
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
        dropped first. With an on-device reward model and no ``reward_fn``,
        the rewards are the reward model's scores."""
        eval_t0 = time.time()
        stats = {}
        all_texts = []
        rm_scores = []
        use_rm = self.reward_fn is None and getattr(self, "has_reward_model", False)
        t0 = time.time()
        for i, (batch, n_valid) in enumerate(self.eval_dataloader.iter_with_valid()):
            tokens, mask = self.eval_generate(batch["input_ids"], batch["attention_mask"], i)
            if use_rm:
                rm_scores.append(self.to_host(self.rm_eval_scores(tokens, mask))[:n_valid])
            t, m = self.to_host((tokens, mask))
            all_texts.extend(self.decode(t[:n_valid], m[:n_valid]))
        stats["generate_time"] = time.time() - t0

        columns = ["sample"]
        rows = [[t] for t in all_texts]
        rewards = None
        if use_rm:
            rewards = np.concatenate(rm_scores).astype(np.float32)
        elif self.reward_fn is not None:
            t0 = time.time()
            rewards = np.asarray(self.reward_fn(all_texts), dtype=np.float32)
            stats["reward_time"] = time.time() - t0
        if rewards is not None:
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

    # ----------------------------------------------------------------- learn

    def learn(self):
        """The training loop: epochs × store batches × n_updates_per_batch
        steps, ``post_backward_callback`` after every step, the checkpoint,
        log and eval cadence of ``train.checkpoint_interval`` /
        ``train.log_interval`` / ``train.eval_interval``,
        ``post_epoch_callback`` after every epoch (PPO: the next rollout
        phase), and a stop at ``total_steps``: a save, then ``evaluate()``.

        A resumed trainer counts on from its restored step; one that has
        already reached ``total_steps`` only evaluates. Interval saves
        follow ``train.async_checkpointing``; the one in flight is
        finalized on the way out. A SIGTERM (a preemption notice) is acted
        on after the current step, or at the next batch boundary: a save,
        a ``preempted_at_step`` record, and ``None`` is returned without
        evaluating. Otherwise returns the final ``evaluate()`` stats."""
        self.prepare_learning()
        self.iter_count = self.step if self._resumed else 0
        if self.iter_count >= self.total_steps:
            return self.evaluate()
        self._preempted = False

        def on_sigterm(signum, frame):
            self._preempted = True

        old_handler, installed = None, False
        try:
            old_handler = signal.signal(signal.SIGTERM, on_sigterm)
            installed = True
        except ValueError:  # not in the main thread
            pass
        try:
            return self._learn_loop()
        finally:
            # An async interval save may still be in flight: its sidecars
            # (manifest, latest.txt) land only at finalize.
            self._finalize_pending_save()
            if installed:
                signal.signal(signal.SIGTERM, old_handler if old_handler is not None else signal.SIG_DFL)

    def _learn_loop(self):
        train = self.config.train
        for _ in range(train.epochs):
            for batch in self.train_dataloader:
                # A SIGTERM may land during the (long) rollout phase that
                # built this loader: save before spending a step on it.
                if self._preempted:
                    self._save_on_preemption()
                    return None
                device_batch = self.put_batch(batch)
                for _ in range(self.n_updates_per_batch):
                    forward_t0 = time.time()
                    stats = self.train_step(device_batch)
                    self.iter_count += 1
                    self.post_backward_callback(stats)
                    self._check_resilience(stats)
                    iv = self.intervals(self.iter_count)
                    if iv["do_checkpoint"]:
                        self.save(block=not train.async_checkpointing)
                    if iv["do_log"] or iv["do_eval"]:
                        stats_host = {k: float(v) for k, v in stats.items()}
                        stats_host["step_time"] = time.time() - forward_t0
                        stats_host["samples_per_sec"] = train.batch_size / max(stats_host["step_time"], 1e-9)
                        if iv["do_eval"]:
                            stats_host.update(self.evaluate())
                        self.tracker.log(stats_host, step=self.iter_count)
                    if self._preempted:
                        self._save_on_preemption()
                        return None
                    if self.iter_count >= self.total_steps:
                        self.save()
                        return self.evaluate()
            self.post_epoch_callback()
        self.save()
        return self.evaluate()

    def _save_on_preemption(self):
        self.save()
        self.tracker.log({"preempted_at_step": self.iter_count}, step=self.iter_count)

    # ------------------------------------------------------------ checkpoint

    def state_tensors(self) -> Dict[str, Dict]:
        """The live train state, by file: every named parameter, the
        extras, the optimizer state, and the step with the guard's
        consecutive skips."""
        return {
            "params": dict(self.model.named_parameters()),
            "extras": dict(self.extras),
            "optimizer": self.optimizer.state_dict(),
            "train_state": {"step": int(self.step), "bad_steps": int(self.bad_steps)},
        }

    def host_state_dict(self) -> dict:
        """Host-side state a resume restores besides the tensors
        (subclasses extend: PPO adds the KL coefficient). The port has no
        counterpart of the JAX package's ``next_rng`` key: every generator
        is a pure function of (train.seed, its key), so no ``rng`` is
        saved."""
        return {
            "resilience": {
                "skipped_steps": int(self.skipped_steps),
                "rollbacks": int(self._rollbacks),
                "lr_scale": float(self._lr_scale),
            },
        }

    def load_host_state(self, d: dict):
        res = d.get("resilience", {})
        if res:
            self.skipped_steps = int(res.get("skipped_steps", self.skipped_steps))
            # Monotone merges, as in the JAX package: a restored older host
            # state never lowers the rollback count nor raises the LR scale.
            self._rollbacks = max(self._rollbacks, int(res.get("rollbacks", 0)))
            self._lr_scale = min(self._lr_scale, float(res.get("lr_scale", 1.0)))
            if self._lr_scale != 1.0:
                raise NotImplementedError(
                    f"the checkpoint carries lr_scale {self._lr_scale}: the watchdog's LR decay is not ported yet"
                )

    def save(self, directory: Optional[str] = None, block: bool = True):
        """Checkpoint the whole train state and the host state to
        ``<directory>/state_<step>`` (``train.checkpoint_dir`` by default).

        The state is copied to host memory now, so later steps cannot
        change what is written. ``block=False`` writes the files on one
        background thread and returns; the sidecars (host state, manifest,
        then ``latest.txt``) land at ``_finalize_pending_save``, which the
        next save, ``load()`` and the exit from ``learn()`` call first. At
        most one save is in flight. The files are written under
        ``state_<step>.tmp`` and renamed at finalize, so a crash before
        ``latest.txt`` is rewritten leaves the previous checkpoint as the
        resume point. A save of the state the last save already holds (the
        interval save of the step ``learn()`` stops at) writes nothing."""
        self._finalize_pending_save()
        directory = os.path.abspath(directory or self.config.train.checkpoint_dir)
        name = f"state_{int(self.step)}"
        host_state = self.host_state_dict()  # captured now: the KL coefficient moves on
        if self._saved == (directory, name, host_state):
            return
        t0 = time.perf_counter()
        snapshot = _host_copy(self.state_tensors())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        record = {"name": name, "async": not block, "d2h_s": time.perf_counter() - t0,
                  "host_bytes": _nbytes(snapshot)}
        pending = {"directory": directory, "name": name, "host_state": host_state, "record": record,
                   "t0": t0, "result": {}}
        path = os.path.join(directory, f"{name}.tmp")
        if block:
            _write_state(path, snapshot, pending["result"])
        else:
            pending["thread"] = threading.Thread(target=_write_state, args=(path, snapshot, pending["result"]),
                                                 name="trlx-ckpt-writer")
            pending["thread"].start()
        self._pending_save = pending
        if block:
            self._finalize_pending_save()

    def _finalize_pending_save(self) -> Optional[str]:
        """Drain the save in flight: join its writer, then atomically write
        host state, manifest and ``latest.txt`` (in that order — the pointer
        flips last), and apply ``train.keep_checkpoints``. Returns the
        checkpoint's name, or None when no save was pending."""
        pending, self._pending_save = self._pending_save, None
        if pending is None:
            return None
        t0 = time.perf_counter()
        if "thread" in pending:
            pending["thread"].join()
        result, record = pending["result"], pending["record"]
        if "error" in result:
            raise CheckpointError(f"writing {pending['name']} failed") from result["error"]
        record["join_s"] = time.perf_counter() - t0
        directory, name = pending["directory"], pending["name"]
        t1 = time.perf_counter()
        path = os.path.join(directory, name)
        if os.path.isdir(path):  # torn by a crash, or an older state of this step (reloaded, then changed)
            shutil.rmtree(path)
        os.replace(f"{path}.tmp", path)
        ckpt_util.atomic_write_json(os.path.join(directory, f"{name}.host.json"), pending["host_state"])
        ckpt_util.write_manifest(directory, name, ckpt_util.checkpoint_step(name), result["digests"])
        # basename, not abspath: checkpoint dirs move between machines.
        # Written LAST and atomically: a crash above leaves the old pointer.
        ckpt_util.atomic_write_text(os.path.join(directory, "latest.txt"), name)
        ckpt_util.gc_checkpoints(directory, self.config.train.keep_checkpoints, protect=(name,))
        record.update(bytes=result["bytes"], write_s=result["write_s"], crc_wait_s=result["crc_wait_s"],
                      manifest_s=time.perf_counter() - t1, finalize_s=time.perf_counter() - t0,
                      save_s=time.perf_counter() - pending["t0"])
        self.checkpoint_log.append({"op": "save", **record})
        self.tracker.log({"save_time": record["save_s"]}, step=self.iter_count)
        self._saved = (directory, name, pending["host_state"])
        return name

    def _maybe_resume(self):
        """With ``train.resume_from_checkpoint``, restore the latest
        checkpoint if ``latest.txt`` exists (a trainer calls this at the end
        of its build, before any rollout, so PPO's first experience comes
        from the restored policy)."""
        if not self.config.train.resume_from_checkpoint:
            return
        if not os.path.exists(os.path.join(os.path.abspath(self.config.train.checkpoint_dir), "latest.txt")):
            return
        self.load()
        self._resumed = True
        print(f"[trlx_tpu_torch] resumed from step {self.step}", file=sys.stderr)

    def load(self, directory: Optional[str] = None):
        """Restore the train state and host state saved by ``save``.

        Candidates are tried from the ``latest.txt`` pointer, then every
        other ``state_*`` newest first; each is manifest-verified before it
        is read, and one that fails verification, reading or the
        name-and-shape check falls back to the previous intact checkpoint
        (``last_restore_fallback``). The values are copied in place into
        the existing parameters, moments and extras, so the bf16 weight
        copies and a captured decode graph read them. Raises
        CheckpointError with every attempt when nothing is restorable."""
        t_load = time.perf_counter()
        self._finalize_pending_save()  # a pending async save IS the latest
        self._saved = None
        directory = os.path.abspath(directory or self.config.train.checkpoint_dir)
        latest_path = os.path.join(directory, "latest.txt")
        latest = None
        if os.path.exists(latest_path):
            with open(latest_path) as f:
                latest = f.read().strip() or None
        candidates = [] if latest is None else [os.path.basename(latest)]
        candidates += [n for n in ckpt_util.list_checkpoints(directory) if n not in candidates]
        if not candidates:
            raise CheckpointError(
                f"no checkpoint found in {directory}: "
                + ("latest.txt is empty" if os.path.exists(latest_path) else "latest.txt is missing")
                + " and no state_* directories exist — nothing to resume from "
                "(set train.resume_from_checkpoint=False to start fresh, or "
                "point train.checkpoint_dir at the directory that holds the run)"
            )
        attempts = []
        for i, name in enumerate(candidates):
            path = os.path.join(directory, name)
            with ckpt_util.mark_in_use(directory, name):
                t0 = time.perf_counter()
                ok, reason = ckpt_util.verify_checkpoint(directory, name)
                if not ok:
                    attempts.append(f"{name}: {reason}")
                    continue
                t1 = time.perf_counter()
                try:
                    # Mapped from the files on the host, then copied into the
                    # live tensors: a load onto the device would hold a second
                    # copy of the whole state on the card.
                    state = {f: torch.load(os.path.join(path, f"{f}.pt"), map_location="cpu", mmap=True,
                                           weights_only=True) for f in _STATE_FILES}
                    self._check_state(state)
                except (OSError, RuntimeError, ValueError, KeyError, EOFError) as e:
                    attempts.append(f"{name}: read failed ({type(e).__name__}: {e})")
                    continue
                t2 = time.perf_counter()
                self._copy_state(state)
                del state
                t3 = time.perf_counter()
                self.last_restore_fallback = i > 0
                if i > 0:
                    print(f"[trlx_tpu_torch.resilience] latest checkpoint unusable ({'; '.join(attempts)}) "
                          f"— fell back to {name}", file=sys.stderr)
                host_file = f"{path}.host.json"
                if os.path.exists(host_file):
                    with open(host_file) as f:
                        self.load_host_state(json.load(f))
                self.checkpoint_log.append({
                    "op": "load", "name": name, "fallback": i > 0, "verify_s": t1 - t0, "read_s": t2 - t1,
                    "copy_s": t3 - t2, "load_s": time.perf_counter() - t_load,
                    "bytes": sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)),
                })
                return name
        raise CheckpointError(
            f"no restorable checkpoint in {directory} — every candidate failed verification or reading: "
            f"{'; '.join(attempts)}. If the data is gone, set train.resume_from_checkpoint=False to start fresh."
        )

    def _check_state(self, state: Dict):
        """Raise ValueError unless a read checkpoint names exactly this
        trainer's parameters and extras, each of its shape, and this
        optimizer's moments."""
        for f, own in (("params", dict(self.model.named_parameters())), ("extras", self.extras)):
            got = state[f]
            if set(got) != set(own):
                missing, extra = sorted(set(own) - set(got)), sorted(set(got) - set(own))
                raise ValueError(f"{f}: missing {missing[:4]}, unexpected {extra[:4]}")
            for n, t in own.items():
                if tuple(got[n].shape) != tuple(t.shape):
                    raise ValueError(f"{f} {n}: shape {tuple(got[n].shape)} != {tuple(t.shape)}")
        self.optimizer.check_state_dict(state["optimizer"])

    @torch.no_grad()
    def _copy_state(self, state: Dict):
        """Copy a checked state into the live tensors, in place, and bring
        the model's bf16 weight copies up to date."""
        for n, p in self.model.named_parameters():
            p.copy_(state["params"][n])
        for n, t in self.extras.items():
            t.copy_(state["extras"][n])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["train_state"]["step"])
        self.bad_steps = int(state["train_state"]["bad_steps"])
        refresh_weight_copies(self.model)

    # ------------------------------------------------------------ HF export

    def save_pretrained(self, out_dir: str, family: Optional[str] = None) -> str:
        """Export the trained trunk as an HF checkpoint directory
        (``config.json``, f32 safetensors) and every other parameter (value
        head, ILQL's Q and V heads) beside it in ``trlx_tpu_heads.npz``. The
        frozen extras (the reference branch, the target Q heads) are not
        exported. Streams one tensor at a time from the device. Returns
        ``out_dir``."""
        params = dict(self.model.named_parameters())
        heads = {k: v for k, v in params.items() if not k.startswith("transformer.")}
        return export_hf(params, self.model.cfg, out_dir, family=family, head_params=heads)

    # ------------------------------------------------------- BaseRL protocol

    def act(self, data):
        """(tokens, mask) of one rollout of ``data``'s prompts."""
        return self.rollout_generate(data["input_ids"], data["attention_mask"])

    def sample(self, prompts, length: int = None, n_samples: int = None):
        """Sample continuations: ``n_samples`` rows by tiling or truncating
        the prompt batch, the response clipped to ``length`` tokens, at most
        the configured response length (a longer request warns once).
        Returns the tokens [n_samples, P + min(length, R)] on the host."""
        ids = np.asarray(prompts["input_ids"])
        mask = np.asarray(prompts["attention_mask"])
        n = n_samples if n_samples is not None else ids.shape[0]
        reps = -(-n // ids.shape[0])
        ids, mask = np.tile(ids, (reps, 1))[:n], np.tile(mask, (reps, 1))[:n]
        tokens, _ = self.rollout_generate(ids, mask)
        tokens = self.to_host(tokens)
        if length is not None:
            P = ids.shape[1]
            configured = tokens.shape[1] - P
            if int(length) > configured and not getattr(self, "_warned_sample_clip", False):
                self._warned_sample_clip = True
                warnings.warn(
                    f"sample(length={int(length)}) exceeds the configured response length {configured}; output is "
                    f"clipped to {configured} new tokens (raise method.gen_kwargs max tokens to generate more)",
                    stacklevel=2,
                )
            tokens = tokens[:, : P + min(int(length), configured)]
        return tokens


_STATE_FILES = ("params", "extras", "optimizer", "train_state")


def _host_copy(tree):
    """A host copy of every tensor in a nest of dicts (a copy on the CPU
    too: the snapshot must not follow the live tensors)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    return tree


def _nbytes(tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return 0


def _write_state(path: str, snapshot: Dict[str, Dict], result: Dict):
    """Write one ``torch.save`` file per state group into ``path`` (made
    anew: a temporary directory the finalize renames), fsynced, with each file's (size, crc32) taken as it is written.
    Fills ``result`` with the digests, the bytes and the seconds, or with
    the error (this runs on the async save's writer thread too)."""
    try:
        t0 = time.perf_counter()
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path)
        digests, crc_wait_s = {}, 0.0
        for f, group in snapshot.items():
            with ckpt_util.DigestWriter(os.path.join(path, f"{f}.pt")) as w:
                torch.save(group, w)
            digests[f"{f}.pt"] = (w.size, w.crc)
            crc_wait_s += w.crc_wait_s
        result.update(digests=digests, bytes=sum(s for s, _ in digests.values()), crc_wait_s=crc_wait_s,
                      write_s=time.perf_counter() - t0)
    except Exception as e:  # noqa: BLE001 — re-raised by _finalize_pending_save
        result["error"] = e
