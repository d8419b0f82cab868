"""PPO trainer: the KL controllers, model build, decode with the fused
rollout statistics, rollout scoring, and the train step (the counterpart of
``trlx_tpu.trainer.ppo``).

``trlx_tpu_torch.train(reward_fn=...)`` runs ``PPOTrainer`` →
``PromptPipeline`` → ``PPOOrchestrator.make_experience`` → ``learn()``: each
train step is the PPO loss (GAE, whitening, the policy forward, the clipped
losses), its backward, the non-finite guard, then global-norm clip and
AdamW over the trainable parameters. With ``method.rollout_engine`` the
rollouts come from the continuous-batching ``RolloutEngine`` (optionally
paged, ``method.paged_kv``), which the trainer builds once and shuts down at
the end of ``learn()``.

With ``model.reward_model_path`` (an HF checkpoint) or
``model.reward_model_arch`` the rollouts are scored by an on-device reward
model instead of a host ``reward_fn``: a frozen ``LMWithValueHead`` without
a branch whose value head at each sequence's last valid token is its score.
It is never trained, never in the optimizer and never in a checkpoint.

With ``model.decode_weight_quant`` (W8A16) the trunk's products and the LM
head decode from int8 copies (``ops.w8a16``): made at build, re-quantized
in place from the live policy by the samplers before every call (the
``refresh_weight_copies`` they run before any replay: the counterpart of
the JAX trainer's ``_refresh_decode_weights``), and read only by the
samplers (``models.lm.decode_weights``), never by scoring or training.
With ``method.spec_decode`` the engine verifies drafted windows
(``engine.drafters``).

The overlapped pipeline (``method.rollout_overlap``, ``method.max_staleness``;
``pipeline.overlap``): the next iteration's experience is produced on a
``RolloutProducer`` thread, host scoring runs on a ``ScoreWorker`` and train
batches are staged by a ``PrefetchIterator``. At staleness 0 the producer
runs while this thread waits for its store, from the live weights, so the
run equals the serial one. At staleness S > 0 it runs up to S iterations
ahead, from the boundary weights of a ``models.snapshot.RolloutSnapshot``
handed over at each iteration boundary. Every rollout phase logs the phase
window (``time/*_s``, ``time/overlap_fraction``, ``train_tokens_per_s``),
serial or not. ``method.pack_train_batch`` packs each train batch's episodes
into dense rows (``pipeline.ppo_pipeline.pack_ppo_batch``) trained with a
block-diagonal mask and segment-aware GAE; ``method.gen_kwargs.prompt_buckets``
pads each rollout prompt to its bucket's width.

Threads and the card. Both threads enqueue on the device's default stream,
so the card runs their work in the order it was enqueued, and the boundary
handoff orders its copies under the snapshot's lock; the card's SMs are
shared, so the overlap hides host and phase time rather than adding device
throughput. Graph captures run in ``thread_local`` mode (``ops.cuda_graph``)
because either thread may capture while the other issues work.

On several processes (a mesh) the producer and its score worker issue their
collectives (the tp all-reduces of decode and scoring, the reward
broadcast, the row gathers, the sp ring, the engine's schedule check) over
the mesh's second group set (``parallel.mesh.producer_collectives``), so no
communicator is shared with the train loop, which keeps the first; the
boundary snapshot holds the fsdp-gathered compute copies, so the producer
gathers nothing over fsdp. Over NCCL the producer also enqueues on a stream
of its own, ordered against the main stream at the snapshot handoff by
events. The fingerprint checks at the boundaries stay on the main thread.
The engine runs under its multi-process contract (``engine.rollout_engine``)
and the int8 decode copies of a sharded model are quantized from its pieces
(``ops.w8a16.quantize_dense``).

The fleet (``method.fleet_disaggregate``, ``trlx_tpu_torch.fleet``): the
role is validated at construction (``validate_fleet_config``: every
misconfiguration is a ValueError here, never mid-run) and the in-process
overlap stays off under a role (``method.max_staleness`` bounds the
cross-job episode stream instead). A learner or colocated trainer takes its
stores from a ``FleetLearnerFeed`` (``_fleet_bootstrap`` at the first fill,
then publish-and-consume at every ``post_epoch_callback``); a
``FleetDegradedExit`` saves the rollback checkpoint and ends ``learn()``
cleanly, returning None; ``learn()``'s teardown shuts the feed down with the
coordinated abort marker (none on preemption). A rollout trainer runs
``fleet.run_rollout_worker`` instead of ``learn()`` (``trainer.api``). A
role may be a world of several processes: every rank builds the feed or
runs the worker, and the transports live on rank 0 (``fleet.runner``).
"""

import copy
from contextlib import nullcontext
from typing import Dict

import numpy as np
import torch

from trlx_tpu_torch.data import PackedPPOBatch, PPORLBatch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.device import stamp
from trlx_tpu_torch.fleet.runner import FleetDegradedExit
from trlx_tpu_torch.fleet.topology import validate_fleet_config
from trlx_tpu_torch.models.heads import LMWithValueHead, extract_branch_params, swapped_params, trainable_mask
from trlx_tpu_torch.models.hf_import import build_lm_config, load_or_init_params
from trlx_tpu_torch.models.snapshot import RolloutSnapshot
from trlx_tpu_torch.observability import numerics as obs_numerics
from trlx_tpu_torch.ops.fused_logprob import fused_logprob_eligible
from trlx_tpu_torch.ops.generate import make_generate_fn
from trlx_tpu_torch.ops.modeling import logprobs_from_logits
from trlx_tpu_torch.ops.rl_losses import kl_penalty_rewards, ppo_loss
from trlx_tpu_torch.ops.sampling import GenerateConfig, make_bigram_mask_processor, process_logits_default
from trlx_tpu_torch.ops.w8a16 import quantize_weights
from trlx_tpu_torch.parallel.mesh import node_count, producer_collectives, world_size
from trlx_tpu_torch.pipeline.overlap import PhaseTimer, RolloutProducer
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.pipeline.prompt_pipeline import normalize_buckets
from trlx_tpu_torch.trainer import register_model
from trlx_tpu_torch.trainer.base import BaseTrainer


def resolve_fused_head(cfg, device: torch.device) -> bool:
    """Whether the LM-head logprob passes go through the fused kernel
    instead of materialized logits + log_softmax: always with "force", and
    with "auto" on a CUDA device with bf16 compute and an eligible shape."""
    mode = cfg.extra.get("fused_logprob", "auto")
    if mode == "force":
        return True
    return (
        mode == "auto"
        and device.type == "cuda"
        and cfg.compute_dtype == torch.bfloat16
        and fused_logprob_eligible(cfg.d_model, cfg.vocab_size)
    )


class AdaptiveKLController:
    """Proportional KL-coefficient controller."""

    def __init__(self, init_kl_coef: float, target: float, horizon: int):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current: float, n_steps: int):
        proportional_error = np.clip(current / self.target - 1, -0.2, 0.2)
        mult = 1 + proportional_error * n_steps / self.horizon
        self.value *= mult


class FixedKLController:
    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current: float, n_steps: int):
        pass


@register_model("ppo")
@register_model("AcceleratePPOModel")
@register_model("TPUJaxPPOModel")
@register_model("PPOTrainer")
class PPOTrainer(BaseTrainer):
    """The PPO trainer on one device: rollouts, scoring and the train step.

    ``device`` defaults to CUDA (and raises where there is none); tests pass
    ``device="cpu"``. Parameters are initialized from ``train.seed``;
    ``load_params`` replaces them (e.g. with ``params_from_jax`` of the JAX
    package's parameters). The bottom n_layer - num_layers_unfrozen blocks
    are frozen (``requires_grad=False``); everything else trains."""

    def __init__(self, config: TRLConfig, device=None, **kwargs):
        super().__init__(config, device=device, **kwargs)
        m = config.method
        gen_kwargs = dict(m.gen_kwargs)
        # The fleet's role (None: fleet off), validated at construction.
        self.fleet_role = validate_fleet_config(config)

        self.load_log = {}  # the HF loads' records (bytes, seconds) by model; None for a model built from scratch
        self.model = self.get_arch(config)
        self.extras = self.make_extras()
        # W8A16 decode: int8 copies of the trunk's products and the LM head
        # on their Dense layers, which the samplers read instead of the
        # masters (the weight bytes of a decode step halve) and re-quantize
        # in place when a master changed.
        self.decode_weight_quant = bool(config.model.decode_weight_quant)
        if self.decode_weight_quant:
            quantize_weights(self.model)
            obs_numerics.record_weight_quant(self.model, version=0)
        self.rm_model = self._build_reward_model(config) if config.model.has_reward_model else None

        # The overlapped pipeline (pipeline.overlap): background scoring,
        # batch prefetch and the rollout producer; max_staleness > 0 also
        # lets the producer run ahead from boundary snapshots. Under a fleet
        # role max_staleness bounds the cross-job stream instead, and the
        # in-process machinery stays off.
        self.max_staleness = max(0, int(m.max_staleness or 0))
        self.overlap_rollouts = (bool(m.rollout_overlap) or self.max_staleness > 0) and self.fleet_role is None
        self._producer_stream = None  # the producer's own stream over NCCL, made at first use
        self._pack_train_batch = bool(m.pack_train_batch)
        # Packed row counts round up to a multiple of the node's data ranks.
        self._pack_rows_multiple = int(self.mesh.data_size // node_count())
        self._window_tokens = []
        self._window_fill = []
        self._phase_timer = PhaseTimer()
        self._rollout_producer = None
        self._snapshot_weights = None  # the producer's RolloutSnapshot, built at the first boundary
        self._last_exp_stats = None
        # The fleet's learner feed (built by _fleet_bootstrap), the
        # degraded-exit latch, and the rollout-side weights (fleet.runner).
        self._fleet_feed = None
        self._fleet_stopped = False
        self._fleet_weights = None
        # Decided once, so iteration 0's store and every producer-built one
        # share one column layout; fleet stores carry the realized staleness
        # stamped at consume time.
        self.store = PPORolloutStorage(self.pad_token_id,
                                       record_staleness=self.overlap_rollouts or self.fleet_role is not None)
        if m.target is not None:
            self.kl_ctl = AdaptiveKLController(m.init_kl_coef, m.target, m.horizon)
        else:
            self.kl_ctl = FixedKLController(m.init_kl_coef)
        # Per-step mean_kl device scalars queued by post_backward_callback
        # and applied in order at the next flush (before any rollout reads
        # kl_ctl.value), so the controller follows the per-step trajectory.
        self._kl_pending = []

        self.build_train_state()

        # Static decode shapes: prompt length + new tokens == seq_length.
        self.prompt_length = int(gen_kwargs.pop("prompt_length", 0)) or max(
            config.train.seq_length - int(gen_kwargs.get("max_new_tokens", config.train.seq_length // 2)),
            1,
        )
        # Prompt-length buckets: the prompt pipeline pads each prompt to the
        # smallest listed width that holds it; rollouts decode at that width
        # (a decode graph per bucket) and the stored queries are left-padded
        # back to prompt_length, so the train step keeps one width.
        self.prompt_buckets = normalize_buckets(gen_kwargs.pop("prompt_buckets", None), self.prompt_length)
        self.gen_cfg = GenerateConfig.from_gen_kwargs(
            gen_kwargs, prompt_len=self.prompt_length, pad_token_id=self.pad_token_id,
            eos_token_id=self.eos_token_id,
        )
        self.response_length = self.gen_cfg.max_new_tokens

        processor = None  # the logits chain of both samplers, with the bigram mask when one is given
        if self.logit_mask is not None:
            bigram = make_bigram_mask_processor(self.logit_mask)
            gcfg = self.gen_cfg

            def processor(logits, state):
                return process_logits_default(bigram(logits, state), gcfg, state["step"])

        self._gen_processor = processor
        self._generate_fns = {}  # id(module) → the module's (generate, fused generate) functions

        # Fused rollout statistics: the decode loop already computes the
        # policy's logprob of each sampled token, its value and (hydra) the
        # branch-point hidden state, so scoring only replays the frozen
        # reference branch. With a reward model, scoring runs the full
        # policy re-forward beside the reward model's pass instead.
        self.fused_rollout = bool(m.fused_rollout_stats and self.model.branch_layer >= 0
                                  and not config.model.has_reward_model)
        # The engine's episodes are always scored unfused, a delta bounded as
        # for the int8 KV cache; the chunked path needs the fused statistics.
        if self.decode_weight_quant and not self.fused_rollout and not m.rollout_engine:
            raise ValueError(
                "model.decode_weight_quant requires the fused rollout-stats path (a hydra model with a host "
                "reward_fn and method.fused_rollout_stats on): fused stats store the QUANTIZED sampler's own "
                "logprobs, keeping PPO on-policy by construction. Unfused scoring would recompute behavior "
                "logprobs at full precision against int8-sampled tokens — a silent off-policy bias. Disable "
                "decode_weight_quant, enable the fused path, or use method.rollout_engine (whose unfused scoring "
                "delta is bounded by the engine+int8 parity test)."
            )
        self._generate_fn, self._generate_fused_fn = self._generate_fns_for(self.model)
        if self._devicemon is not None:
            # Device telemetry: the scoring passes are monitored programs
            # (one counted signature per prompt width).
            self.rollout_score = self._wrap_monitored("rollout/score", self.rollout_score, phase="score")
            self.rollout_score_fused = self._wrap_monitored("rollout/score_fused", self.rollout_score_fused,
                                                            phase="score")
            self.rollout_score_rm = self._wrap_monitored("rollout/score_rm", self.rollout_score_rm, phase="score")

        # The continuous-batching engine (method.rollout_engine), built at
        # first use. Its episodes are always scored unfused (a policy
        # re-forward): with kv_cache_quant the stored behaviour logprobs are
        # then full-precision recomputations of int8-cache samples, a delta
        # the JAX package measured at |dlogprob| <= ~0.008.
        self.rollout_engine_enabled = bool(m.rollout_engine)
        self._rollout_engine = None
        if m.paged_kv and not self.rollout_engine_enabled:
            raise ValueError(
                "method.paged_kv requires method.rollout_engine: the paged block pool and prefix cache live in "
                "the slot engine's admission/harvest lifecycle; the chunked rollout path has no slot reuse to page."
            )
        # Resume BEFORE any rollout: the first experience must come from the
        # restored policy (stale behaviour logprobs would mis-clip the whole
        # first epoch's importance ratios).
        self._maybe_resume()

    # ----------------------------------------------------------------- setup

    @property
    def pad_token_id(self) -> int:
        if self.tokenizer is not None and self.tokenizer.pad_token_id is not None:
            return int(self.tokenizer.pad_token_id)
        return 0

    @property
    def eos_token_id(self):
        if self.tokenizer is not None:
            return self.tokenizer.eos_token_id
        return self.config.model.model_arch.get("eos_token_id")

    def get_arch(self, config: TRLConfig) -> LMWithValueHead:
        """The value-head model with its hydra branch point, seeded from
        ``train.seed``, its trunk loaded from ``model.model_path`` when the
        config names a checkpoint (``hf_import.load_or_init_params``). With k
        = num_layers_unfrozen in (0, n_layer) the top k blocks form the
        frozen reference branch; otherwise there is no branch and the
        reference is a full frozen copy."""
        lm_cfg = self.finalize_lm_config(build_lm_config(config))
        k = config.model.num_layers_unfrozen
        branch_layer = lm_cfg.n_layer - k if 0 < k < lm_cfg.n_layer else -1
        model = LMWithValueHead(lm_cfg, branch_layer=branch_layer, device=self.device)
        self.load_log["policy"] = load_or_init_params(model, config, self.seeded_generator(1))
        self.opt_mask = trainable_mask(model, lm_cfg, config.model.num_layers_unfrozen)
        for name, p in model.named_parameters():
            p.requires_grad_(name in self.opt_mask)
        return model

    def _build_reward_model(self, config: TRLConfig) -> LMWithValueHead:
        """The on-device reward model: ``LMWithValueHead`` with no branch,
        its trunk loaded from ``model.reward_model_path`` or built from
        ``model.reward_model_arch``, its value head fresh. The port has no
        ``next_rng`` key: the reward model is seeded by its own generator
        key. Every parameter is frozen, so each forward reads the bf16 copy
        made once per weight (``models/lm.py`` ``frozen_copy``)."""
        rm_config = copy.deepcopy(config)
        rm_config.model.model_path = config.model.reward_model_path
        rm_config.model.model_arch = dict(config.model.reward_model_arch)
        rm = LMWithValueHead(self.finalize_lm_config(build_lm_config(rm_config)), branch_layer=-1, device=self.device)
        self.load_log["reward_model"] = load_or_init_params(rm, rm_config, self.seeded_generator(4))
        rm.requires_grad_(False)
        return rm

    @property
    def has_reward_model(self) -> bool:
        return self.rm_model is not None

    @torch.no_grad()
    def rollout_score_rm(self, tokens, mask, timings=None, snapshot=None):
        """Scoring with the on-device reward model: its scores, then the
        policy re-forward and reference pass of ``rollout_score`` with those
        scores. Returns (logprobs, values, rewards, kl, scores), on the
        device. ``timings`` gets the reward model's pass (``rm_start`` /
        ``rm_end``) and the whole scoring (``start`` / ``end``)."""
        tokens, mask = self.put(tokens), self.put(mask)
        if timings is not None:
            timings["rm_start"] = stamp(self.device)
        scores = reward_model_scores(self.rm_model, tokens, mask)
        if timings is not None:
            timings["rm_end"] = stamp(self.device)
        out = self.rollout_score(tokens, mask, scores, snapshot=snapshot)
        if timings is not None:
            timings["start"], timings["end"] = timings["rm_start"], stamp(self.device)
        return (*out, scores)

    def rm_eval_scores(self, tokens, mask) -> torch.Tensor:
        """Reward-model scores of eval generations (device tensors in and
        out)."""
        return reward_model_scores(self.rm_model, self.put(tokens), self.put(mask))

    def make_extras(self) -> Dict[str, torch.Tensor]:
        """The frozen reference: the branch's parameters for a hydra model,
        else a copy of every parameter."""
        if self.model.branch_layer >= 0:
            return extract_branch_params(self.model, self.model.branch_layer)
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    # --------------------------------------------------------------- rollout

    def _batch_prompt_length(self, tokens) -> int:
        return int(tokens.shape[1]) - self.response_length

    def _generate_fns_for(self, module):
        """(generate, fused generate or None) bound to ``module``: the live
        model's, or the rollout snapshot's. Each keeps its own buffers and
        decode graphs."""
        fns = self._generate_fns.get(id(module))
        if fns is None:
            fused = None
            if self.fused_rollout:

                def rollout_stats_fn(tok, s):
                    lp = torch.log_softmax(s["last_logits"], dim=-1)
                    return {
                        "logprob": torch.gather(lp, -1, tok[:, None].long())[:, 0],
                        "value": s["carry"]["values"],
                        "branch_hidden": s["carry"]["branch_hidden"],
                    }

                fused = make_generate_fn(
                    module, self.gen_cfg, self._gen_processor,
                    carry_keys=("values", "branch_hidden"),
                    step_stats_fn=rollout_stats_fn,
                    apply_kwargs={"collect_branch_hidden": True},
                    prefill_collect=("branch_hidden",),
                )
            plain = make_generate_fn(module, self.gen_cfg, self._gen_processor)
            fns = self._generate_fns[id(module)] = (
                self._wrap_monitored("rollout/generate", plain, phase="rollout"),
                None if fused is None else self._wrap_monitored("rollout/generate_fused", fused, phase="rollout"))
        return fns

    def _decode_module(self, snapshot=None):
        """The module rollouts read: the live model, or a boundary
        snapshot's (``_rollout_snapshot``)."""
        return self.model if snapshot is None else snapshot["weights"].module

    def _adopt_snapshot(self, snapshot=None):
        """Start of a store: bring a snapshot's module to its newest staged
        boundary (``RolloutSnapshot.adopt``; between stores only) and return
        the weight version the store's rollouts read (the live model's:
        ``iter_count``)."""
        if snapshot is None:
            return self.iter_count
        return snapshot["weights"].adopt()

    def _rollout_snapshot(self):
        """Stage the live weights for the producer (main thread, at an
        iteration boundary, no train step in flight): ``{"version":
        iter_count, "weights": RolloutSnapshot}``. The snapshot is built at
        the first boundary; later ones copy into it in place."""
        if self._snapshot_weights is None:
            trainable = {n for n, p in self.model.named_parameters() if p.requires_grad}
            self._snapshot_weights = RolloutSnapshot(self.model, trainable)
        self._snapshot_weights.take(self.iter_count)
        if self.decode_weight_quant and obs_numerics.enabled():
            # The snapshot's int8 copies are quantized from the live masters.
            obs_numerics.record_weight_quant(self.model, version=self.iter_count)
        return {"version": int(self.iter_count), "weights": self._snapshot_weights}

    def rollout_generate(self, input_ids, attention_mask, generator=None, timings=None, snapshot=None, rows=None):
        """Prefill + decode. Returns (tokens, mask) [b, P + R] on the device.
        ``rows``: this data rank's place in the node's batch
        (``sample_rows``)."""
        if generator is None:
            generator = self.chunk_rng(0)
        fn = self._generate_fns_for(self._decode_module(snapshot))[0]
        return fn(self.put(input_ids), self.put(attention_mask), generator, timings=timings, rows=rows)

    def rollout_generate_fused(self, input_ids, attention_mask, generator=None, timings=None, snapshot=None,
                               rows=None):
        """Generation that also returns the statistics collected in the
        decode loop: (tokens, mask, stats, prefill_extras); feed the last two
        to ``rollout_score_fused``."""
        if generator is None:
            generator = self.chunk_rng(0)
        fn = self._generate_fns_for(self._decode_module(snapshot))[1]
        return fn(self.put(input_ids), self.put(attention_mask), generator, timings=timings, rows=rows)

    def rollout_engine(self):
        """The lazily built continuous-batching engine: one per trainer, it
        keeps its slot cache (or block pool) across experience phases, and
        weights are handed over per phase (``update_weights``)."""
        if self._rollout_engine is None:
            from trlx_tpu_torch.engine import RolloutEngine

            m = self.config.method
            self._rollout_engine = RolloutEngine(
                self.model, self.gen_cfg,
                n_slots=int(m.engine_slots or 0) or int(m.chunk_size),
                prompt_width=self.prompt_length,
                processor=self._gen_processor,
                prefill_batch=int(m.prefill_batch or 4),
                steps_per_sync=int(m.engine_steps_per_sync or 8),
                paged_kv=bool(m.paged_kv),
                kv_block_size=int(m.kv_block_size or 128),
                kv_pool_blocks=int(m.kv_pool_blocks or 0),
                spec_decode=str(m.spec_decode or ""),
                spec_k=int(m.spec_k or 0),
                generator=self.seeded_generator(3),
                monitor=self._devicemon,
                # With several processes each sync quantum is guarded: a peer
                # that dies mid-decode ends this rank with exit 117 and the
                # slot states in its incident bundle. 0 leaves it unguarded.
                collective_deadline=float(self.config.train.collective_deadline) or None,
            )
        return self._rollout_engine

    def rollout_engine_variables(self, snapshot=None):
        """The engine's weight handoff: the module rollouts read (with its
        int8 decode copies when W8A16 is on): the live model, which the
        engine reads only while no train step runs (serial schedule, or
        staleness 0), or a boundary snapshot's module."""
        return self._decode_module(snapshot)

    def _shutdown_rollout_engine(self):
        engine, self._rollout_engine = self._rollout_engine, None
        if engine is not None:
            engine.shutdown()

    def _kl_coef(self) -> float:
        return float(self.kl_ctl.value)

    @torch.no_grad()
    def rollout_score_fused(self, tokens, mask, scores, gen_aux, timings=None, snapshot=None):
        """Scoring with the decode-collected statistics: only the frozen
        reference branch replays (for the KL term). The branch-hidden
        sequence is [prefill positions 0..P) ; per-step entries 1..
        (positions P..T-1) ; one zero row at T-1], which no query reads.
        Returns (logprobs, values, rewards, kl) [b, R]."""
        stats, prefill_extras = gen_aux
        P = self._batch_prompt_length(tokens)
        if timings is not None:
            timings["start"] = stamp(self.device)
        bh_steps = stats["branch_hidden"]
        bh = torch.cat([prefill_extras["branch_hidden"], bh_steps[:, 1:], torch.zeros_like(bh_steps[:, :1])], dim=1)
        rlabels, rmask = tokens[:, P:], mask[:, P:]
        model = self._decode_module(snapshot)
        if resolve_fused_head(model.cfg, self.device):
            rlp = model.forward_branch(
                bh, mask, logits_start=P - 1, labels=rlabels, labels_mask=rmask, params=self.extras
            )
        else:
            ref_logits = model.forward_branch(bh, mask, logits_start=P - 1, params=self.extras).float()
            rlp = logprobs_from_logits(ref_logits[:, :-1], rlabels)
        scores = self.put(scores, dtype=torch.float32)
        rewards, kl = kl_penalty_rewards(stats["logprob"], rlp, rmask, scores, self._kl_coef())
        if timings is not None:
            timings["end"] = stamp(self.device)
        return stats["logprob"], stats["value"], rewards, kl

    @torch.no_grad()
    def rollout_score(self, tokens, mask, scores, timings=None, snapshot=None):
        """Scoring by a full policy re-forward plus the reference pass (the
        path for models without a hydra branch, or with fused statistics
        off). Returns (logprobs, values, rewards, kl) [b, R]."""
        P = self._batch_prompt_length(tokens)
        if timings is not None:
            timings["start"] = stamp(self.device)
        model, extras = self._decode_module(snapshot), self.extras
        rlabels, rmask = tokens[:, P:], mask[:, P:]
        if resolve_fused_head(model.cfg, self.device):
            out = model(tokens, mask, collect_branch_hidden=True, logits_start=P - 1,
                        labels=rlabels, labels_mask=rmask)
            lp = out["logprobs"]
            if model.branch_layer >= 0:
                rlp = model.forward_branch(out["branch_hidden"], mask, logits_start=P - 1,
                                           labels=rlabels, labels_mask=rmask, params=extras)
            else:
                with swapped_params(model, extras):
                    rlp = model(tokens, mask, logits_start=P - 1, labels=rlabels, labels_mask=rmask)["logprobs"]
        else:
            out = model(tokens, mask, collect_branch_hidden=True, logits_start=P - 1)
            logits = out["logits"].float()
            if model.branch_layer >= 0:
                ref_logits = model.forward_branch(out["branch_hidden"], mask, logits_start=P - 1,
                                                  params=extras).float()
            else:
                with swapped_params(model, extras):
                    ref_logits = model(tokens, mask, logits_start=P - 1)["logits"].float()
            lp = logprobs_from_logits(logits[:, :-1], rlabels)
            rlp = logprobs_from_logits(ref_logits[:, :-1], rlabels)
        values = out["values"].float()[:, P - 1 : -1]
        scores = self.put(scores, dtype=torch.float32)
        rewards, kl = kl_penalty_rewards(lp, rlp, rmask, scores, self._kl_coef())
        if timings is not None:
            timings["end"] = stamp(self.device)
        return lp, values, rewards, kl

    # ----------------------------------------------------------------- train

    def eval_generate(self, input_ids, attention_mask, batch_index: int):
        """Eval sampling: a generator per (train.seed, step, batch)."""
        return self.rollout_generate(input_ids, attention_mask,
                                     generator=self.seeded_generator(2, self.iter_count, batch_index),
                                     rows=self.sample_rows(np.asarray(input_ids).shape[0]))

    def build_train_step(self):
        """The PPO loss of this trainer's model and config (dense, or the
        fused head when ``resolve_fused_head`` picks it)."""
        self._loss_fn = make_ppo_loss_fn(self.model, self.config, self.prompt_length,
                                         resolve_fused_head(self.model.cfg, self.device))
        return self.train_step

    @torch.no_grad()
    def _numerics_forward(self, batch):
        """The eager policy forward of a train batch for graftnum's bisector
        (the probe taps see its activations; outputs discarded)."""
        if isinstance(batch, PackedPPOBatch):
            self.model(batch.input_ids, batch.attention_mask, position_ids=batch.position_ids,
                       segment_ids=batch.segment_ids)
            return
        all_ids = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
        all_mask = torch.cat([batch.query_mask, batch.response_mask], dim=1)
        self.model(all_ids, all_mask, logits_start=self.prompt_length - 1)

    def post_backward_callback(self, stats=None):
        """Queue this step's policy-vs-rollout mean_kl for the adaptive
        controller; the buffered updates apply in order at the next flush."""
        if isinstance(self.kl_ctl, FixedKLController):
            return
        if stats and "mean_kl" in stats:
            self._kl_pending.append(stats["mean_kl"])
            if len(self._kl_pending) >= max(self.config.train.log_interval, 8):
                self._flush_kl_updates()

    def _flush_kl_updates(self):
        pending, self._kl_pending = self._kl_pending, []
        for v in pending:
            v = float(v)
            if not np.isfinite(v):
                # A guard-skipped step's stats are garbage: feeding its NaN to
                # the controller would poison every later KL-penalty reward.
                continue
            self.kl_ctl.update(v, self.config.train.batch_size)

    def learn(self):
        """The base loop, then the queued KL-controller updates are applied,
        so ``kl_ctl.value`` is current when training ends. The rollout
        producer or the fleet feed (in the base loop's teardown) and then
        the rollout engine, if any, shut down on the way out. A
        ``FleetDegradedExit`` is a clean stop: the feed drained what it
        could, ``post_epoch_callback`` saved the rollback checkpoint, and
        the teardown wrote the abort marker; it returns None."""
        try:
            stats = super().learn()
            self._flush_kl_updates()
        except FleetDegradedExit as e:
            print(f"[fleet] learner stopped cleanly: {e}", flush=True)
            return None
        finally:
            self._shutdown_rollout_engine()
        return stats

    def _fleet_bootstrap(self):
        """Learner and colocated roles: iteration 0's store arrives through
        the episode stream (``trainer.api`` calls this in place of the first
        ``make_experience``), after the v0 publish that lets a worker's
        staleness gate open. A resumed learner publishes its restored
        step. In a learner world every rank builds the feed; its transports
        are rank 0's."""
        from trlx_tpu_torch.fleet.runner import FleetLearnerFeed

        if self._resumed:
            self.iter_count = int(self.step)
        self._fleet_feed = FleetLearnerFeed(self, self.orch)
        self.store = self._fleet_feed.bootstrap()

    def host_state_dict(self) -> dict:
        """The base host state plus the KL coefficient, after the queued
        controller updates are applied."""
        self._flush_kl_updates()
        d = super().host_state_dict()
        d["kl_coef"] = float(self.kl_ctl.value)
        return d

    def load_host_state(self, d: dict):
        super().load_host_state(d)
        if "kl_coef" in d:
            v = float(d["kl_coef"])
            # A poisoned coefficient would NaN every KL-penalty reward.
            if np.isfinite(v):
                self.kl_ctl.value = v

    def load(self, directory=None):
        """The base load (in place), then the rollout engine, if built, is
        told that its weights changed under it (``invalidate_weights``): its
        prefix blocks hold KV of the replaced weights under a version the
        next handoff may repeat. Its buffers and captured decode graphs
        stay: they read the model's tensors, which the load refreshed in
        place (a watchdog rollback inside ``learn()`` loads so)."""
        name = super().load(directory)
        if self._rollout_engine is not None:
            self._rollout_engine.invalidate_weights()
        return name

    def _create_train_loader(self):
        return self.store.create_loader(self.config.train.batch_size, shuffle=True, pack=self._pack_train_batch,
                                        rows_multiple=self._pack_rows_multiple)

    def prepare_learning(self):
        """The loaders and step counts; with the overlapped pipeline, the
        rollout producer starts here: parked at staleness 0 (its first
        store waits for the first boundary), generating iteration 1's store
        at once at staleness S > 0, from a snapshot of the weights that
        built iteration 0's."""
        self.eval_dataloader = self.eval_pipeline.create_loader(self.config.train.batch_size)
        self.train_dataloader = self._create_train_loader()
        self.n_updates_per_batch = self.config.method.ppo_epochs
        self.total_steps = min(
            self.config.train.epochs * self.n_updates_per_batch * len(self.train_dataloader),
            self.config.train.total_steps,
        )
        orch = self.orch
        if self.overlap_rollouts and orch is not None and self._rollout_producer is None:
            num_rollouts = self.config.method.num_rollouts

            def produce(store, index, snapshot, staleness, stop):
                with producer_collectives(), self._producer_stream_ctx():
                    orch.make_experience(num_rollouts, self.iter_count, store=store, snapshot=snapshot,
                                         staleness=staleness, stop=stop)

            def new_store():
                return PPORolloutStorage(self.pad_token_id, record_staleness=True)

            def prepare(snapshot):
                # The boundary a store reads, adopted (on the producer's stream)
                # before the store counts as started.
                if snapshot is not None:
                    with self._producer_stream_ctx():
                        snapshot["weights"].adopt()

            # With several processes the producers stop at one point of every
            # rank's program and read one boundary's weights a store
            # (RolloutProducer's ``collective``).
            collective = world_size() > 1
            self._rollout_producer = RolloutProducer(produce, new_store, max_staleness=self.max_staleness,
                                                     collective=collective, prepare=prepare if collective else None)
            self._rollout_producer.start(snapshot=self._rollout_snapshot() if self.max_staleness > 0 else None)

    def _producer_stream_ctx(self):
        """The producer's stream: its own where the mesh's collectives run
        over NCCL (two communicators' kernels must not share one stream in
        rank-dependent orders), the current one otherwise."""
        if world_size() == 1 or self.mesh.group("world").backend != "nccl":
            return nullcontext()
        if self._producer_stream is None:
            self._producer_stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._producer_stream)

    def post_epoch_callback(self):
        """Back to rollouts: apply the queued KL updates, then either
        publish the post-train weights and consume the next stream batch
        (the fleet; a ``FleetDegradedExit`` saves the rollback checkpoint
        first, then unwinds), generate the next iteration's experience into
        the cleared store (serial), or release the producer (one iteration
        consumed, with the boundary snapshot at staleness > 0) and take its
        next store. Then the train loader is rebuilt and the phase window
        logged."""
        self._flush_kl_updates()
        if self.decode_weight_quant and self._rollout_producer is None and obs_numerics.enabled():
            # The samplers re-quantize the int8 copies from the live policy
            # before this phase's rollouts (refresh_weight_copies).
            obs_numerics.record_weight_quant(self.model, version=self.iter_count)
        if self._fleet_feed is not None:
            try:
                self._fleet_feed.consume_done()
                self.store = self._fleet_feed.next_store()
            except FleetDegradedExit:
                self._fleet_stopped = True
                self.save()
                raise
        elif self._rollout_producer is None:
            self.store.clear_history()
            self.orch.make_experience(self.config.method.num_rollouts, self.iter_count)
        else:
            if self._rollout_producer.collective:
                self._rollout_producer.wait_due_started()
            snapshot = self._rollout_snapshot() if self.max_staleness > 0 else None
            self._rollout_producer.consume_done(snapshot=snapshot)
            self.store = self._rollout_producer.next_store()
        self.train_dataloader = self._create_train_loader()
        self._log_phase_window()

    def _prepare_batch(self, batch):
        """The base staging, metering the train phase's tokens (the padded
        row area the step processes, times the PPO epochs that reuse the
        batch) and, for a packed batch, its fill. Appended per batch (safe
        from the prefetch thread), reduced at the next phase window."""
        if isinstance(batch, PackedPPOBatch):
            tokens = int(np.prod(batch.input_ids.shape))
            if batch.extras and "pack_fill" in batch.extras:
                self._window_fill.append(float(batch.extras["pack_fill"]))
        else:
            tokens = batch.query_tensors.shape[0] * (batch.query_tensors.shape[1] + batch.response_tensors.shape[1])
        self._window_tokens.append(tokens * max(1, getattr(self, "n_updates_per_batch", 1)))
        return super()._prepare_batch(batch)

    def _log_phase_window(self):
        """Log the phase window at the rollout boundary: one window spans
        train(iteration n) + rollout/score(iteration n+1), the span the
        pipeline overlaps."""
        stats = self._phase_timer.window()
        window_tokens, self._window_tokens = self._window_tokens, []
        window_fill, self._window_fill = self._window_fill, []
        train_s = stats.get("time/train_s", 0.0)
        if window_tokens and train_s > 0:
            stats["train_tokens_per_s"] = float(sum(window_tokens)) / train_s
        if window_fill:
            stats["train_batch_fill"] = float(np.mean(window_fill))
        if self._last_exp_stats:
            stats.update(self._last_exp_stats)
        # Device telemetry on the phase window's cadence: the window's FLOPs
        # over exactly these seconds.
        stats.update(self._flush_device_telemetry({
            "train": stats.get("time/train_s", 0.0), "rollout": stats.get("time/rollout_s", 0.0),
            "score": stats.get("time/score_s", 0.0), "wall": stats.get("time/window_wall_s", 0.0)}))
        if self._health is not None:
            # The detectors' state at the rollout boundary, in the window record.
            stats.update(self._health.gauges())
        self._last_phase_stats = stats  # the progress line folds it in
        self.tracker.log(stats, step=self.iter_count)
        if self._metrics_exporter is not None:
            self._metrics_exporter.update(stats, step=self.iter_count)

    def _shutdown_experience_pipeline(self):
        """learn()'s teardown: shut the fleet feed down (the abort marker,
        except on preemption: this learner resumes into the same fleet_dir
        and the worker keeps serving it) and stop the rollout producer (also
        on the preemption and early-return paths)."""
        feed, self._fleet_feed = self._fleet_feed, None
        if feed is not None:
            reason = "preempted" if self._preempted else "degraded" if self._fleet_stopped else "complete"
            feed.shutdown(reason=reason)
        producer, self._rollout_producer = self._rollout_producer, None
        if producer is not None:
            producer.shutdown()


@torch.no_grad()
def reward_model_scores(rm: LMWithValueHead, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scalar reward per sequence [b], f32: the reward model's value head at
    the last valid token (the sequence-classifier convention), with no LM
    head pass. An all-padding row scores 0."""
    vals = rm(tokens, mask, compute_logits=False)["values"].float()
    B, T = tokens.shape
    last_ix = T - 1 - torch.argmax(torch.flip(mask, dims=[1]).int(), dim=-1)
    has_valid = (mask.sum(dim=-1) > 0).float()
    return vals[torch.arange(B, device=vals.device), last_ix] * has_valid


def make_ppo_loss_fn(model: LMWithValueHead, config: TRLConfig, prompt_length: int, use_fused: bool):
    """``loss_fn(batch) -> (loss, stats)`` over a device ``PPORLBatch``: the
    policy re-forward of query + response, then ``ppo_loss``. Dense: logits
    → f32 log_softmax; fused: the label logprobs come from the fused head
    (its autograd Function), so no [b, R, V] logits exist. With
    ``method.pack_train_batch`` over a ``PackedPPOBatch``: the segment-masked
    forward in labels mode (the fused head where ``routed_logprob`` takes
    it, as the JAX package's packed loss does) and the segment-aware loss,
    per-sequence stats over ``train.batch_size`` episodes."""
    m = config.method
    P = prompt_length
    kw = dict(gamma=m.gamma, lam=m.lam, cliprange=m.cliprange, cliprange_value=m.cliprange_value, vf_coef=m.vf_coef)

    if m.pack_train_batch:

        def packed_loss_fn(batch: PackedPPOBatch):
            out = model(batch.input_ids, batch.attention_mask, position_ids=batch.position_ids,
                        segment_ids=batch.segment_ids, labels=batch.labels, labels_mask=batch.loss_mask)
            return ppo_loss(out["logprobs"], out["values"].float(), batch.old_logprobs, batch.old_values,
                            batch.rewards, batch.loss_mask, segment_ids=batch.segment_ids,
                            n_seqs=config.train.batch_size * node_count(), **kw)

        return packed_loss_fn

    def loss_fn(batch: PPORLBatch):
        all_ids = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
        all_mask = torch.cat([batch.query_mask, batch.response_mask], dim=1)
        if use_fused:
            out = model(all_ids, all_mask, logits_start=P - 1, labels=all_ids[:, P:],
                        labels_mask=batch.response_mask)
            lp = out["logprobs"]
        else:
            out = model(all_ids, all_mask, logits_start=P - 1)
            lp = logprobs_from_logits(out["logits"].float()[:, :-1], all_ids[:, P:])
        vpred = out["values"].float()[:, P - 1 : -1]
        return ppo_loss(lp, vpred, batch.logprobs, batch.values, batch.rewards, batch.response_mask, **kw)

    return loss_fn
