"""ILQL trainer: offline Q-learning with advantage-steered decoding (the
counterpart of ``trlx_tpu.trainer.ilql``).

``trlx_tpu_torch.train(dataset=...)`` runs ``ILQLTrainer`` →
``OfflineOrchestrator.make_experience`` (the dataset into an
``ILQLRolloutStorage``) → ``learn()``: each step is the ILQL loss (double-Q
TD, expectile V, CQL, AWAC) and its backward, the non-finite guard, clip +
AdamW; every ``steps_for_target_q_sync`` steps the target Q heads are blended
toward the online ones (Polyak, in place). ``evaluate()`` decodes with the
sampler steered by the TARGET heads' advantage.

The train step has two routes, chosen once as the JAX package chooses them:
dense (materialized [b, T, V] logits and [b, A, V] Qs) and fused, where the
AWAC term comes from the fused LM head and each online Q head's value and
CQL term at the dataset action from the fused head over its f32 hidden
(Q = logprob + logsumexp, CQL NLL = -logprob), so no vocabulary-wide tensor
exists; the target Q at the action is a gather of the head's output columns.
"""

from typing import Dict

import numpy as np
import torch

from trlx_tpu_torch.data import ILQLBatch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.heads import LMWithILQLHeads, swapped_params, trainable_mask
from trlx_tpu_torch.models.hf_import import build_lm_config, load_or_init_params
from trlx_tpu_torch.models.lm import FullParam, compute_weight, full_weight, placement_of, tp_group
from trlx_tpu_torch.parallel import collectives as coll
from trlx_tpu_torch.ops.fused_logprob import fused_logprob_eligible, routed_logprob
from trlx_tpu_torch.ops.generate import make_generate_fn
from trlx_tpu_torch.ops.ilql_loss import action_tokens, ilql_loss, ilql_loss_terms
from trlx_tpu_torch.ops.modeling import global_ratio, loss_group, topk_mask
from trlx_tpu_torch.ops.sampling import NEG_INF, GenerateConfig, make_bigram_mask_processor
from trlx_tpu_torch.pipeline.ilql_pipeline import ILQLRolloutStorage
from trlx_tpu_torch.trainer import register_model
from trlx_tpu_torch.trainer.base import BaseTrainer


def _gather_positions(hidden: torch.Tensor, ixs: torch.Tensor) -> torch.Tensor:
    """hidden [b, T, D] at positions ixs [b, n] → [b, n, D]."""
    return torch.gather(hidden, 1, ixs.long()[..., None].expand(-1, -1, hidden.shape[-1]))


@register_model("ilql")
@register_model("ILQLModel")
@register_model("AccelerateILQLModel")
@register_model("TPUJaxILQLModel")
class ILQLTrainer(BaseTrainer):
    """The ILQL trainer on one device. ``device`` defaults to CUDA (and
    raises where there is none); tests pass ``device="cpu"``. Parameters
    are initialized from ``train.seed``; ``load_params`` replaces them and
    the target heads (``params_from_jax`` of the JAX package's params and
    extras). The store is filled by ``OfflineOrchestrator``."""

    def __init__(self, config: TRLConfig, device=None, **kwargs):
        super().__init__(config, device=device, **kwargs)
        m = config.method
        gen_kwargs = dict(m.gen_kwargs)
        self.beta = float(gen_kwargs.pop("beta", m.betas[0] if m.betas else 1.0))
        self.decode_top_k = int(gen_kwargs.pop("top_k", 20))
        self.decode_temperature = float(gen_kwargs.pop("temperature", 1.0))
        self.prompt_length = int(gen_kwargs.pop("prompt_length", 0)) or max(
            config.train.seq_length - int(gen_kwargs.get("max_new_tokens", config.train.seq_length // 2)),
            1,
        )
        if "max_new_tokens" not in gen_kwargs and "max_length" not in gen_kwargs:
            gen_kwargs["max_length"] = config.train.seq_length
        self.gen_cfg = GenerateConfig.from_gen_kwargs(
            gen_kwargs, prompt_len=self.prompt_length, pad_token_id=self.pad_token_id,
            eos_token_id=self.eos_token_id,
        )

        self.load_log = {}  # the HF load's record (bytes, seconds); None for a model built from scratch
        self.model = self.get_arch(config)
        self.extras = self.make_extras()
        self.store: ILQLRolloutStorage = None
        self.build_train_state()
        self._generate_fn = make_generate_fn(
            self.model, self.gen_cfg, processor=self._make_ilql_processor(), carry_keys=("qs", "vs"),
            step_stats_fn=self._decode_step_stats,
        )
        self._maybe_resume()  # the target heads are part of the saved state; ILQL adds no host state

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

    def get_arch(self, config: TRLConfig) -> LMWithILQLHeads:
        """The ILQL heads model, seeded from ``train.seed``, its trunk loaded
        from ``model.model_path`` when the config names a checkpoint; the
        bottom n_layer - num_layers_unfrozen blocks are frozen."""
        lm_cfg = self.finalize_lm_config(build_lm_config(config))
        model = LMWithILQLHeads(lm_cfg, two_qs=config.method.two_qs, device=self.device)
        self.load_log["policy"] = load_or_init_params(model, config, self.seeded_generator(1))
        self.opt_mask = trainable_mask(model, lm_cfg, config.model.num_layers_unfrozen)
        for name, p in model.named_parameters():
            p.requires_grad_(name in self.opt_mask)
        return model

    def make_extras(self) -> Dict[str, torch.Tensor]:
        """The target Q heads: copies of the online heads' parameters."""
        prefixes = tuple(f"{name}." for name in self.model.head_names())
        return {n: p.detach().clone() for n, p in self.model.named_parameters() if n.startswith(prefixes)}

    # ------------------------------------------------------------ generation

    def _make_ilql_processor(self):
        """The advantage-steered logits chain: log-softmax of the LM logits
        plus beta times the advantage min(Q1, Q2) - V (the carried values of
        the TARGET heads, which ``rollout_generate`` swaps in), top-k, then
        the temperature; a bigram ``logit_mask`` forbids its transitions
        first."""
        beta, top_k, temperature = self.beta, self.decode_top_k, self.decode_temperature
        bigram = None if self.logit_mask is None else make_bigram_mask_processor(self.logit_mask)

        def processor(logits, state):
            logits = logits.float()
            if bigram is not None:
                logits = bigram(logits, state)
            qs, vs = state["carry"]["qs"], state["carry"]["vs"]
            q = torch.minimum(qs[0], qs[1]) if len(qs) > 1 else qs[0]
            adv = q.float() - vs.float()[..., None]
            pi_beta = torch.log_softmax(logits, dim=-1)
            pi_top = torch.clamp(topk_mask(pi_beta + beta * adv, top_k), min=NEG_INF)
            return pi_top / temperature

        return processor

    @staticmethod
    def _decode_step_stats(tok, state):
        """Per decode step, Q(s, tok) and V(s) of the target heads that
        steered the sample, from the sampler's carry."""
        qs, vs = state["carry"]["qs"], state["carry"]["vs"]
        q = torch.minimum(qs[0], qs[1]) if len(qs) > 1 else qs[0]
        q_tok = torch.gather(q.float(), -1, tok[:, None].long())[:, 0]
        return {"q": q_tok, "v": vs.float()}

    def rollout_generate(self, input_ids, attention_mask, generator=None):
        """Prefill + decode steered by the target heads (swapped into the
        model for the call). Returns (tokens, mask) [b, P + R]; logs the
        decode-time Q, V and advantage distributions."""
        with swapped_params(self.model, self.extras):
            tokens, mask, dstats = self._generate_fn(self.put(input_ids), self.put(attention_mask), generator,
                                                     rows=self.sample_rows(np.asarray(input_ids).shape[0]))
        if self.tracker.enabled:
            self._log_decode_stats(dstats, mask)
        return tokens, mask

    def _log_decode_stats(self, dstats, mask):
        P = self.prompt_length
        q, v, rmask = self.to_host((dstats["q"], dstats["v"], mask[:, P:]))
        valid = rmask.astype(bool)
        self.tracker.log_histogram("decode/qs", q[valid], step=self.iter_count)
        self.tracker.log_histogram("decode/vs", v[valid], step=self.iter_count)
        self.tracker.log_histogram("decode/adv", (q - v)[valid], step=self.iter_count)

    def eval_generate(self, input_ids, attention_mask, batch_index: int):
        """Eval sampling: a generator per (train.seed, step, batch)."""
        return self.rollout_generate(input_ids, attention_mask,
                                     generator=self.seeded_generator(2, self.iter_count, batch_index))

    # ------------------------------------------------------------ train step

    def use_fused(self) -> bool:
        """The JAX package's route choice: the fused head when
        ``fused_logprob`` is "force", or "auto" on a CUDA device with an
        eligible (d_model, vocab) shape."""
        cfg = self.model.cfg
        mode = cfg.extra.get("fused_logprob", "auto")
        return mode == "force" or (
            mode == "auto" and self.device.type == "cuda" and fused_logprob_eligible(cfg.d_model, cfg.vocab_size)
        )

    def build_train_step(self):
        self._loss_fn = make_ilql_loss_fn(self.model, self.config, lambda: self.extras, self.use_fused())
        return self.train_step

    # ------------------------------------------------------------- callbacks

    @torch.no_grad()
    def _polyak_sync(self):
        """target ← α·online + (1 − α)·target, in place, so the target
        tensors keep their addresses (a captured decode graph and the bf16
        copies of them follow)."""
        alpha = float(self.config.method.alpha)
        online = dict(self.model.named_parameters())
        for name, t in self.extras.items():
            t.lerp_(online[name].detach(), alpha)

    def post_backward_callback(self, stats=None):
        if self.iter_count % self.config.method.steps_for_target_q_sync == 0:
            self._polyak_sync()

    def prepare_learning(self):
        self.eval_dataloader = self.eval_pipeline.create_loader(self.config.train.batch_size)
        self.train_dataloader = self.store.create_loader(self.config.train.batch_size, shuffle=True)
        self.n_updates_per_batch = 1
        self.total_steps = min(self.config.train.epochs * len(self.train_dataloader), self.config.train.total_steps)

    # -------------------------------------------------------------- tokenize

    def tokenize_ilql(self, samples):
        """Samples → token arrays: a text sample is BOS + its tokens + EOS,
        truncated to ``train.seq_length`` keeping the leading tokens (so
        action and state indices stay aligned from the start); a token-array
        sample is taken as it is."""
        out = []
        for text in samples:
            if not isinstance(text, str):
                out.append(np.asarray(text).reshape(-1))
                continue
            if self.tokenizer is None:
                raise ValueError("text samples need a tokenizer: set model.tokenizer_path or pass token-id arrays")
            ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
            if self.tokenizer.bos_token_id is not None:
                ids = [self.tokenizer.bos_token_id] + ids
            if self.tokenizer.eos_token_id is not None:
                ids = ids + [self.tokenizer.eos_token_id]
            out.append(np.asarray(ids[: self.config.train.seq_length], dtype=np.int32))
        return out


def make_ilql_loss_fn(model: LMWithILQLHeads, config: TRLConfig, get_extras, use_fused: bool):
    """``loss_fn(batch) -> (loss, stats)`` over a device ``ILQLBatch``, on the
    fused or the dense route; ``get_extras()`` gives the live target heads."""
    m = config.method
    cfg = model.cfg
    mode = cfg.extra.get("fused_logprob", "auto")
    dtype = cfg.compute_dtype
    kw = dict(gamma=m.gamma, tau=m.tau, cql_scale=m.cql_scale, awac_scale=m.awac_scale)

    def whole(extras, name, dt):
        # A parameter (a target head's, from the extras) whole: gathered
        # over fsdp and tp on a sharded mesh.
        t, pl = extras[name], placement_of(model, name)
        return compute_weight(t, dt) if pl is None else full_weight(t, dt, pl)

    def mlp_hidden(extras, name, x):
        # MLPHead.layers_0 + relu in the compute dtype, over raw tensors.
        return torch.relu(x.to(dtype) @ whole(extras, f"{name}.layers_0.kernel", dtype)
                          + whole(extras, f"{name}.layers_0.bias", dtype))

    def gathered_head_logit(extras, name, x, actions):
        # The target heads feed only the TD targets at the dataset action: a
        # gather of layers_1's columns instead of all V outputs.
        h = mlp_hidden(extras, name, x).float()
        k1 = whole(extras, f"{name}.layers_1.kernel", torch.float32)  # [D2, V]
        b1 = whole(extras, f"{name}.layers_1.bias", torch.float32)
        w = k1.t()[actions.long()]  # [b, A, D2]
        return (h * w).sum(-1) + b1[actions.long()]

    def fused_loss_fn(batch: ILQLBatch):
        labels = batch.input_ids[:, 1:]
        attn1 = batch.attention_mask[:, 1:]
        out = model(batch.input_ids, batch.attention_mask, states_ixs=batch.states_ixs,
                    actions_ixs=batch.actions_ixs, labels=labels, labels_mask=attn1, compute_q_heads=False)
        attn = attn1.float()
        loss_awac = global_ratio((-out["logprobs"] * attn).sum(), attn.sum(), loss_group(), min_den=1.0)
        hs_actions = _gather_positions(out["hidden"], batch.actions_ixs)
        actions = action_tokens(batch.input_ids, batch.actions_ixs)
        Qs, cql_nlls = [], []
        for name in model.head_names():
            head = getattr(model, name)
            # Under tp each rank holds its columns of the hidden: the fused
            # head runs over the whole of it and of layers_1 (gathered), its
            # gradients cut back to this rank's pieces.
            h = coll.gather_from(head.hidden(hs_actions).float(), tp_group(), -1) if cfg.tp_heads > 1 else \
                head.hidden(hs_actions).float()
            k1, b1 = head.layers_1.kernel, head.layers_1.bias
            pk, pb = head.layers_1.placement.get("kernel"), head.layers_1.placement.get("bias")
            whole_head = (None, None) if pk is None else (FullParam(k1, pk), FullParam(b1, pb))
            lp, lse, _ = routed_logprob(h, k1, actions, b1, tied=False, mode=mode, whole=whole_head)
            Qs.append(lp + lse)  # the label logit
            cql_nlls.append(-lp)
        extras = get_extras()
        with torch.no_grad():
            targetQs = [gathered_head_logit(extras, name, hs_actions, actions) for name in model.head_names()]
        return ilql_loss_terms(Qs, targetQs, cql_nlls, out["vs"], batch.rewards, batch.dones, loss_awac, **kw)

    def dense_loss_fn(batch: ILQLBatch):
        out = model(batch.input_ids, batch.attention_mask, states_ixs=batch.states_ixs,
                    actions_ixs=batch.actions_ixs)
        hs_actions = _gather_positions(out["hidden"], batch.actions_ixs)
        with torch.no_grad(), swapped_params(model, get_extras()):
            target_qs = model.compute_qs(hs_actions)
        return ilql_loss(out["logits"].float(), out["qs"], target_qs, out["vs"], batch.input_ids,
                         batch.attention_mask, batch.actions_ixs, batch.rewards, batch.dones, **kw)

    return fused_loss_fn if use_fused else dense_loss_fn
