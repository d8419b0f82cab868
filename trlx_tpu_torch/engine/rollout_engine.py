"""Slot-based continuous-batching rollout engine (the counterpart of
``trlx_tpu.engine.rollout_engine``).

Whole-batch decode (``ops/generate.py``) pays for the slowest row of every
chunk. Here a fixed pool of ``n_slots`` decode slots shares one KV cache,
and a finished slot is refilled from the prompt queue instead of idling:

- Per-slot lengths are data. Every slot carries its own write offset
  (``write_pos``) and cache-validity row, and the model's vector
  ``cache_index`` writes each slot's KV at its own offset; the attention
  bias and the decode kernels take ragged rows.
- A host slot manager admits same-width prompt groups from a
  ``PromptSlotQueue`` into free slots through a batched prefill, runs
  ``steps_per_sync`` decode steps for every slot, and harvests finished
  slots. The decode steps have no host sync inside and update the slot
  state in place: ``finished`` / ``n_gen`` cross to the host once per
  ``step()``. On a CUDA device the whole call of ``steps_per_sync`` steps is
  captured once as a CUDA graph (``ops.cuda_graph``) and replayed, as the
  JAX engine runs one compiled scan; it is captured again only when the
  decoding module is another object. Where tp's all-reduces are staged
  through the host (a gloo mesh) the steps run eagerly, by the sampler's
  rule (``ops.generate.graphs_allowed``).
- With ``paged_kv`` the cache is one shared block pool plus per-slot block
  tables (``paged_pool.BlockPool``); prompts whose leading blocks are
  bit-identical share them, and the admitted slot prefills only its suffix.
- Weights are handed over explicitly and versioned (``update_weights``):
  the engine decodes with the module it is handed, the version is staged
  and adopted at the top of the next ``step()``, and harvested episodes
  carry per-token version spans. The paged prefix registry is flushed on a
  version switch, since KV depends on the weights.

- A soft-prompt model (``n_soft_tokens``) prefills its learned prefix into
  rows [0, n_soft) of every admitted slot; decode and verify steps run with
  ``prepend_soft=False`` at the slot's absolute offset. The paged pool
  refuses soft prompts, as in the JAX package.
- A model with int8 decode weights (``ops.w8a16``) prefills, decodes and
  verifies inside ``models.lm.decode_weights``; the handoff re-quantizes
  stale copies in place.
- Speculative decoding (``spec_decode="ngram"``, ``spec_k >= 2``): a host
  drafter (``engine.drafters``) proposes spec_k - 1 tokens per slot, and ONE
  verify call runs the model over every slot's window [its own next token,
  the drafts] (q_len = spec_k, vector ``cache_index``, the einsum attention
  path as in the JAX package: there is no multi-token kernel) and keeps each
  slot's longest accepted prefix: greedy, a draft is accepted iff it is the
  argmax after its predecessor, so the tokens equal the non-speculative
  engine's; sampled, by rejection sampling against a point-mass drafter.
  Rejected positions are rolled back by the cache mask alone. The cache has
  a scratch tail of spec_k - 1 columns so a live window never clamps. On a
  CUDA device the verify call is captured as a CUDA graph like the decode
  call; the drafts reach it through a static buffer copied before replay.
  The JAX engine's ``spec_verify_supported`` blesses TPU tile layouts
  (``ops/tiling.py``, not ported by decision) and has no counterpart here.

Parity: with greedy sampling a slot's tokens equal whole-batch
``generate``'s for the same prompt (the new token's mask bit is written
before the model call, eos is written with its mask bit, post-finish
positions hold pad / mask 0). Sampling draws from one device generator for
all slots (``generator``; the PPO orchestrator reseeds it at each phase's
start from the absolute chunk index), so sampled runs match the JAX engine
only in distribution.

Host spans (``observability.spans``, when armed): ``engine/prefill`` per
prefill group, ``engine/decode`` / ``engine/verify`` per sync quantum.

Multi-process contract (a mesh of several ranks, ``parallel.mesh``): every
rank runs this same slot manager over the same prompt set (the node set's
whole, submitted on every rank; never a rank's slice), so every rank makes
the same admission, pool and harvest decisions and launches the same
decode steps. The slot state and the KV pool are replicated over the data
ranks; the attention heads in the cache are the rank's tp heads, as the
model splits them, so the only collectives inside a decode step are the
model's tp all-reduces (and the fsdp pieces' compute copies are held whole,
gathered once per weight version). What the slot manager reads from the
device at a sync (the finish flags, the tokens generated, a spec engine's
accepted totals and windows) is identical on every rank by construction:
every rank's engine draws from one generator seed at the same offsets, its
inputs are identical (the same prompts, weights that are replicas or the
same tp pieces), and each decode step's kernels are deterministic, as is
the tp all-reduce, which hands every rank of a group the same sum. Each
decision is folded into a rolling crc32 (``schedule_fingerprint``; the tags
and payloads of the JAX engine, so the two crcs are equal for one
schedule), which the orchestrator checks across ranks at the end of each
phase (``resilience.distributed.verify_engine_schedule``): the check should
only ever catch a bug. With ``collective_deadline`` set and several
processes, each sync quantum (admission, decode or verify, and the read
back) runs under ``collective_guard("engine/decode_sync")`` whose incident
detail is ``slot_states()``: a peer that dies mid-decode ends the others
with exit 117 and the in-flight slots in the bundle. Sharding the slots
over the data ranks is not done (ROADMAP §B).

Not ported here: the dispatch lock, sanitizer hooks, and the slot timeline
of graftscope.
"""

import time
import zlib
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from trlx_tpu_torch.engine.paged_pool import BlockPool, PoolExhausted
from trlx_tpu_torch.models.lm import decode_weights, init_cache, init_paged_cache, refresh_weight_copies
from trlx_tpu_torch.observability import graftscope
from trlx_tpu_torch.observability import numerics as obs_numerics
from trlx_tpu_torch.observability.spans import trace_span
from trlx_tpu_torch.ops.cuda_graph import CudaGraph, StepGraph
from trlx_tpu_torch.ops.generate import graphs_allowed
from trlx_tpu_torch.ops.sampling import GenerateConfig, process_logits_default, sample_categorical
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptSlotQueue
from trlx_tpu_torch.utils import sanitize


@dataclass
class Episode:
    """One finished rollout episode, as host arrays.

    ``prompt_ids``/``prompt_mask`` are the left-padded rows as submitted;
    ``response_ids``/``response_mask`` are right-padded to max_new_tokens
    with whole-batch ``generate``'s convention (eos mask 1, post-finish
    positions pad / mask 0). ``version_spans`` is the per-token weight
    version, ``[(version, n_tokens), ...]`` in generation order, summing to
    ``decode_steps``; ``weight_version`` is the last span's."""

    prompt_ids: np.ndarray
    prompt_mask: np.ndarray
    response_ids: np.ndarray
    response_mask: np.ndarray
    decode_steps: int
    weight_version: Optional[int] = None
    version_spans: Optional[list] = None


class RolloutEngine:
    """Continuous-batching decode over a fixed slot pool.

        engine.update_weights(model, version=it)   # explicit handoff
        engine.submit(prompt_ids, prompt_mask)     # any width <= prompt_width
        while collecting:
            episodes = engine.step()               # admit -> decode -> harvest

    ``step()`` admits queued prompts (batched prefill once at least
    ``prefill_batch`` slots are free, or at once when nothing is live),
    runs ``steps_per_sync`` decode steps, and returns the finished episodes
    in completion order. ``model`` fixes the config and device; the module
    handed to ``update_weights`` is the one that decodes. With
    ``spec_decode`` ("ngram"; "off" or "" disarm it) each ``step()`` runs one
    verify call of ``spec_k`` window positions per slot instead, drafted by
    ``drafter`` (default ``make_drafter(spec_decode)``). ``_eager`` (tests
    and the chip smoke's comparison only) launches every decode step
    eagerly on a CUDA device instead of replaying the graph."""

    def __init__(
        self,
        model,
        gen_cfg: GenerateConfig,
        *,
        n_slots: int,
        prompt_width: int,
        processor: Optional[Callable] = None,
        prefill_batch: int = 4,
        steps_per_sync: int = 8,
        paged_kv: bool = False,
        kv_block_size: int = 128,
        kv_pool_blocks: int = 0,
        spec_decode: str = "",
        spec_k: int = 0,
        drafter=None,
        generator: Optional[torch.Generator] = None,
        collective_deadline: Optional[float] = None,
        monitor=None,
        _eager: bool = False,
    ):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.model = model
        self.cfg = model.cfg
        self.device = next(model.parameters()).device
        self.gcfg = gen_cfg
        self.processor = processor
        self.n_slots = int(n_slots)
        self.prompt_width = int(prompt_width)
        self.n_soft = int(self.cfg.n_soft_tokens)
        spec = (spec_decode or "").lower()
        if spec == "off":
            spec = ""
        if spec not in ("", "ngram", "model"):
            raise ValueError(f"unknown spec_decode mode: {spec_decode!r}")
        self.spec_decode = spec
        self.spec_k = int(spec_k) if spec_k else (4 if spec else 0)
        if spec and self.spec_k < 2:
            raise ValueError(f"spec_k must be >= 2 when spec_decode is armed, got {self.spec_k}")
        self.cache_len = self.n_soft + self.prompt_width + int(gen_cfg.max_new_tokens)
        if spec:
            # Scratch tail: the last budgeted token can sit at cache_len - 1,
            # and a window of spec_k written there must not clamp back onto
            # valid entries. Scratch columns never get a mask bit.
            self.cache_len += self.spec_k - 1
        self.paged = bool(paged_kv)
        if self.paged:
            if self.n_soft:
                raise ValueError(
                    "paged_kv does not compose with soft prompts yet: the learned prefix would alias every "
                    "slot's block 0 content (disable method.paged_kv or n_soft_tokens)"
                )
            # One shared physical pool and per-slot block tables over a
            # virtual cache of kv_len = ceil(cache_len / block) * block keys.
            self.block_size = int(kv_block_size)
            if self.block_size < 1:
                raise ValueError(f"kv_block_size must be >= 1, got {kv_block_size}")
            self.blocks_per_slot = -(-self.cache_len // self.block_size)
            self.kv_len = self.blocks_per_slot * self.block_size
            # Default: every slot's full span plus the trash block 0, the
            # fixed layout's capacity.
            self.n_blocks = int(kv_pool_blocks) or (1 + self.n_slots * self.blocks_per_slot)
            self.pool = BlockPool(self.n_blocks, self.block_size, self.blocks_per_slot, self.n_slots)
        else:
            self.kv_len = self.cache_len
            self.pool = None
        self.prefill_batch = max(1, int(prefill_batch))
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.queue = PromptSlotQueue()
        self._slot_meta = [None] * self.n_slots
        self._free = list(range(self.n_slots))
        self._slot_free_t = [None] * self.n_slots  # when each slot was last harvested (graftscope's refill wait)
        self._variables = None  # the module that decodes
        self.weight_version = None
        self._weights_invalid = False  # set by invalidate_weights(), read at the next adoption
        self._staged = None  # (module, version) adopted at the next step()
        self._staged_lock = sanitize.make_lock("engine.staged_weights")
        self._n_gen_host = None  # per-slot n_gen at the last sync
        self._state = None
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self.generator = generator
        # The rolling crc32 of every slot-manager decision (admissions, pool
        # rows, harvests, accepted totals): equal on every rank iff their
        # schedules matched (the module docstring's contract).
        self._schedule_crc = 0
        # The deadline of each sync quantum's collective guard with several
        # processes; None leaves it unguarded.
        self._collective_deadline = collective_deadline
        # The sampler's capture rule (ops.generate.graphs_allowed): eager where
        # tp's all-reduces are staged through the host (gloo).
        self._use_graph = not _eager and graphs_allowed(self.device)
        self._graph = None  # (the module it was captured with, its StepGraph)
        if spec:
            from trlx_tpu_torch.engine.drafters import make_drafter

            self.drafter = drafter if drafter is not None else make_drafter(spec, gen_cfg.pad_token_id)
            # Each slot's frontier token on the host: the drafter's basis,
            # set at admission and after every verify sync.
            self._spec_last_tok = np.zeros((self.n_slots,), dtype=np.int64)
            self._verify = self._verify_call  # the call _decode() launches (or captures) in place of _decode_call
        else:
            self.drafter = None
            self._spec_last_tok = None
            self._verify = None
        if monitor is not None:
            # Device telemetry: the decode (or verify) call is a monitored
            # program, its first dispatch counted (the eager call; the
            # capture after it launches nothing), every replay charged alike.
            self._decode = monitor.wrap("engine/verify_step" if spec else "engine/decode_step", self._decode,
                                        phase="rollout")
        self._reset_counters()

    # ------------------------------------------------------------- host side

    def _reset_counters(self):
        self._decode_calls = 0
        self._decode_steps = 0
        self._slot_steps = 0
        self._live_row_steps = 0
        self._gen_tokens = 0
        self._refills = 0
        self._prefill_calls = 0
        self._completed = 0
        self._decode_wall = 0.0
        self._prefill_wall = 0.0
        self._weight_switches = 0
        self._switches_coalesced = 0
        self._spec_proposed = 0
        self._spec_accepted = 0

    @property
    def live_slots(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def idle(self) -> bool:
        """Nothing queued and nothing in flight."""
        return self.live_slots == 0 and len(self.queue) == 0

    @property
    def pending(self) -> int:
        """Episodes still owed: queued + in flight."""
        return self.live_slots + len(self.queue)

    def update_weights(self, variables, version=None):
        """Hand over the module to decode with (same config and device as
        the engine's model), under ``version``. Callable at any time; the
        handoff is staged and adopted at the top of the next ``step()``, and
        a second push before then replaces the first (coalesced). With
        graftnum armed the handoff's int8 round-trip error is recorded here,
        never in a decode step."""
        if obs_numerics.enabled():
            obs_numerics.record_weight_handoff(variables, version=version)
        with self._staged_lock:
            sanitize.race_access(self, "staged_weights", write=True)
            if self._staged is not None and self._staged[1] != version:
                self._switches_coalesced += 1
            self._staged = (variables, version)

    def _adopt_staged(self):
        """Swap in the staged weights at the sync boundary. Live slots whose
        version changes record the switch position (their tokens so far),
        so harvest splits their episodes into version spans."""
        with self._staged_lock:
            sanitize.race_access(self, "staged_weights", write=True)
            staged, self._staged = self._staged, None
        if staged is None:
            return
        variables, version = staged
        # The engine moves between threads only at phase boundaries (the
        # producer thread with the overlap, the main thread otherwise), each
        # move ordered by the producer's join or the phase handoff and
        # passing through a fresh handoff: the slot state's history restarts.
        sanitize.race_forget(self)
        sanitize.race_access(self, "slot_state", write=True)
        if self._variables is not None and version != self.weight_version and self.live_slots > 0:
            for i, meta in enumerate(self._slot_meta):
                if meta is not None:
                    pos = int(self._n_gen_host[i]) if self._n_gen_host is not None else 0
                    meta.setdefault("switches", []).append((pos, version))
            self._weight_switches += 1
        changed = version != self.weight_version or self._weights_invalid
        self._weights_invalid = False
        if self.paged and changed:
            # Prefix blocks hold KV of the outgoing weights: never share them
            # into a new-version slot.
            self.pool.flush_registry()
        # The decode graph reads the module's bf16 weight copies at fixed
        # addresses: cast the updated weights into them.
        refresh_weight_copies(variables)
        self._variables = variables
        self.weight_version = version

    def invalidate_weights(self):
        """The module's values changed without a new version (a checkpoint
        load, a watchdog rollback): the next adopted handoff counts as a
        version switch whatever its version, so the prefix registry is
        flushed. Buffers and captured graphs stay. A flag the next
        ``step()`` reads: safe to set from another thread."""
        self._weights_invalid = True

    def submit(self, input_ids, attention_mask) -> int:
        """Queue left-padded prompts ([n, width] or [width]) for decode."""
        ids = np.asarray(input_ids, dtype=np.int32)
        msk = np.asarray(attention_mask, dtype=np.int32)
        if ids.ndim == 1:
            ids, msk = ids[None], msk[None]
        if ids.shape[1] > self.prompt_width:
            raise ValueError(f"prompt width {ids.shape[1]} exceeds the engine's prompt_width {self.prompt_width}")
        return self.queue.push_rows(ids, msk)

    @torch.no_grad()
    def step(self):
        """One sync quantum: adopt staged weights, admit queued prompts into
        free slots, advance every live slot ``steps_per_sync`` tokens,
        harvest finished slots. Returns list[Episode]."""
        self._adopt_staged()
        if self._variables is None:
            raise RuntimeError("RolloutEngine.update_weights() must be called before step()")
        self._ensure_state()
        sanitize.race_access(self, "slot_state", write=True)
        with decode_weights(self._variables), self._sync_guard():
            self._admit()
            n_live = self.live_slots
            if n_live == 0:
                return []
            if self.spec_decode:
                with trace_span("engine/verify", slots=n_live, k=self.spec_k):
                    finished, n_gen = self._step_verify(n_live)
            else:
                with trace_span("engine/decode", slots=n_live, steps=self.steps_per_sync):
                    finished, n_gen = self._step_decode()

        episodes = []
        done = [i for i in range(self.n_slots) if self._slot_meta[i] is not None and finished[i]]
        if done:
            self._roll_schedule("harvest", *done)
            # A copy: on the CPU .cpu() aliases the slot buffer, which the
            # next admission overwrites.
            toks = self._state["tokens"].cpu().numpy().copy()
            R = int(self.gcfg.max_new_tokens)
            scope = graftscope.scope()
            now = time.time()
            for i in done:
                meta, self._slot_meta[i] = self._slot_meta[i], None
                steps = int(n_gen[i])
                if scope is not None:
                    # The slot timeline: occupancy row, straggler and
                    # accept-rate samples keyed by prompt width.
                    width, admit_t = meta.get("width", 0), meta.get("admit_t")
                    scope.record_harvest(i, width, steps, (now - admit_t) if admit_t is not None else 0.0)
                    disp = int(meta.get("dispatches", 0))
                    if self.spec_decode and disp > 0:
                        scope.record_spec_accept(i, width, steps / float(disp * self.spec_k))
                    self._slot_free_t[i] = now
                rmask = np.zeros((R,), dtype=np.int32)
                rmask[:steps] = 1
                spans = self._build_spans(meta, steps)
                episodes.append(Episode(
                    prompt_ids=meta["prompt_ids"], prompt_mask=meta["prompt_mask"], response_ids=toks[i],
                    response_mask=rmask, decode_steps=steps, weight_version=spans[-1][0], version_spans=spans,
                ))
                self._free.append(i)
                if self.paged:
                    self.pool.release(i)
            if self.paged:
                # Point the harvested rows' device tables at the trash block
                # BEFORE a freed block can be reissued: dead rows keep
                # writing (clamped) in every decode step.
                self._state["block_tables"][torch.as_tensor(done, device=self.device)] = 0
            self._completed += len(done)
        scope = graftscope.scope()
        if self.paged and scope is not None:
            # The pool's occupancy at this sync boundary (host bookkeeping).
            scope.record_pool(self.pool.used_blocks(), self.pool.cached_blocks(), len(self.pool.free), self.n_blocks,
                              self._pool_frag(), self.pool.hits_total, self.pool.tokens_saved_total)
        return episodes

    def _step_decode(self):
        """``steps_per_sync`` decode steps, then the one host sync. Returns
        the host (finished, n_gen) arrays."""
        t0 = time.perf_counter()
        live_steps = self._decode()
        st = self._state
        packed = torch.cat([st["finished"].int(), st["n_gen"].int(), live_steps.int().view(1)]).cpu().numpy()
        S = self.n_slots
        finished, n_gen, live = packed[:S].astype(bool), packed[S:2 * S], int(packed[-1])
        self._n_gen_host = n_gen
        self._decode_wall += time.perf_counter() - t0
        self._decode_calls += 1
        self._decode_steps += self.steps_per_sync
        self._slot_steps += self.steps_per_sync * self.n_slots
        self._live_row_steps += live
        self._gen_tokens += live
        return finished, n_gen

    def _step_verify(self, n_live: int):
        """One speculative sync quantum: draft spec_k - 1 tokens per slot on
        the host, run ONE verify call over every slot's window, adopt each
        slot's longest accepted prefix. Dispatches count calls; tokens count
        ACCEPTED tokens only. Returns the host (finished, n_gen) arrays."""
        K, S = self.spec_k, self.n_slots
        drafts = self._propose_drafts()
        t0 = time.perf_counter()
        st = self._state
        st["drafts"].copy_(torch.from_numpy(drafts))
        self._decode()
        packed = torch.cat([st["finished"].int(), st["n_gen"].int(), st["accepted"].int(),
                            st["window"].reshape(-1)]).cpu().numpy()
        finished, n_gen = packed[:S].astype(bool), packed[S:2 * S]
        acc, window = packed[2 * S:3 * S].astype(np.int64), packed[3 * S:].reshape(S, K)
        acc_total = int(acc.sum())
        self._n_gen_host = n_gen
        self._decode_wall += time.perf_counter() - t0
        self._decode_calls += 1
        self._decode_steps += K
        self._slot_steps += K * S
        self._live_row_steps += acc_total
        self._gen_tokens += acc_total
        self._spec_proposed += K * n_live
        self._spec_accepted += acc_total
        # A pure function of the slot state: folded in, a numerics
        # divergence between ranks is named before it desyncs admissions.
        self._roll_schedule("verify", acc_total)
        self._observe_accepted(acc, window)
        return finished, n_gen

    def _propose_drafts(self):
        """The [S, K] windows' drafts. Column 0 is a placeholder: the verify
        call puts the model's own next token there (accepted by force, so a
        live slot gains >= 1 token a call and a cold drafter decodes at the
        non-speculative rate). Columns 1..K-1 are the drafter's chain from
        the slot's frontier token shifted by one: its first guess is column
        0's, so its continuations sit where they would if that guess is the
        model's token."""
        K = self.spec_k
        drafts = np.full((self.n_slots, K), int(self.gcfg.pad_token_id), dtype=np.int32)
        for i, meta in enumerate(self._slot_meta):
            if meta is None:
                continue
            chain = self.drafter.propose(i, int(self._spec_last_tok[i]), K)
            drafts[i, 1:] = np.asarray(chain[1:], dtype=np.int32)
            meta["dispatches"] = meta.get("dispatches", 0) + 1
        return drafts

    def _observe_accepted(self, acc, window):
        """Fold each slot's ACCEPTED tokens (never the rejected drafts) into
        the drafter and advance the host frontier tokens."""
        for i, meta in enumerate(self._slot_meta):
            a = int(acc[i])
            if meta is None or a <= 0:
                continue
            toks = [int(self._spec_last_tok[i])] + [int(t) for t in window[i, :a]]
            self.drafter.observe(i, toks)
            self._spec_last_tok[i] = toks[-1]

    @staticmethod
    def _build_spans(meta, steps):
        """Per-token weight-version spans of one harvested slot,
        ``[(version, n_tokens), ...]`` summing to ``steps``: the recorded
        switches in push order, positions clamped to [0, steps], zero-length
        segments dropped, equal neighbours merged."""
        spans = []
        cur_v = meta["version"]
        cur_start = 0
        for pos, v in meta.get("switches", ()):
            pos = max(0, min(int(pos), int(steps)))
            if v == cur_v:
                continue
            if pos > cur_start:
                spans.append((cur_v, pos - cur_start))
                cur_start = pos
            cur_v = v
        if steps > cur_start or not spans:
            spans.append((cur_v, int(steps) - cur_start))
        return spans

    def _pop_admission_group(self):
        """The next same-width group to admit, or None. While any slot is
        live, wait until ``prefill_batch`` slots are free (or the whole
        queue fits); with nothing live, admit at once."""
        if not (self._free and len(self.queue)):
            return None
        want = min(self.prefill_batch, len(self.queue))
        if len(self._free) < want and self.live_slots > 0:
            return None
        return self.queue.pop_group(min(len(self._free), self.prefill_batch))

    def _admit(self) -> int:
        """Refill free slots from the queue through batched prefills."""
        if self.paged:
            return self._admit_paged()
        admitted = 0
        while True:
            group = self._pop_admission_group()
            if group is None:
                break
            width, ids, msk = group
            slots = [self._free.pop() for _ in range(ids.shape[0])]
            self._roll_schedule("admit", int(width), int(ids.shape[0]), *slots)
            t0 = time.perf_counter()
            with trace_span("engine/prefill", n=len(slots), width=int(width)):
                self._prefill(ids, msk, slots)
            self._prefill_wall += time.perf_counter() - t0
            for row, slot in enumerate(slots):
                self._slot_meta[slot] = {"prompt_ids": ids[row], "prompt_mask": msk[row],
                                         "version": self.weight_version}
                self._record_admit(slot, width)
                self._reset_drafter(slot, ids[row], msk[row])
            self._prefill_calls += 1
            self._refills += len(slots)
            admitted += len(slots)
        return admitted

    def _admit_paged(self) -> int:
        """Paged admission: the same batching, plus the pool. Each row is
        admitted against the pool all or nothing; the first row the pool
        cannot serve stops the group, and it and the rest re-queue until a
        harvest frees blocks. Admitted rows prefill in (width, hit) groups
        and then register their full-prompt blocks for later admissions."""
        admitted = 0
        while True:
            group = self._pop_admission_group()
            if group is None:
                break
            width, ids, msk = group
            n = int(ids.shape[0])
            rows = []  # (slot, row index, table row, hit tokens)
            for r in range(n):
                slot = self._free[-1]
                try:
                    tbl_row, hit = self.pool.admit(slot, self.weight_version, ids[r], msk[r])
                except PoolExhausted:
                    break
                self._free.pop()
                rows.append((slot, r, tbl_row, hit))
            if len(rows) < n:
                # Pool-bound: requeue the tail. A lone row always fits an idle
                # pool, so this happens only with live slots to wait on.
                self.queue.push_rows(ids[len(rows):], msk[len(rows):])
            if not rows:
                break
            self._roll_schedule("admit", int(width), len(rows), *[slot for slot, _, _, _ in rows])
            for slot, _, tbl_row, hit in rows:
                # Pool decisions too: a divergent allocator is named, not
                # read as silently different attention.
                self._roll_schedule("pool", slot, hit, *tbl_row)
            by_hit = {}
            for slot, r, tbl_row, hit in rows:
                by_hit.setdefault(hit, []).append((slot, r, tbl_row))
            for hit, sub in by_hit.items():
                slots = [s for s, _, _ in sub]
                rr = [r for _, r, _ in sub]
                tables = np.stack([t for _, _, t in sub]).astype(np.int32)
                t0 = time.perf_counter()
                with trace_span("engine/prefill", n=len(slots), width=int(width), hit=int(hit)):
                    self._prefill_paged(ids[rr][:, hit:], msk[rr], slots, tables)
                self._prefill_wall += time.perf_counter() - t0
                for slot, r in zip(slots, rr):
                    # Its prompt blocks are written (device order makes them
                    # visible to every later launch): let later admissions
                    # of the same (version, content) share them.
                    self.pool.register_prefix(slot, self.weight_version, ids[r], msk[r])
                    self._slot_meta[slot] = {"prompt_ids": ids[r], "prompt_mask": msk[r],
                                             "version": self.weight_version, "prefix_hit": int(hit)}
                    self._record_admit(slot, width)
                    self._reset_drafter(slot, ids[r], msk[r])
                self._prefill_calls += 1
            self._refills += len(rows)
            admitted += len(rows)
            if len(rows) < n:
                break
        return admitted

    def _record_admit(self, slot: int, width):
        """graftscope's slot timeline at an admission: it ends the slot's
        refill wait and starts its occupancy."""
        scope = graftscope.scope()
        if scope is None:
            return
        now = time.time()
        meta = self._slot_meta[slot]
        meta["admit_t"], meta["width"] = now, int(width)
        freed = self._slot_free_t[slot]
        scope.record_refill(slot, int(width), (now - freed) if freed is not None else None)

    def _reset_drafter(self, slot: int, ids, msk):
        """A spec engine's admitted slot: its frontier is the prompt's last
        column (rows are left-padded) and its drafter table starts from the
        prompt's tokens."""
        if self.spec_decode:
            self._spec_last_tok[slot] = int(ids[-1])
            self.drafter.reset_slot(slot, ids[msk > 0].tolist())

    def stats(self, reset: bool = True) -> dict:
        """Window gauges: slot occupancy (live-slot decode steps over the
        slot-steps paid), refill counters, the decode rate (the decode wall
        time ends in the per-step host sync, so it includes device time),
        and with ``paged_kv`` the pool's gauges and lifetime totals."""
        out = {
            "engine/slot_occupancy": self._live_row_steps / max(1, self._slot_steps),
            "engine/decode_steps": self._decode_steps,
            "engine/decode_calls": self._decode_calls,
            "engine/decode_dispatches": self._decode_calls,
            "engine/decode_tokens": self._gen_tokens,
            "engine/gen_tokens": self._gen_tokens,
            "engine/refills": self._refills,
            "engine/prefill_batches": self._prefill_calls,
            "engine/completed": self._completed,
            "engine/queue_depth": len(self.queue),
            "engine/free_slots": len(self._free),
            "engine/decode_wall_s": self._decode_wall,
            "engine/prefill_wall_s": self._prefill_wall,
            "engine/decode_tokens_per_s": self._gen_tokens / max(self._decode_wall, 1e-9),
            "engine/weight_switches": self._weight_switches,
            "engine/switches_coalesced": self._switches_coalesced,
        }
        if self.paged:
            out["engine/pool_blocks"] = self.n_blocks
            out["engine/pool_used_blocks"] = self.pool.used_blocks()
            out["engine/pool_cached_blocks"] = self.pool.cached_blocks()
            out["engine/pool_free_blocks"] = len(self.pool.free)
            out["engine/pool_frag_frac"] = self._pool_frag()
            out["engine/pool_evictions_total"] = self.pool.evictions
            out["engine/prefix_hits_total"] = self.pool.hits_total
            out["engine/prefill_tokens_saved_total"] = self.pool.tokens_saved_total
        if self.spec_decode:
            out["engine/spec_proposed"] = self._spec_proposed
            out["engine/spec_accepted"] = self._spec_accepted
            out["engine/spec_accept_rate"] = self._spec_accepted / max(1, self._spec_proposed)
        if reset:
            self._reset_counters()
        return out

    def _pool_frag(self) -> float:
        """Internal fragmentation of the referenced pool span: 1 - (tokens
        resident) / (referenced blocks x block_size), shared prefix blocks
        counted once."""
        used = self.pool.used_blocks()
        if used == 0:
            return 0.0
        toks = 0
        shared = set()
        for i, meta in enumerate(self._slot_meta):
            if meta is None:
                continue
            n_gen = int(self._n_gen_host[i]) if self._n_gen_host is not None else 0
            toks += min(len(meta["prompt_ids"]) + n_gen, self.kv_len) - int(meta.get("prefix_hit", 0))
            shared.update(self.pool.shared_blocks(i))
        toks += len(shared) * self.block_size
        return max(0.0, 1.0 - toks / float(used * self.block_size))

    def _roll_schedule(self, tag: str, *vals):
        """Fold one slot-manager decision into the rolling schedule crc:
        ``zlib.crc32`` of ``tag:v,v,...`` (the JAX engine's payload)."""
        payload = (tag + ":" + ",".join(str(int(v)) for v in vals)).encode()
        self._schedule_crc = zlib.crc32(payload, self._schedule_crc)

    def schedule_fingerprint(self) -> int:
        """The rolling crc32 of every admission, pool, harvest and verify
        decision this engine made: equal across ranks iff their schedules
        were (``resilience.distributed.verify_engine_schedule``)."""
        return self._schedule_crc

    def _sync_guard(self):
        """The collective guard of a sync quantum, armed with several
        processes and a deadline; a no-op context otherwise."""
        from trlx_tpu_torch.parallel.mesh import world_size

        if self._collective_deadline is None or world_size() <= 1:
            return nullcontext()
        from trlx_tpu_torch.resilience.distributed import collective_guard

        return collective_guard("engine/decode_sync", deadline=self._collective_deadline,
                                detail=lambda: {"slot_states": self.slot_states()})

    def slot_states(self) -> list:
        """Host summary of the in-flight slots: slot, prompt width, weight
        version, tokens at the last sync and recorded version switches."""
        out = []
        for i, meta in enumerate(self._slot_meta):
            if meta is None:
                continue
            out.append({
                "slot": i, "width": int(len(meta["prompt_ids"])), "version": meta["version"],
                "n_gen": int(self._n_gen_host[i]) if self._n_gen_host is not None else 0,
                "switches": [[int(p), v] for p, v in meta.get("switches", ())],
            })
        return out

    def abort(self):
        """Drop queued prompts and in-flight slots. Device buffers stay for
        the next phase and every slot is deactivated. With ``paged_kv`` the
        in-flight slots' blocks are released (the warm prefix cache stays:
        an abort is not a version change), the device tables point at the
        trash block, and the pool's leak audit runs."""
        self.queue.clear()
        if self.paged:
            for i, meta in enumerate(self._slot_meta):
                if meta is not None:
                    self.pool.release(i)
            self.pool.leak_audit(expect_idle=True)
        self._slot_meta = [None] * self.n_slots
        self._free = list(range(self.n_slots))
        if self._state is not None:
            self._state["active"].zero_()
            if self.paged:
                self._state["block_tables"].zero_()

    def shutdown(self):
        """Release the queue, the slots, the device state and the weight
        reference. Synchronous and idempotent: the engine owns no threads."""
        # Teardown runs after the producer's join, which ordered every
        # producer-side access before it.
        sanitize.race_forget(self)
        self.abort()
        with self._staged_lock:
            sanitize.race_access(self, "staged_weights", write=True)
            self._staged = None
        self._state = None
        self._graph = None
        self._variables = None
        self._n_gen_host = None

    # ----------------------------------------------------------- device side

    def _ensure_state(self):
        if self._state is not None:
            return
        cfg, dev = self.cfg, self.device
        S, T, R = self.n_slots, self.kv_len, int(self.gcfg.max_new_tokens)
        if self.paged:
            cache = init_paged_cache(cfg, self.n_blocks, self.block_size, dev)
        else:
            cache = init_cache(cfg, S, T, dev)
        self._state = {
            "cache": cache,
            "cache_mask": torch.zeros((S, T), dtype=torch.int32, device=dev),
            "write_pos": torch.zeros((S,), dtype=torch.int32, device=dev),
            "n_gen": torch.zeros((S,), dtype=torch.int32, device=dev),
            "tokens": torch.full((S, R), self.gcfg.pad_token_id, dtype=torch.int32, device=dev),
            "active": torch.zeros((S,), dtype=torch.bool, device=dev),
            "finished": torch.zeros((S,), dtype=torch.bool, device=dev),
            "last_token": torch.zeros((S,), dtype=torch.int32, device=dev),
            "last_logits": torch.zeros((S, cfg.vocab_size), dtype=torch.float32, device=dev),
            "last_hidden": torch.zeros((S, cfg.d_model), dtype=cfg.compute_dtype, device=dev),
            "live_steps": torch.zeros((), dtype=torch.int32, device=dev),  # the decode call's output
        }
        if self.spec_decode:
            K = self.spec_k
            self._state.update({
                "drafts": torch.zeros((S, K), dtype=torch.int32, device=dev),  # copied in before each call
                "accepted": torch.zeros((S,), dtype=torch.int32, device=dev),  # the verify call's outputs
                "window": torch.zeros((S, K), dtype=torch.int32, device=dev),
                # The draft token the last window rejected at its break (-1:
                # none): masked at the next window's position 0, so that
                # position draws from the exact residual distribution.
                "spec_resid": torch.full((S,), -1, dtype=torch.int32, device=dev),
            })
        if self.paged:
            # Every slot's virtual blocks point at the trash block until
            # admission assigns a span.
            self._state["block_tables"] = torch.zeros((S, self.blocks_per_slot), dtype=torch.int32, device=dev)

    def _reset_slots(self, slots, out, last_token, row_mask, write_pos):
        """The per-slot columns of freshly prefilled slots."""
        st = self._state
        st["cache_mask"][slots] = row_mask
        st["write_pos"][slots] = write_pos
        st["n_gen"][slots] = 0
        st["active"][slots] = True
        st["finished"][slots] = False
        st["tokens"][slots] = self.gcfg.pad_token_id
        st["last_logits"][slots] = out["logits"][:, -1].float()
        st["last_hidden"][slots] = out["hidden"][:, -1].to(st["last_hidden"].dtype)
        st["last_token"][slots] = last_token.to(torch.int32)
        if self.spec_decode:
            st["spec_resid"][slots] = -1

    def _prefill(self, prompt_ids, prompt_mask, slot_ids):
        """Batched prefill of a same-width group into its slots: the group
        runs through a mini cache of its width (plus the soft prefix) at the
        static offset 0 (the flash route on the card), whose leaves are then
        copied into the slot cache at [slots, :n_soft + width]."""
        dev = self.device
        ids = torch.as_tensor(prompt_ids, device=dev)
        pm = torch.as_tensor(prompt_mask, device=dev).to(torch.int32)
        slots = torch.as_tensor(slot_ids, dtype=torch.long, device=dev)
        j, W = ids.shape
        Ws = W + self.n_soft  # cache rows the prefill fills, the prefix first
        soft_pm = pm
        if self.n_soft:
            soft_pm = torch.cat([torch.ones((j, self.n_soft), dtype=torch.int32, device=dev), pm], dim=1)
        out = self._variables(input_ids=ids, attention_mask=pm, cache=init_cache(self.cfg, j, Ws, dev),
                              cache_index=0, cache_mask=soft_pm, logits_start=W - 1)
        for big_layer, mini_layer in zip(self._state["cache"], out["cache"]):
            for big, mini in zip(big_layer, mini_layer):
                big[slots, :Ws] = mini.to(big.dtype)
        row_mask = torch.zeros((j, self.kv_len), dtype=torch.int32, device=dev)
        row_mask[:, :Ws] = soft_pm
        self._reset_slots(slots, out, ids[:, -1], row_mask, Ws)

    def _prefill_paged(self, suffix_ids, prompt_mask, slot_ids, tables):
        """Paged prefill of a same-(width, hit) group: the first H = W - Ws
        virtual positions of each row are already in shared pool blocks, so
        only the suffix runs, written through the slot's table straight into
        the pool at the vector offset H (the einsum route: its offset is not
        a static zero). Positions come from the full row's mask, so suffix
        tokens get the phases of a full prefill."""
        dev = self.device
        suffix = torch.as_tensor(suffix_ids, device=dev)
        pm = torch.as_tensor(prompt_mask, device=dev).to(torch.int32)
        slots = torch.as_tensor(slot_ids, dtype=torch.long, device=dev)
        tbl = torch.as_tensor(tables, device=dev)
        j, Ws = suffix.shape
        W = pm.shape[1]
        H = W - Ws
        row_mask = torch.zeros((j, self.kv_len), dtype=torch.int32, device=dev)
        row_mask[:, :W] = pm
        out = self._variables(input_ids=suffix, attention_mask=pm[:, H:], cache=self._state["cache"],
                              cache_index=torch.full((j,), H, dtype=torch.int32, device=dev), cache_mask=row_mask,
                              block_tables=tbl, logits_start=Ws - 1)
        self._state["block_tables"][slots] = tbl
        # Rows are left-padded, so the suffix's last column is the prompt's
        # last token (the allocator keeps H < W).
        self._reset_slots(slots, out, suffix[:, -1], row_mask, W)

    def _decode(self):
        """The decode call (``steps_per_sync`` steps for every slot), or a
        spec engine's verify call, launched without a host sync: eagerly on
        the CPU; on a CUDA device the first call with a module runs eagerly
        and is then captured as a CUDA graph, which every later call
        replays. Returns the live slot-steps as a device scalar (a static
        buffer the next call overwrites)."""
        call = self._verify or self._decode_call
        if not self._use_graph:
            call()
        elif self._graph is not None and self._graph[0] is self._variables:
            self._graph[1].replay()
        else:
            call()
            self._graph = None  # the old graph's pool goes before the new capture
            gen = self.generator if self.gcfg.do_sample else None
            self._graph = (self._variables, StepGraph(call, CudaGraph(gen)))
        return self._state["live_steps"]

    def _decode_call(self):
        """The decode call, in place on the slot state. Per live slot it
        keeps ``generate``'s order: sample, write the token and its
        cache-mask bit, then run the model; finished and free slots write
        nothing visible (value-preserving buffer writes, a clamped cache
        write on a mask-0 column)."""
        gcfg, st = self.gcfg, self._state
        S, T, R = self.n_slots, self.kv_len, int(gcfg.max_new_tokens)
        dev = self.device
        ones = torch.ones((S, 1), dtype=torch.int32, device=dev)
        live_steps = st["live_steps"]
        live_steps.zero_()
        paged_kw = {"block_tables": st["block_tables"]} if self.paged else {}
        if self.n_soft:
            paged_kw["prepend_soft"] = False  # the prefix is in the cache
        for _ in range(self.steps_per_sync):
            live = st["active"] & ~st["finished"]
            step_col = st["n_gen"][:, None]
            if self.processor is not None:
                logits = self.processor(st["last_logits"], {"last_token": st["last_token"], "hidden": st["last_hidden"],
                                                             "step": step_col, "carry": {}})
            else:
                logits = process_logits_default(st["last_logits"], gcfg, step_col)
            if gcfg.do_sample:
                tok = sample_categorical(torch.softmax(logits.float(), dim=-1), self.generator)
            else:
                tok = torch.argmax(logits, dim=-1)
            tok = torch.where(live, tok.to(torch.int32), gcfg.pad_token_id)

            # Token at (slot, n_gen), value-preserving for non-live slots.
            w_ix = torch.clamp(st["n_gen"], max=R - 1).long()[:, None]
            cur_tok = st["tokens"].gather(1, w_ix)[:, 0]
            st["tokens"].scatter_(1, w_ix, torch.where(live, tok, cur_tok)[:, None])
            # Cache-mask bit at each live slot's write offset, before the model.
            c_ix = torch.clamp(st["write_pos"], max=T - 1)
            cur_bit = st["cache_mask"].gather(1, c_ix.long()[:, None])[:, 0]
            st["cache_mask"].scatter_(1, c_ix.long()[:, None], torch.where(live, 1, cur_bit)[:, None])

            hit_eos = tok == gcfg.eos_token_id if gcfg.eos_token_id is not None else torch.zeros_like(live)
            st["finished"].logical_or_(live & (hit_eos | (st["n_gen"] + 1 >= R)))

            out = self._variables(input_ids=tok[:, None], attention_mask=ones, cache=st["cache"], cache_index=c_ix,
                                  cache_mask=st["cache_mask"], **paged_kw)
            live_i = live.to(torch.int32)
            st["write_pos"].add_(live_i)
            st["n_gen"].add_(live_i)
            st["last_token"].copy_(torch.where(live, tok, st["last_token"]))
            st["last_logits"].copy_(out["logits"][:, 0])
            st["last_hidden"].copy_(out["hidden"][:, 0])
            live_steps.add_(live_i.sum(dtype=torch.int32))

    def _process(self, logits, last_token, hidden, step_col):
        """The logits chain of one window position (the decode call's, with
        an empty carry)."""
        if self.processor is not None:
            return self.processor(logits, {"last_token": last_token, "hidden": hidden, "step": step_col,
                                           "carry": {}})
        return process_logits_default(logits, self.gcfg, step_col)

    def _verify_call(self):
        """ONE speculative verify call for every slot, in place on the slot
        state (``trlx_tpu.engine.rollout_engine._verify_fn``).

        The window of a slot is [its own next token, drafts 1..K-1]: position
        0 comes from the frontier logits (argmax, or a draw with the last
        rejected draft masked out), so a live slot gains >= 1 token. The
        model runs once over every window (q_len = K at the vector offset
        ``write_pos``), then each slot keeps its longest accepted prefix:
        greedy, draft j is accepted iff it is the argmax of the processed
        logits after position j - 1; sampled, with probability p(draft), the
        first rejected draft kept in ``spec_resid``. Eos and the response
        budget stop a window. Rejected positions need no rollback beyond the
        mask: only the accepted prefix's cache-mask bits are set, and the
        next window rewrites the stale tail before any bit there is set.
        Writes ``accepted`` [S] and ``window`` [S, K] for the host."""
        gcfg, st = self.gcfg, self._state
        S, T, K, R = self.n_slots, self.kv_len, self.spec_k, int(gcfg.max_new_tokens)
        dev = self.device
        pad = gcfg.pad_token_id
        eos = gcfg.eos_token_id
        live = st["active"] & ~st["finished"]
        n_gen, wp = st["n_gen"].clone(), st["write_pos"].clone()

        def is_eos(t):
            return t == eos if eos is not None else torch.zeros_like(live)

        logits0 = self._process(st["last_logits"], st["last_token"], st["last_hidden"], n_gen[:, None])
        if gcfg.do_sample:
            vocab = torch.arange(logits0.shape[-1], device=dev)[None, :]
            logits0 = torch.where(vocab == st["spec_resid"][:, None].long(), -1e9, logits0)
            tok0 = sample_categorical(torch.softmax(logits0.float(), dim=-1), self.generator)
        else:
            tok0 = torch.argmax(logits0, dim=-1)
        tok0 = torch.where(live, tok0.to(torch.int32), pad)
        window = torch.cat([tok0[:, None], st["drafts"][:, 1:]], dim=1)
        window = torch.where(live[:, None], window, pad)

        # The whole window is visible to itself before the call (the per-row
        # causal bias hides each query's successors). Live rows never clamp
        # (the scratch tail); dead rows' clamped writes land on mask-0 columns.
        pos = torch.arange(T, device=dev)[None, :]
        in_window = (pos >= wp[:, None]) & (pos < (wp + K)[:, None]) & live[:, None]
        mask_apply = torch.maximum(st["cache_mask"], in_window.to(torch.int32))
        kw = {"block_tables": st["block_tables"]} if self.paged else {}
        if self.n_soft:
            kw["prepend_soft"] = False
        out = self._variables(input_ids=window, attention_mask=torch.ones((S, K), dtype=torch.int32, device=dev),
                              cache=st["cache"], cache_index=torch.clamp(wp, max=T - K), cache_mask=mask_apply,
                              **kw)
        L = out["logits"].float()  # [S, K, V]

        accepted = live.to(torch.int32)
        stop = live & is_eos(window[:, 0])
        resid = torch.full((S,), -1, dtype=torch.int32, device=dev)
        acc_prev = live
        for j in range(1, K):
            lj = self._process(L[:, j - 1], window[:, j - 1], out["hidden"][:, j - 1], (n_gen + j)[:, None])
            alive = acc_prev & ~stop & ((n_gen + j) < R)
            if gcfg.do_sample:
                p_d = torch.softmax(lj.float(), dim=-1).gather(1, window[:, j:j + 1].long())[:, 0]
                match = torch.rand((S,), generator=self.generator, device=dev) < p_d
                resid = torch.where(alive & ~match, window[:, j], resid)
            else:
                match = window[:, j] == torch.argmax(lj, dim=-1).to(torch.int32)
            acc_j = alive & match
            accepted = accepted + acc_j.to(torch.int32)
            stop = stop | (acc_j & is_eos(window[:, j]))
            acc_prev = acc_j

        # Commit the accepted prefix.
        a = torch.where(live, accepted, 0)
        n_gen2, wp2 = n_gen + a, wp + a
        keep = (pos >= wp[:, None]) & (pos < wp2[:, None]) & live[:, None]
        st["cache_mask"].copy_(torch.maximum(st["cache_mask"], keep.to(torch.int32)))
        rpos = torch.arange(R, device=dev)[None, :]
        vals = window.gather(1, torch.clamp(rpos - n_gen[:, None], 0, K - 1).long())
        put = (rpos >= n_gen[:, None]) & (rpos < n_gen2[:, None]) & live[:, None]
        st["tokens"].copy_(torch.where(put, vals, st["tokens"]))
        st["finished"].logical_or_(live & (stop | (n_gen2 >= R)))
        ix = torch.clamp(a - 1, min=0).long()
        rows = torch.arange(S, device=dev)
        st["last_token"].copy_(torch.where(live, window[rows, ix], st["last_token"]))
        st["last_logits"].copy_(torch.where(live[:, None], L[rows, ix], st["last_logits"]))
        st["last_hidden"].copy_(torch.where(live[:, None], out["hidden"][rows, ix].to(st["last_hidden"].dtype),
                                            st["last_hidden"]))
        st["write_pos"].copy_(wp2)
        st["n_gen"].copy_(n_gen2)
        if gcfg.do_sample:
            st["spec_resid"].copy_(torch.where(live, resid, st["spec_resid"]))
        st["accepted"].copy_(a)
        st["window"].copy_(window)
        st["live_steps"].copy_(a.sum(dtype=torch.int32))
