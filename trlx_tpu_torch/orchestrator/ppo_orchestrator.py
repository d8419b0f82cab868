"""PPO experience generation (the counterpart of
``trlx_tpu.orchestrator.ppo_orchestrator.PPOOrchestrator.make_experience``).

Chunked path: per prompt chunk the trainer generates (prefill + decode,
with the fused rollout statistics for hydra models), the host decodes and
calls the user's ``reward_fn``, the trainer scores (a frozen-branch replay
plus the KL-penalty rewards), and the rows are pushed into the rollout
store. The next chunk's generation is launched before the host scores the
current one, so its device work queues behind the current chunk without
threads.

Engine path (``method.rollout_engine``): every prompt of the phase is
submitted to the trainer's ``RolloutEngine`` up front, finished episodes
stream back in completion order, and they are assembled into chunks at the
trainer's full prompt width and scored unfused (``rollout_score``).

With an on-device reward model (``rl.has_reward_model``) both paths score a
chunk with ``rollout_score_rm`` instead: the reward model's scores and the
policy and reference passes, all on the device, with no decode and no host
reward.

With the overlapped pipeline (``rl.overlap_rollouts``) host decode and
``reward_fn`` run on a FIFO ``ScoreWorker`` thread (unless a reward model
scores), so this thread keeps generating and scoring on the device; FIFO
keeps the serial path's reward-call and push order. With several processes
a scored chunk is finished when the queue is full or the phase drains,
never because its score happens to be ready early: the collectives of
finishing it must come at the same point on every rank. The rollout producer
calls ``make_experience`` with a fresh ``store``, the boundary ``snapshot``
(adopted here, at the store's start: the rollouts of one store read one
weight version), the store's ``staleness`` (a column of a store that
records it) and a ``stop`` poll checked between chunks. With prompt
buckets the chunks decode at their bucket's width and the stored queries
are left-padded to the trainer's ``prompt_length``.

``score`` runs ``reward_fn`` through ``call_with_retries`` with
``train.reward_fn_retries`` / ``reward_fn_backoff`` / ``reward_fn_timeout``
(inline and on the score worker; the timeout's own daemon thread nests
under either), and fires the fault plan's reward drills keyed by the
reward-call index: ``reward_exc``, ``reward_hang``, and ``reward_drift``
(which latches the health monitor's observed offset). With the health
monitor armed every scored chunk feeds it (reward, sentinels, and a lineage
record with its weight version, and on the engine path its version spans).
Host spans (when armed): ``rollout/generate``, ``rollout/decode``,
``rollout/reward_fn``, ``rollout/score_device`` and ``rollout/push``.

On a mesh with data axes (several processes) the chunked path's chunk is
the node's ``chunk_size`` rows (a node is a JAX host): each data rank
generates its rows, the reward runs once a chunk on the main process over
every node's rows, each rank scores its rows on the device, and every rank
of a node stores the node's rows, so the store and the train loader's
batches are those of a one-process run.

The engine path on several processes follows the engine's multi-process
contract (``engine.rollout_engine``): every rank submits the same prompt
set (the node set's whole: every node's prompts), so its slot manager makes
the same decisions; a chunk of harvested episodes is split as the chunked
path splits its chunk (the reward over every node's rows on the main
process, each data rank scoring its rows of its node's, every rank storing
its node's). The sync ticks carry ``mid_decode_host_kill``, the heartbeat
says ``rollout``, and the phase ends with ``verify_engine_schedule`` under
``collective_guard("engine/schedule_verify")`` with the slot states as its
incident detail.

The fleet (``trlx_tpu_torch.fleet``): ``chunks_per_unit`` is the elastic
fleet's work-unit width and ``seek_chunks`` positions the prompt stream at
any unit's shard, so any worker reproduces any unit's prompts. On the
engine path ``make_experience(..., weight_poll=...)`` polls once per engine
sync and pushes a fresher version into the running engine
(``RolloutEngine.update_weights``, coalesced to the latest); the phase's
``version_spans`` aggregate is returned with its statistics. The chunked
path has no sync boundary to adopt at mid-phase: it leaves a poller unused,
as the JAX package does.
"""

import os
import time
from collections import deque

import numpy as np

from trlx_tpu_torch.device import elapsed_s
from trlx_tpu_torch.observability.spans import complete as span_complete, trace_span
from trlx_tpu_torch.orchestrator import Orchestrator, register_orchestrator
from trlx_tpu_torch.parallel.mesh import node_count, world_size
from trlx_tpu_torch.pipeline.overlap import ScoreWorker
from trlx_tpu_torch.resilience.faults import FaultInjected
from trlx_tpu_torch.resilience.retry import call_with_retries


@register_orchestrator
class PPOOrchestrator(Orchestrator):
    def __init__(self, model, pipeline, reward_fn, metric_fn=None, chunk_size: int = 512):
        super().__init__(pipeline, model)
        self.chunk_size = chunk_size
        self.pipeline_loader = self.pipeline.create_loader(self.chunk_size, shuffle=True)
        self.pipeline_iterator = iter(self.pipeline_loader)
        self._chunks_consumed = 0
        self._reward_calls = 0
        self.reward_log = []  # per reward call: its index, attempts and wall seconds
        self.schedule_crcs = []  # the engine's schedule crc at the end of each engine phase
        self.rl_model.orch = self
        self.rl_model.reward_fn = reward_fn
        self.rl_model.metric_fn = metric_fn

    def score(self, texts):
        """The user's reward on decoded samples: on the main process, with
        bounded retries on an exception or a timeout, broadcast to every
        rank. The reward drills of the fault plan fire here, keyed by this
        call's index."""
        rl = self.rl_model
        t = rl.config.train
        self._reward_calls += 1
        call_index = self._reward_calls
        fault_plan = rl.fault_plan
        attempts = []

        def call():
            attempts.append(time.perf_counter())
            if fault_plan:
                if fault_plan.fire("reward_exc", call_index):
                    raise FaultInjected(f"injected reward_fn exception (call {call_index})")
                if fault_plan.fire("reward_hang", call_index):
                    # Well past the timeout, so the timeout decides.
                    time.sleep(max(t.reward_fn_timeout, 0.1) * 3)
                if fault_plan.fire("reward_drift", call_index) and rl._health is not None:
                    # The health monitor's observed reward shifts from this
                    # call's index on; training rewards stay as they are.
                    rl._health.inject_reward_drift(from_call=call_index)
            return rl.reward_fn(texts)

        t0 = time.perf_counter()
        scores = rl.host_reward(texts, call=lambda: call_with_retries(
            call, retries=t.reward_fn_retries, backoff=t.reward_fn_backoff, timeout=t.reward_fn_timeout,
            description="reward_fn"))
        self.reward_log.append({"call": call_index, "attempts": len(attempts), "wall_s": time.perf_counter() - t0,
                                "last_attempt_s": time.perf_counter() - attempts[-1] if attempts else 0.0})
        return scores

    def _next_prompt_batch(self):
        try:
            batch = next(self.pipeline_iterator)
        except StopIteration:
            self.pipeline_iterator = iter(self.pipeline_loader)
            batch = next(self.pipeline_iterator)
        self._chunks_consumed += 1
        return batch

    def chunks_per_unit(self, num_rollouts: int) -> int:
        """Prompt chunks one experience phase consumes: the elastic fleet's
        work-unit width (unit u owns chunks [u*w, (u+1)*w))."""
        return max(1, -(-int(num_rollouts) // max(1, int(self.chunk_size))))

    def seek_chunks(self, target: int):
        """Position the prompt stream at absolute chunk ``target``. The
        loader's shuffle is seeded, so the chunk sequence is the same on
        every worker; seeking backward rebuilds the loader (the same
        sequence from 0) and both directions skip forward by discarding
        chunks. Every sampling generator derives from the absolute chunk
        index (``chunk_rng``), so a seeked unit is the unit."""
        target = int(target)
        if target < self._chunks_consumed:
            self.pipeline_loader = self.pipeline.create_loader(self.chunk_size, shuffle=True)
            self.pipeline_iterator = iter(self.pipeline_loader)
            self._chunks_consumed = 0
        while self._chunks_consumed < target:
            self._next_prompt_batch()

    def _generate_next_chunk(self, snapshot=None):
        """Launch one chunk's generation from the module ``snapshot`` names
        (the live one for None). The sampling generator is a pure function
        of (train.seed, absolute chunk index). On a mesh with data axes the
        chunk is the node's and this data rank generates its rows of it
        (drawing the node's sampling noise and keeping its rows)."""
        rl = self.rl_model
        snap_kw = {} if snapshot is None else {"snapshot": snapshot}
        generator = rl.chunk_rng(self._chunks_consumed)
        batch = self._next_prompt_batch()
        P = batch["input_ids"].shape[1]
        ids, mask = rl.local_rows(batch["input_ids"]), rl.local_rows(batch["attention_mask"])
        rows = rl.sample_rows(ids.shape[0])
        timings = {}
        if rl.fused_rollout:
            tokens, mask, stats, prefill = rl.rollout_generate_fused(
                ids, mask, generator=generator, timings=timings, rows=rows, **snap_kw
            )
            return tokens, mask, P, (stats, prefill), timings
        tokens, mask = rl.rollout_generate(ids, mask, generator=generator, timings=timings, rows=rows, **snap_kw)
        return tokens, mask, P, None, timings

    def _host_score(self, args):
        """The host boundary: decode, then the user's reward. Runs on the
        score worker with the overlapped pipeline, inline otherwise. Returns
        (scores, the reward call's index)."""
        tokens_h, mask_h, step = args
        with trace_span("rollout/decode", step=step):
            samples = self.rl_model.decode(tokens_h, mask_h)
        with trace_span("rollout/reward_fn", step=step):
            scores = np.asarray(self.score(samples), dtype=np.float32)
        return scores, self._reward_calls

    def _note_chunk(self, tokens_h, mask_h, P, scores, weight_version, staleness, step, reward_call=None,
                    version_spans=None):
        """The health feed of one scored chunk: reward drift over its mean
        score, the degenerate-sample sentinels, its lineage record."""
        monitor = self.rl_model._health
        if monitor is not None:
            monitor.observe_chunk(tokens_h, mask_h, P, scores=scores, weight_version=weight_version,
                                  staleness=staleness, step=step, reward_call=reward_call,
                                  version_spans=version_spans)

    def _score_worker(self):
        """(worker, depth), or (None, 0) where scoring stays inline (no
        overlap, or a reward model scores on the device)."""
        rl = self.rl_model
        if not rl.overlap_rollouts or rl.has_reward_model:
            return None, 0
        depth = max(1, int(rl.config.method.score_queue_depth or 2))
        return ScoreWorker(self._host_score, depth=depth), depth

    @staticmethod
    def _drain_ready(worker) -> bool:
        """Finish a scored chunk before the queue is full: when its score is
        ready, on one process. Finishing issues collectives (the scoring
        forwards, the row gathers), and readiness is a matter of each rank's
        timing, so with several processes only the queue depth decides."""
        return world_size() == 1 and worker.ready()

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0, store=None, snapshot=None,
                        staleness: int = 0, stop=None, weight_poll=None):
        """Fill ``store`` (the trainer's by default) with ``num_rollouts``
        rows generated by the policy whose step is ``iter_count``, or by the
        boundary ``snapshot``'s weights (see the module docstring). Returns
        the phase statistics (host wall seconds per part, device seconds of
        prefill / decode / scoring, decode tokens per second) and logs them
        to the trainer's tracker at step ``iter_count``; None when ``stop``
        ended the phase early (the partial store is dropped).
        ``weight_poll`` (the engine path's in-flight weight updates) is
        unused here: the chunked path has no sync boundary mid-phase."""
        rl = self.rl_model
        if rl.rollout_engine_enabled:
            return self._make_experience_engine(num_rollouts, iter_count, store, snapshot, staleness, stop,
                                                weight_poll)
        store = store if store is not None else rl.store
        record_staleness = store.record_staleness
        # Between stores: the whole store reads one weight version.
        weight_version = rl._adopt_snapshot(snapshot)
        snap_kw = {} if snapshot is None else {"snapshot": snapshot}  # the live weights' calls keep their form
        P_full = int(rl.prompt_length)
        pad_id = int(rl.pad_token_id)
        t_phase = time.perf_counter()
        gen_s = reward_s = score_s = push_s = 0.0
        prefill_dev_s = decode_dev_s = score_dev_s = rm_dev_s = 0.0
        has_rm = rl.has_reward_model
        gen_tokens = 0
        decode_steps = []
        n_collected = 0
        last_scores = np.zeros((1,), dtype=np.float32)
        last_kl = np.zeros((1, 1), dtype=np.float32)
        max_abs_kl = 0.0

        def finish_chunk(ctx, scored):
            # Device scoring, the pulls, the store push and the health feed
            # of one chunk; only this thread issues device work.
            nonlocal score_s, score_dev_s, push_s, last_scores, last_kl, max_abs_kl
            scores, reward_call = scored  # the node's rows
            tokens, mask, P, gen_aux = ctx["tokens"], ctx["mask"], ctx["P"], ctx["gen_aux"]
            score_t = {}
            t = time.perf_counter()
            t_span = time.time()
            local_scores = rl.local_rows(scores)
            if gen_aux is not None:
                out = rl.rollout_score_fused(tokens, mask, local_scores, gen_aux, timings=score_t, **snap_kw)
            else:
                out = rl.rollout_score(tokens, mask, local_scores, timings=score_t, **snap_kw)
            logprobs, values, rewards, kl = (rl.gather_rows(a) for a in rl.to_host(out))
            score_s += time.perf_counter() - t
            span_complete("rollout/score_device", t_span, step=iter_count)
            score_dev_s += elapsed_s(score_t["start"], score_t["end"])
            push(ctx["tokens_h"], ctx["mask_h"], P, logprobs, values, rewards)
            self._note_chunk(ctx["tokens_h"], ctx["mask_h"], P, scores, weight_version, staleness, iter_count,
                             reward_call)
            last_scores, last_kl = scores, kl
            max_abs_kl = max(max_abs_kl, float(np.abs(kl).max()) if kl.size else 0.0)

        def push(tokens_h, mask_h, P, logprobs, values, rewards):
            nonlocal push_s
            t = time.perf_counter()
            t_span = time.time()
            q_ids, q_mask = tokens_h[:, :P], mask_h[:, :P]
            if P < P_full:
                # A bucket's chunk: its queries left-padded to the trainer's
                # width (mask 0), so the store and the train step keep one.
                pad = np.full((q_ids.shape[0], P_full - P), pad_id, dtype=q_ids.dtype)
                q_ids = np.concatenate([pad, q_ids], axis=1)
                q_mask = np.concatenate([np.zeros_like(pad, dtype=q_mask.dtype), q_mask], axis=1)
            rows = {
                "query_tensors": q_ids,
                "query_mask": q_mask,
                "response_tensors": tokens_h[:, P:],
                "response_mask": mask_h[:, P:],
                "logprobs": logprobs,
                "values": values,
                "rewards": rewards,
            }
            if record_staleness:
                rows["staleness"] = np.full((q_ids.shape[0], 1), float(staleness), dtype=np.float32)
            store.push_batch(rows)
            push_s += time.perf_counter() - t
            span_complete("rollout/push", t_span, rows=int(q_ids.shape[0]))

        worker, depth = self._score_worker()
        inflight = deque()
        aborted = False
        try:
            t = time.perf_counter()
            t_span = time.time()
            pending = self._generate_next_chunk(snapshot)
            gen_s += time.perf_counter() - t
            span_complete("rollout/generate", t_span, step=iter_count, dispatch=True)
            while True:
                if stop is not None and stop():
                    aborted = True
                    return None
                tokens, mask, P, gen_aux, timings = pending
                if rl.heartbeat is not None:
                    rl.heartbeat.beat(step=iter_count, phase="rollout")
                # The node's rows (num_rollouts and chunk_size count a node's:
                # a JAX host's), gathered from its data ranks.
                chunk_rows = int(tokens.shape[0]) * (rl.mesh.data_size // node_count())
                need_more = n_collected + chunk_rows < num_rollouts
                t = time.perf_counter()
                t_span = time.time()
                if need_more:
                    pending = self._generate_next_chunk(snapshot)
                tokens_e, mask_e = (rl.gather_rows(a, every_node=True) for a in rl.to_host((tokens, mask)))
                tokens_h, mask_h = rl.node_slice(tokens_e), rl.node_slice(mask_e)
                gen_s += time.perf_counter() - t
                span_complete("rollout/generate", t_span, step=iter_count)
                prefill_dev_s += elapsed_s(timings["start"], timings["prefill"])
                decode_dev_s += elapsed_s(timings["prefill"], timings["end"])
                ds = rl.rollout_decode_stats(mask_h, P)
                gen_tokens += ds["gen_tokens"]
                decode_steps.append(ds["decode_steps"])
                ctx = {"tokens": tokens, "mask": mask, "P": P, "gen_aux": gen_aux, "tokens_h": tokens_h,
                       "mask_h": mask_h}

                if has_rm:
                    # The reward model scores on the device: no decode, no
                    # host reward.
                    score_t = {}
                    t = time.perf_counter()
                    logprobs, values, rewards, kl, scores = (rl.gather_rows(a) for a in rl.to_host(
                        rl.rollout_score_rm(tokens, mask, timings=score_t, **snap_kw)))
                    score_s += time.perf_counter() - t
                    rm_dev_s += elapsed_s(score_t["rm_start"], score_t["rm_end"])
                    score_dev_s += elapsed_s(score_t["start"], score_t["end"])
                    push(tokens_h, mask_h, P, logprobs, values, rewards)
                    self._note_chunk(tokens_h, mask_h, P, scores, weight_version, staleness, iter_count)
                    last_scores, last_kl = scores, kl
                    max_abs_kl = max(max_abs_kl, float(np.abs(kl).max()) if kl.size else 0.0)
                elif worker is not None:
                    # Decode + reward on the worker; drain finished scores
                    # (FIFO pairs them with their chunks) and block only once
                    # ``depth`` chunks wait unscored.
                    worker.submit((tokens_h, mask_h, iter_count))
                    inflight.append(ctx)
                    while inflight and (len(inflight) > depth or self._drain_ready(worker)):
                        finish_chunk(inflight.popleft(), worker.result())
                else:
                    # One reward call a chunk, on the main process over every
                    # node's rows (a one-host JAX run's call), broadcast; each
                    # node keeps its rows.
                    t = time.perf_counter()
                    scores, call = self._host_score((tokens_e, mask_e, iter_count))
                    reward_s += time.perf_counter() - t
                    finish_chunk(ctx, (rl.node_slice(scores), call))
                n_collected += chunk_rows
                if not need_more:
                    break
            while inflight:
                if stop is not None and stop():
                    aborted = True
                    return None
                finish_chunk(inflight.popleft(), worker.result())
        finally:
            if worker is not None:
                worker.close()
                reward_s += worker.busy_s  # host decode + reward wall, measured on the worker
            if not aborted:
                rl._phase_timer.add("rollout", gen_s + score_s + push_s)
                rl._phase_timer.add("score", reward_s)

        exp_time = time.perf_counter() - t_phase
        stats = {
            "exp_time": exp_time,
            "exp_gen_s": gen_s,
            "exp_reward_s": reward_s,
            "exp_score_s": score_s,
            "exp_push_s": push_s,
            "exp_prefill_device_s": prefill_dev_s,
            "exp_decode_device_s": decode_dev_s,
            "exp_score_device_s": score_dev_s,
            "exp_decode_tokens": float(gen_tokens),
            "exp_decode_tokens_per_s": gen_tokens / max(decode_dev_s, 1e-9),
            "exp_decode_steps": float(np.mean(decode_steps)),
            "rollout_mean_score": float(np.mean(last_scores)),
            "rollout_mean_kl": float(np.mean(np.asarray(last_kl).sum(-1))),
            "rollout_max_abs_kl": max_abs_kl,
            "exp_per_sec": num_rollouts / max(exp_time, 1e-9),
        }
        if has_rm:
            stats["exp_rm_score_device_s"] = rm_dev_s
        if record_staleness:
            stats["exp_staleness"] = float(staleness)
        rl._last_exp_stats = {"exp_per_sec": stats["exp_per_sec"]}
        rl.tracker.log(stats, step=iter_count)
        return stats

    def _make_experience_engine(self, num_rollouts: int, iter_count: int, store=None, snapshot=None,
                                staleness: int = 0, stop=None, weight_poll=None):
        """The engine path: submit exactly ``num_rollouts`` prompts, step the
        engine until every episode is back, and per chunk of finished
        episodes: left-pad the prompts to the trainer's width, decode and
        score on the host (on the score worker with the overlapped
        pipeline), score on the device (a policy re-forward plus the
        reference pass), push. The phase drains fully, so no episode
        crosses a phase boundary; the weights (the live module, or the
        snapshot's) are handed over at the phase's start, under the version
        they hold, and scoring reads them. ``weight_poll`` (a zero-argument
        callable returning None or ``(module, version)``) is called once per
        engine sync: a module it returns is pushed into the RUNNING engine
        (in-flight weight updates: staged, adopted at the engine's next
        sync, live slots keep decoding and their episodes split into
        version spans). Returns and logs the phase statistics (the JAX
        package's keys plus the engine's ``engine/*`` gauges; the phase's
        ``version_spans`` aggregate, ``[[version, tokens], ...]``, is
        returned, not logged); None when ``stop`` ended it."""
        rl = self.rl_model
        store = store if store is not None else rl.store
        record_staleness = store.record_staleness
        engine = rl.rollout_engine()
        # The phase's sampling stream is a pure function of (train.seed, the
        # absolute chunk index it starts at), as the chunked path's chunk_rng
        # is: an elastic fleet's work unit samples the same tokens on any
        # worker, whatever that worker's engine drew before. (The JAX
        # engine's key runs on across phases.) A captured decode graph reads
        # the generator's seed at replay, so reseeding between phases is
        # graph-safe.
        engine.generator.manual_seed(rl.seed_of(3, self._chunks_consumed))
        weight_version = rl._adopt_snapshot(snapshot)
        snap_kw = {} if snapshot is None else {"snapshot": snapshot}  # the live weights' calls keep their form
        engine.update_weights(rl.rollout_engine_variables(**snap_kw), version=weight_version)
        P_full, R = int(rl.prompt_length), int(rl.response_length)
        pad_id = int(rl.pad_token_id)
        chunk = max(1, min(int(self.chunk_size), int(num_rollouts)))

        nodes = node_count()
        t_phase = time.perf_counter()
        # Every rank submits the whole set: each node's num_rollouts, node by
        # node (the node's own prompts where there is one node).
        submitted = 0
        while submitted < num_rollouts:
            batch = self._next_prompt_batch()
            ids, msk = np.asarray(batch["input_ids"]), np.asarray(batch["attention_mask"])
            take = min(int(ids.shape[0]), num_rollouts - submitted)
            if nodes > 1:
                ids, msk = rl.gather_node_rows(ids[:take]), rl.gather_node_rows(msk[:take])
            engine.submit(ids[:take * nodes], msk[:take * nodes])
            submitted += take
        total = num_rollouts * nodes
        # A chunk counts every node's rows, as on the chunked path, and
        # splits over the node's data ranks.
        chunk_all = chunk * nodes
        per_node_ranks = rl.mesh.data_size // nodes
        for rows in {chunk, num_rollouts % chunk or chunk}:
            if rows % per_node_ranks:
                raise ValueError(
                    f"rollout chunk of {rows} rows does not divide evenly over {per_node_ranks} processes — pick a "
                    "chunk_size (and num_rollouts) that is a positive multiple of the process count")
        fault_plan = rl.fault_plan
        sync_tick = 0

        gen_s = reward_s = score_s = push_s = 0.0
        episode_steps = []
        span_agg = {}  # the phase's per-token weight versions
        last_scores = np.zeros((1,), dtype=np.float32)
        last_kl = np.zeros((1, 1), dtype=np.float32)

        def assemble(eps):
            # Prompts arrive at their submitted width: left-pad them to the
            # trainer's, so one score shape serves every chunk. Also the
            # chunk's per-token weight versions, [[version, tokens], ...].
            tokens_h = np.full((len(eps), P_full + R), pad_id, dtype=np.int32)
            mask_h = np.zeros((len(eps), P_full + R), dtype=np.int32)
            spans = {}
            for i, e in enumerate(eps):
                w = int(e.prompt_ids.shape[0])
                tokens_h[i, P_full - w : P_full] = e.prompt_ids
                mask_h[i, P_full - w : P_full] = e.prompt_mask
                tokens_h[i, P_full:] = e.response_ids
                mask_h[i, P_full:] = e.response_mask
                episode_steps.append(int(e.decode_steps))
                for v, k in e.version_spans or ((e.weight_version, e.decode_steps),):
                    spans[v] = spans.get(v, 0) + int(k)
                    span_agg[v] = span_agg.get(v, 0) + int(k)
            version_spans = sorted(([v, k] for v, k in spans.items()), key=lambda x: (x[0] is None, x[0]))
            return tokens_h, mask_h, version_spans

        def finish_chunk(tokens_h, mask_h, version_spans, scored):
            # Device scoring of this data rank's rows of the node's chunk
            # (``tokens_h``), the push of the node's rows and the health
            # feed; only this thread issues device work.
            nonlocal score_s, push_s, last_scores, last_kl
            t = time.perf_counter()
            t_span = time.time()
            loc_t, loc_m = rl.local_rows(tokens_h), rl.local_rows(mask_h)
            if scored is None:
                reward_call = None
                logprobs, values, rewards, kl, scores = (rl.gather_rows(a) for a in rl.to_host(
                    rl.rollout_score_rm(loc_t, loc_m, **snap_kw)))
            else:
                scores, reward_call = scored  # the node's rows
                out = rl.rollout_score(rl.put(loc_t), rl.put(loc_m), rl.local_rows(scores), **snap_kw)
                logprobs, values, rewards, kl = (rl.gather_rows(a) for a in rl.to_host(out))
            score_s += time.perf_counter() - t
            span_complete("rollout/score_device", t_span, step=iter_count)
            t = time.perf_counter()
            t_span = time.time()
            rows = {
                "query_tensors": tokens_h[:, :P_full],
                "query_mask": mask_h[:, :P_full],
                "response_tensors": tokens_h[:, P_full:],
                "response_mask": mask_h[:, P_full:],
                "logprobs": logprobs,
                "values": values,
                "rewards": rewards,
            }
            if record_staleness:
                rows["staleness"] = np.full((tokens_h.shape[0], 1), float(staleness), dtype=np.float32)
            store.push_batch(rows)
            push_s += time.perf_counter() - t
            span_complete("rollout/push", t_span, rows=int(tokens_h.shape[0]))
            self._note_chunk(tokens_h, mask_h, P_full, scores, weight_version, staleness, iter_count, reward_call,
                             version_spans)
            last_scores, last_kl = scores, kl

        worker, depth = self._score_worker()
        inflight = deque()
        n_collected = 0
        finished_buf = []
        ok = aborted = False
        try:
            while n_collected < total:
                if stop is not None and stop():
                    aborted = True
                    return None
                if rl.heartbeat is not None:
                    rl.heartbeat.beat(step=iter_count, phase="rollout")
                if weight_poll is not None:
                    pushed = weight_poll()
                    if pushed is not None:
                        engine.update_weights(pushed[0], version=pushed[1])
                sync_tick += 1
                if fault_plan and fault_plan.fire("mid_decode_host_kill", sync_tick):
                    # Death mid-phase with slots live: no cleanup, no last
                    # heartbeat. The others' guarded decode sync turns it
                    # into exit 117 with their slot states in the bundle.
                    os._exit(1)
                t = time.perf_counter()
                eps = engine.step()
                gen_s += time.perf_counter() - t
                finished_buf.extend(eps)
                if not eps and engine.idle and n_collected + len(finished_buf) < total:
                    raise RuntimeError(f"rollout engine went idle before the phase collected {total} "
                                       f"episodes (have {n_collected + len(finished_buf)})")
                # Full chunks, and the last partial one once every prompt is back.
                while len(finished_buf) >= chunk_all or (finished_buf and n_collected + len(finished_buf) == total):
                    take = min(chunk_all, len(finished_buf))
                    batch_eps, finished_buf = finished_buf[:take], finished_buf[take:]
                    tokens_e, mask_e, version_spans = assemble(batch_eps)
                    # This node's rows (every node's episodes, node by node).
                    tokens_h, mask_h = rl.node_slice(tokens_e), rl.node_slice(mask_e)
                    if rl.has_reward_model:
                        finish_chunk(tokens_h, mask_h, version_spans, None)
                    elif worker is not None:
                        worker.submit((tokens_e, mask_e, iter_count))
                        inflight.append((tokens_h, mask_h, version_spans))
                        while inflight and (len(inflight) > depth or self._drain_ready(worker)):
                            ctx, (scores, call) = inflight.popleft(), worker.result()
                            finish_chunk(*ctx, (rl.node_slice(scores), call))
                    else:
                        # One reward call a chunk, on the main process over
                        # every node's rows, broadcast; each node keeps its rows.
                        t = time.perf_counter()
                        scores, call = self._host_score((tokens_e, mask_e, iter_count))
                        reward_s += time.perf_counter() - t
                        finish_chunk(tokens_h, mask_h, version_spans, (rl.node_slice(scores), call))
                    n_collected += take
            while inflight:
                if stop is not None and stop():
                    aborted = True
                    return None
                ctx, (scores, call) = inflight.popleft(), worker.result()
                finish_chunk(*ctx, (rl.node_slice(scores), call))
            ok = True
        finally:
            if not ok:
                # Drop queued prompts and in-flight slots, so the next phase
                # starts from an empty engine.
                engine.abort()
            if worker is not None:
                worker.close()
                reward_s += worker.busy_s
            if not aborted:
                rl._phase_timer.add("rollout", gen_s + score_s + push_s)
                rl._phase_timer.add("score", reward_s)

        if world_size() > 1:
            # Every rank's slot manager must have made the same decisions; a
            # desynced schedule is named here, at the phase boundary. The
            # guard's detail carries the slot states should a peer never
            # arrive (a data-parallel decode has no collective of its own).
            from trlx_tpu_torch.resilience import distributed as dist_res

            with dist_res.collective_guard("engine/schedule_verify",
                                           detail=lambda: {"slot_states": engine.slot_states()}):
                dist_res.verify_engine_schedule(engine.schedule_fingerprint(), phase=iter_count)
        self.schedule_crcs.append(engine.schedule_fingerprint())

        eng = engine.stats(reset=True)
        exp_time = time.perf_counter() - t_phase
        stats = {
            "exp_time": exp_time,
            "exp_gen_s": gen_s,
            "exp_reward_s": reward_s,
            "exp_score_s": score_s,
            "exp_push_s": push_s,
            # The engine-blocked rate (admission + decode + harvest per
            # step()); engine/decode_tokens_per_s is the decode alone.
            "exp_decode_tokens_per_s": float(eng["engine/gen_tokens"]) / max(gen_s, 1e-9),
            "exp_decode_steps": float(eng["engine/decode_steps"]),
            "exp_decode_dispatches": float(eng["engine/decode_dispatches"]),
            "exp_decode_tokens": float(eng["engine/decode_tokens"]),
            "exp_decode_step_budget": float(R),
            "exp_decode_steps_per_episode": float(np.mean(episode_steps)) if episode_steps else 0.0,
            "rollout_mean_score": float(np.mean(last_scores)),
            "rollout_mean_kl": float(np.mean(np.asarray(last_kl).sum(-1))),
            "exp_per_sec": num_rollouts / max(exp_time, 1e-9),
        }
        stats.update(eng)
        if record_staleness:
            stats["exp_staleness"] = float(staleness)
        rl._last_exp_stats = {"exp_per_sec": stats["exp_per_sec"]}
        rl.tracker.log(stats, step=iter_count)
        stats["version_spans"] = sorted(([v, k] for v, k in span_agg.items()), key=lambda x: (x[0] is None, x[0]))
        return stats
