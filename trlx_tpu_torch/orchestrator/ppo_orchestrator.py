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
keeps the serial path's reward-call and push order. The rollout producer
calls ``make_experience`` with a fresh ``store``, the boundary ``snapshot``
(adopted here, at the store's start: the rollouts of one store read one
weight version), the store's ``staleness`` (a column of a store that
records it) and a ``stop`` poll checked between chunks. With prompt
buckets the chunks decode at their bucket's width and the stored queries
are left-padded to the trainer's ``prompt_length``.

Not ported here: in-flight weight polling, fault plans, multi-process
schedule checks, the fleet, health monitoring and trace spans.
"""

import time
from collections import deque

import numpy as np

from trlx_tpu_torch.device import elapsed_s
from trlx_tpu_torch.orchestrator import Orchestrator, register_orchestrator
from trlx_tpu_torch.pipeline.overlap import ScoreWorker


@register_orchestrator
class PPOOrchestrator(Orchestrator):
    def __init__(self, model, pipeline, reward_fn, metric_fn=None, chunk_size: int = 512):
        super().__init__(pipeline, model)
        self.chunk_size = chunk_size
        self.pipeline_loader = self.pipeline.create_loader(self.chunk_size, shuffle=True)
        self.pipeline_iterator = iter(self.pipeline_loader)
        self._chunks_consumed = 0
        self.rl_model.orch = self
        self.rl_model.reward_fn = reward_fn
        self.rl_model.metric_fn = metric_fn

    def score(self, texts):
        """The user's reward on decoded samples (called on the main process,
        broadcast to every rank)."""
        return self.rl_model.host_reward(texts)

    def _next_prompt_batch(self):
        try:
            batch = next(self.pipeline_iterator)
        except StopIteration:
            self.pipeline_iterator = iter(self.pipeline_loader)
            batch = next(self.pipeline_iterator)
        self._chunks_consumed += 1
        return batch

    def _generate_next_chunk(self, snapshot=None):
        """Launch one chunk's generation from the module ``snapshot`` names
        (the live one for None). The sampling generator is a pure function
        of (train.seed, absolute chunk index)."""
        rl = self.rl_model
        snap_kw = {} if snapshot is None else {"snapshot": snapshot}
        generator = rl.chunk_rng(self._chunks_consumed)
        batch = self._next_prompt_batch()
        P = batch["input_ids"].shape[1]
        timings = {}
        if rl.fused_rollout:
            tokens, mask, stats, prefill = rl.rollout_generate_fused(
                batch["input_ids"], batch["attention_mask"], generator=generator, timings=timings, **snap_kw
            )
            return tokens, mask, P, (stats, prefill), timings
        tokens, mask = rl.rollout_generate(
            batch["input_ids"], batch["attention_mask"], generator=generator, timings=timings, **snap_kw
        )
        return tokens, mask, P, None, timings

    def _host_score(self, args):
        """The host boundary: decode, then the user's reward. Runs on the
        score worker with the overlapped pipeline, inline otherwise."""
        tokens_h, mask_h = args
        return np.asarray(self.score(self.rl_model.decode(tokens_h, mask_h)), dtype=np.float32)

    def _score_worker(self):
        """(worker, depth), or (None, 0) where scoring stays inline (no
        overlap, or a reward model scores on the device)."""
        rl = self.rl_model
        if not rl.overlap_rollouts or rl.has_reward_model:
            return None, 0
        depth = max(1, int(rl.config.method.score_queue_depth or 2))
        return ScoreWorker(self._host_score, depth=depth), depth

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0, store=None, snapshot=None,
                        staleness: int = 0, stop=None):
        """Fill ``store`` (the trainer's by default) with ``num_rollouts``
        rows generated by the policy whose step is ``iter_count``, or by the
        boundary ``snapshot``'s weights (see the module docstring). Returns
        the phase statistics (host wall seconds per part, device seconds of
        prefill / decode / scoring, decode tokens per second) and logs them
        to the trainer's tracker at step ``iter_count``; None when ``stop``
        ended the phase early (the partial store is dropped)."""
        rl = self.rl_model
        if rl.rollout_engine_enabled:
            return self._make_experience_engine(num_rollouts, iter_count, store, snapshot, staleness, stop)
        store = store if store is not None else rl.store
        record_staleness = store.record_staleness
        rl._adopt_snapshot(snapshot)  # between stores: the whole store reads one weight version
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

        def finish_chunk(ctx, scores):
            # Device scoring, the pulls and the store push of one chunk;
            # only this thread issues device work.
            nonlocal score_s, score_dev_s, push_s, last_scores, last_kl, max_abs_kl
            tokens, mask, P, gen_aux = ctx["tokens"], ctx["mask"], ctx["P"], ctx["gen_aux"]
            score_t = {}
            t = time.perf_counter()
            if gen_aux is not None:
                out = rl.rollout_score_fused(tokens, mask, scores, gen_aux, timings=score_t, **snap_kw)
            else:
                out = rl.rollout_score(tokens, mask, scores, timings=score_t, **snap_kw)
            logprobs, values, rewards, kl = rl.to_host(out)
            score_s += time.perf_counter() - t
            score_dev_s += elapsed_s(score_t["start"], score_t["end"])
            push(ctx["tokens_h"], ctx["mask_h"], P, logprobs, values, rewards)
            last_scores, last_kl = scores, kl
            max_abs_kl = max(max_abs_kl, float(np.abs(kl).max()) if kl.size else 0.0)

        def push(tokens_h, mask_h, P, logprobs, values, rewards):
            nonlocal push_s
            t = time.perf_counter()
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

        worker, depth = self._score_worker()
        inflight = deque()
        aborted = False
        try:
            t = time.perf_counter()
            pending = self._generate_next_chunk(snapshot)
            gen_s += time.perf_counter() - t
            while True:
                if stop is not None and stop():
                    aborted = True
                    return None
                tokens, mask, P, gen_aux, timings = pending
                chunk_rows = int(tokens.shape[0])
                need_more = n_collected + chunk_rows < num_rollouts
                t = time.perf_counter()
                if need_more:
                    pending = self._generate_next_chunk(snapshot)
                tokens_h, mask_h = rl.to_host((tokens, mask))
                gen_s += time.perf_counter() - t
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
                    logprobs, values, rewards, kl, scores = rl.to_host(
                        rl.rollout_score_rm(tokens, mask, timings=score_t, **snap_kw))
                    score_s += time.perf_counter() - t
                    rm_dev_s += elapsed_s(score_t["rm_start"], score_t["rm_end"])
                    score_dev_s += elapsed_s(score_t["start"], score_t["end"])
                    push(tokens_h, mask_h, P, logprobs, values, rewards)
                    last_scores, last_kl = scores, kl
                    max_abs_kl = max(max_abs_kl, float(np.abs(kl).max()) if kl.size else 0.0)
                elif worker is not None:
                    # Decode + reward on the worker; drain finished scores
                    # (FIFO pairs them with their chunks) and block only once
                    # ``depth`` chunks wait unscored.
                    worker.submit((tokens_h, mask_h))
                    inflight.append(ctx)
                    while inflight and (len(inflight) > depth or worker.ready()):
                        finish_chunk(inflight.popleft(), worker.result())
                else:
                    t = time.perf_counter()
                    scores = self._host_score((tokens_h, mask_h))
                    reward_s += time.perf_counter() - t
                    finish_chunk(ctx, scores)
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
                                staleness: int = 0, stop=None):
        """The engine path: submit exactly ``num_rollouts`` prompts, step the
        engine until every episode is back, and per chunk of finished
        episodes: left-pad the prompts to the trainer's width, decode and
        score on the host (on the score worker with the overlapped
        pipeline), score on the device (a policy re-forward plus the
        reference pass), push. The phase drains fully, so no episode
        crosses a phase boundary; the weights (the live module, or the
        snapshot's) are handed over once, under the version they hold.
        Returns and logs the phase statistics (the JAX package's keys plus
        the engine's ``engine/*`` gauges); None when ``stop`` ended it."""
        rl = self.rl_model
        store = store if store is not None else rl.store
        record_staleness = store.record_staleness
        engine = rl.rollout_engine()
        weight_version = rl._adopt_snapshot(snapshot)
        snap_kw = {} if snapshot is None else {"snapshot": snapshot}  # the live weights' calls keep their form
        engine.update_weights(rl.rollout_engine_variables(**snap_kw), version=weight_version)
        P_full, R = int(rl.prompt_length), int(rl.response_length)
        pad_id = int(rl.pad_token_id)
        chunk = max(1, min(int(self.chunk_size), int(num_rollouts)))

        t_phase = time.perf_counter()
        submitted = 0
        while submitted < num_rollouts:
            batch = self._next_prompt_batch()
            ids, msk = np.asarray(batch["input_ids"]), np.asarray(batch["attention_mask"])
            take = min(int(ids.shape[0]), num_rollouts - submitted)
            engine.submit(ids[:take], msk[:take])
            submitted += take

        gen_s = reward_s = score_s = push_s = 0.0
        episode_steps = []
        last_scores = np.zeros((1,), dtype=np.float32)
        last_kl = np.zeros((1, 1), dtype=np.float32)

        def assemble(eps):
            # Prompts arrive at their submitted width: left-pad them to the
            # trainer's, so one score shape serves every chunk.
            tokens_h = np.full((len(eps), P_full + R), pad_id, dtype=np.int32)
            mask_h = np.zeros((len(eps), P_full + R), dtype=np.int32)
            for i, e in enumerate(eps):
                w = int(e.prompt_ids.shape[0])
                tokens_h[i, P_full - w : P_full] = e.prompt_ids
                mask_h[i, P_full - w : P_full] = e.prompt_mask
                tokens_h[i, P_full:] = e.response_ids
                mask_h[i, P_full:] = e.response_mask
                episode_steps.append(int(e.decode_steps))
            return tokens_h, mask_h

        def finish_chunk(tokens_h, mask_h, scores):
            # Device scoring and the push; only this thread issues device work.
            nonlocal score_s, push_s, last_scores, last_kl
            t = time.perf_counter()
            if scores is None:
                logprobs, values, rewards, kl, scores = rl.to_host(
                    rl.rollout_score_rm(tokens_h, mask_h, **snap_kw))
            else:
                out = rl.rollout_score(rl.put(tokens_h), rl.put(mask_h), scores, **snap_kw)
                logprobs, values, rewards, kl = rl.to_host(out)
            score_s += time.perf_counter() - t
            t = time.perf_counter()
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
            last_scores, last_kl = scores, kl

        worker, depth = self._score_worker()
        inflight = deque()
        n_collected = 0
        finished_buf = []
        ok = aborted = False
        try:
            while n_collected < num_rollouts:
                if stop is not None and stop():
                    aborted = True
                    return None
                t = time.perf_counter()
                eps = engine.step()
                gen_s += time.perf_counter() - t
                finished_buf.extend(eps)
                if not eps and engine.idle and n_collected + len(finished_buf) < num_rollouts:
                    raise RuntimeError(f"rollout engine went idle before the phase collected {num_rollouts} "
                                       f"episodes (have {n_collected + len(finished_buf)})")
                # Full chunks, and the last partial one once every prompt is back.
                while len(finished_buf) >= chunk or (finished_buf and n_collected + len(finished_buf) == num_rollouts):
                    take = min(chunk, len(finished_buf))
                    batch_eps, finished_buf = finished_buf[:take], finished_buf[take:]
                    tokens_h, mask_h = assemble(batch_eps)
                    if rl.has_reward_model:
                        finish_chunk(tokens_h, mask_h, None)
                    elif worker is not None:
                        worker.submit((tokens_h, mask_h))
                        inflight.append((tokens_h, mask_h))
                        while inflight and (len(inflight) > depth or worker.ready()):
                            finish_chunk(*inflight.popleft(), worker.result())
                    else:
                        t = time.perf_counter()
                        scores = self._host_score((tokens_h, mask_h))
                        reward_s += time.perf_counter() - t
                        finish_chunk(tokens_h, mask_h, scores)
                    n_collected += take
            while inflight:
                if stop is not None and stop():
                    aborted = True
                    return None
                finish_chunk(*inflight.popleft(), worker.result())
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
        return stats
