"""PPO experience generation (the counterpart of
``trlx_tpu.orchestrator.ppo_orchestrator.PPOOrchestrator.make_experience``),
serial on both of its paths.

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

Not ported here: the score-worker thread, in-flight weight polling, fault
plans, multi-process schedule checks, the fleet, health monitoring and
trace spans.
"""

import time

import numpy as np

from trlx_tpu_torch.device import elapsed_s
from trlx_tpu_torch.orchestrator import Orchestrator, register_orchestrator


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

    def _generate_next_chunk(self):
        """Launch one chunk's generation. The sampling generator is a pure
        function of (train.seed, absolute chunk index)."""
        rl = self.rl_model
        generator = rl.chunk_rng(self._chunks_consumed)
        batch = self._next_prompt_batch()
        P = batch["input_ids"].shape[1]
        timings = {}
        if rl.fused_rollout:
            tokens, mask, stats, prefill = rl.rollout_generate_fused(
                batch["input_ids"], batch["attention_mask"], generator=generator, timings=timings
            )
            return tokens, mask, P, (stats, prefill), timings
        tokens, mask = rl.rollout_generate(
            batch["input_ids"], batch["attention_mask"], generator=generator, timings=timings
        )
        return tokens, mask, P, None, timings

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0):
        """Fill the trainer's rollout store with ``num_rollouts`` rows
        generated by the current policy (whose step is ``iter_count``).
        Returns the phase statistics (host wall seconds per part, device
        seconds of prefill / decode / scoring, decode tokens per second) and
        logs them to the trainer's tracker at step ``iter_count``."""
        rl = self.rl_model
        if rl.rollout_engine_enabled:
            return self._make_experience_engine(num_rollouts, iter_count)
        store = rl.store
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

        t = time.perf_counter()
        pending = self._generate_next_chunk()
        gen_s += time.perf_counter() - t
        while True:
            tokens, mask, P, gen_aux, timings = pending
            chunk_rows = int(tokens.shape[0])
            need_more = n_collected + chunk_rows < num_rollouts
            t = time.perf_counter()
            if need_more:
                pending = self._generate_next_chunk()
            tokens_h, mask_h = rl.to_host((tokens, mask))
            gen_s += time.perf_counter() - t
            prefill_dev_s += elapsed_s(timings["start"], timings["prefill"])
            decode_dev_s += elapsed_s(timings["prefill"], timings["end"])
            ds = rl.rollout_decode_stats(mask_h, P)
            gen_tokens += ds["gen_tokens"]
            decode_steps.append(ds["decode_steps"])

            score_t = {}
            if has_rm:
                # The reward model scores on the device: no decode, no host
                # reward.
                t = time.perf_counter()
                logprobs, values, rewards, kl, scores = rl.to_host(rl.rollout_score_rm(tokens, mask, timings=score_t))
                score_s += time.perf_counter() - t
                rm_dev_s += elapsed_s(score_t["rm_start"], score_t["rm_end"])
            else:
                t = time.perf_counter()
                texts_or_tokens = rl.decode(tokens_h, mask_h)
                scores = np.asarray(self.score(texts_or_tokens), dtype=np.float32)
                reward_s += time.perf_counter() - t

                t = time.perf_counter()
                if gen_aux is not None:
                    out = rl.rollout_score_fused(tokens, mask, scores, gen_aux, timings=score_t)
                else:
                    out = rl.rollout_score(tokens, mask, scores, timings=score_t)
                logprobs, values, rewards, kl = rl.to_host(out)
                score_s += time.perf_counter() - t
            score_dev_s += elapsed_s(score_t["start"], score_t["end"])

            t = time.perf_counter()
            store.push_batch(
                {
                    "query_tensors": tokens_h[:, :P],
                    "query_mask": mask_h[:, :P],
                    "response_tensors": tokens_h[:, P:],
                    "response_mask": mask_h[:, P:],
                    "logprobs": logprobs,
                    "values": values,
                    "rewards": rewards,
                }
            )
            push_s += time.perf_counter() - t
            last_scores, last_kl = scores, kl
            max_abs_kl = max(max_abs_kl, float(np.abs(kl).max()) if kl.size else 0.0)
            n_collected += chunk_rows
            if not need_more:
                break

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
        rl.tracker.log(stats, step=iter_count)
        return stats

    def _make_experience_engine(self, num_rollouts: int, iter_count: int):
        """The engine path: submit exactly ``num_rollouts`` prompts, step the
        engine until every episode is back, and per chunk of finished
        episodes: left-pad the prompts to the trainer's width, decode and
        score on the host, score on the device (a policy re-forward plus the
        reference pass), push. The phase drains fully, so no episode
        crosses a phase boundary; the weights are handed over once, as
        version ``iter_count``. Returns and logs the phase statistics (the
        JAX package's keys plus the engine's ``engine/*`` gauges)."""
        rl = self.rl_model
        store = rl.store
        engine = rl.rollout_engine()
        engine.update_weights(rl.rollout_engine_variables(), version=iter_count)
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

        n_collected = 0
        finished_buf = []
        ok = False
        try:
            while n_collected < num_rollouts:
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
                        t = time.perf_counter()
                        logprobs, values, rewards, kl, scores = rl.to_host(rl.rollout_score_rm(tokens_h, mask_h))
                    else:
                        t = time.perf_counter()
                        scores = np.asarray(self.score(rl.decode(tokens_h, mask_h)), dtype=np.float32)
                        reward_s += time.perf_counter() - t
                        t = time.perf_counter()
                        out = rl.rollout_score(rl.put(tokens_h), rl.put(mask_h), scores)
                        logprobs, values, rewards, kl = rl.to_host(out)
                    score_s += time.perf_counter() - t
                    t = time.perf_counter()
                    store.push_batch({
                        "query_tensors": tokens_h[:, :P_full],
                        "query_mask": mask_h[:, :P_full],
                        "response_tensors": tokens_h[:, P_full:],
                        "response_mask": mask_h[:, P_full:],
                        "logprobs": logprobs,
                        "values": values,
                        "rewards": rewards,
                    })
                    push_s += time.perf_counter() - t
                    last_scores, last_kl = scores, kl
                    n_collected += take
            ok = True
        finally:
            if not ok:
                # Drop queued prompts and in-flight slots, so the next phase
                # starts from an empty engine.
                engine.abort()

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
        rl.tracker.log(stats, step=iter_count)
        return stats
