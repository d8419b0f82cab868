"""One role of a port fleet drill, run as its own process by
``tests/test_torch_fleet_*.py``: ``python tests/torch_fleet_worker.py ROLE
CKPT FLEET_DIR STALENESS`` with ROLE one of ``serial`` (no fleet),
``rollout``, ``learner`` or ``colocated``.

The randomwalks PPO task of ``tests/test_fleet_disagg.py`` at drill timing
(seconds, not minutes) through ``trlx_tpu_torch.train(device="cpu")``.
Environment: TOTAL / EPOCHS (steps), RESUME, ENGINE (+ ENGINE_SYNC,
INFLIGHT), ELASTIC (+ LEASE_TTL), BDEADLINE, HB_TIMEOUT, REWARD_SLEEP, the role's
``TRLX_TPU_FLEET_ROLE`` / ``TRLX_TPU_FAULTS`` / ``TRLX_TPU_FLEET_WORKER``,
and ``TRLX_TPU_METRICS_PORT`` (the learner then scrapes its own /healthz
and /metrics while it runs, into files under CKPT). Prints ``LOSSES
[...]`` (serial and learner), ``THREADS [...]`` (the trlx-* threads still
alive) and ``fleet role ROLE DONE``.
"""

import dataclasses
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))

import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402


def fleet_config(role: str, ckpt: str, fleet_dir: str, staleness: int, env=os.environ) -> TRLConfig:
    """The drill's port config (the JAX drill's knobs)."""
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.total_steps = int(env.get("TOTAL", "8"))
    config.train.epochs = int(env.get("EPOCHS", "4"))
    config.train.batch_size = 16
    config.train.eval_interval = 100
    config.train.checkpoint_dir = ckpt
    config.train.resume_from_checkpoint = bool(int(env.get("RESUME", "0")))
    config.method.num_rollouts = 16
    config.method.chunk_size = 16
    if int(env.get("ENGINE", "0")):
        config.method.rollout_engine = True
        config.method.engine_steps_per_sync = int(env.get("ENGINE_SYNC", "2"))
    if role != "serial":
        config.method.fleet_disaggregate = True
        config.method.fleet_elastic = bool(int(env.get("ELASTIC", "0")))
        config.method.max_staleness = staleness
        config.method.fleet_inflight_weights = bool(int(env.get("INFLIGHT", "0")))
        config.train.fleet_dir = fleet_dir
        config.train.heartbeat_interval = 0.2
        config.train.fleet_episode_timeout = 2.0
        config.train.fleet_stream_retries = 1
        config.train.fleet_stream_backoff = 0.2
        config.train.fleet_heartbeat_timeout = float(env.get("HB_TIMEOUT", "3.0"))
        config.train.fleet_broadcast_deadline = float(env.get("BDEADLINE", "60"))
        if config.method.fleet_elastic:
            config.train.fleet_lease_ttl = float(env.get("LEASE_TTL", "1.0"))
    return config


def _scrape_loop(ckpt: str, stop: threading.Event):
    """Live witnesses, written while the run goes on: the last /healthz
    fleet block, the first degraded scrape and a /metrics body with the
    fleet gauges."""
    port = int(os.environ["TRLX_TPU_METRICS_PORT"])
    while not stop.is_set():
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                payload = json.loads(r.read().decode())
            fleet = payload.get("fleet", {})
            if fleet.get("disaggregated"):
                with open(os.path.join(ckpt, "scrape_last.json"), "w") as f:
                    json.dump(fleet, f)
            if fleet.get("workers"):
                with open(os.path.join(ckpt, "scrape_workers.json"), "w") as f:
                    json.dump(fleet, f)
            if fleet.get("disaggregated", {}).get("state") == "degraded":
                with open(os.path.join(ckpt, "scrape_degraded.json"), "w") as f:
                    json.dump(payload, f)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                body = r.read().decode()
            if "trlx_tpu_fleet_degraded 1" in body or 'trlx_tpu_fleet_worker_state{worker="' in body:
                with open(os.path.join(ckpt, "scrape_metrics.txt"), "w") as f:
                    f.write(body)
        except Exception:  # noqa: BLE001 — the exporter is not up yet, or tearing down
            pass
        stop.wait(0.05)


def main():
    role, ckpt, fleet_dir, staleness = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
    torch.set_num_threads(1)
    _, logit_mask, metric_fn, walk_reward = generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)
    reward_sleep = float(os.environ.get("REWARD_SLEEP", "0"))

    def reward_fn(samples):
        # A slow reward (REWARD_SLEEP seconds a call) keeps a worker's phase
        # longer than the learner's iteration, so publishes land mid-phase.
        time.sleep(reward_sleep)
        return walk_reward(samples)

    config = fleet_config(role, ckpt, fleet_dir, staleness)
    stop, scraper = threading.Event(), None
    if role == "learner" and os.environ.get("TRLX_TPU_METRICS_PORT"):
        os.makedirs(ckpt, exist_ok=True)
        scraper = threading.Thread(target=_scrape_loop, args=(ckpt, stop), daemon=True)
        scraper.start()
    prompts = [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]
    try:
        trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=[[1]], metric_fn=metric_fn,
                             config=config, logit_mask=logit_mask, device="cpu")
    finally:
        stop.set()
        if scraper is not None:
            scraper.join(timeout=5)
    if role in ("serial", "learner", "colocated"):
        with open(os.path.join(ckpt, "metrics.jsonl")) as f:
            losses = [json.loads(line).get("loss") for line in f]
        print("LOSSES", json.dumps([x for x in losses if x is not None]))
    print("THREADS", json.dumps([t.name for t in threading.enumerate() if t.name.startswith("trlx-")]))
    print(f"fleet role {role} DONE", flush=True)


if __name__ == "__main__":
    main()
