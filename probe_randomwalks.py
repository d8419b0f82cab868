#!/usr/bin/env python3
"""The port's randomwalks example over several seeds, on the card and on
the host CPU of the same machine: each run's eval optimality history, to
compare the two devices' learning (the smoke's ``randomwalks`` phase runs
one seed on the card).

    python3 probe_randomwalks.py [METHODS] [DEVICES] [SEEDS]
    python3 probe_randomwalks.py ppo,ilql cuda,cpu 1000,1001,1002,1003,1004,1005

Sizes are the CPU learning gates' (``chip_smoke.RANDOMWALKS``), the seed
is ``train.seed``. Prints one ``[rw]`` line a run, the card's name and power
limit, and one ``[rw-summary]`` line a method and device.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.modules["wandb"] = None  # the Tracker's wandb branch would reach for a login
os.environ["TRLX_TPU_NO_PROGRESS"] = "1"
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from trlx_tpu_torch.examples import randomwalks  # noqa: E402


def run(method: str, train_kw: dict, method_kw: dict, device: str, seed: int, run_dir: str):
    config = randomwalks.base_config(method, 21, 10)
    for k, v in dict(train_kw, checkpoint_interval=10**6, seed=seed, checkpoint_dir=run_dir).items():
        setattr(config.train, k, v)
    for k, v in method_kw.items():
        setattr(config.method, k, v)
    history = []

    def recording(task_metric):
        def metric(samples):
            m = task_metric(samples)
            history.append(round(float(np.mean(m["optimality"])), 4))
            return m
        return metric

    t0 = time.perf_counter()
    randomwalks.main(method, device=device, config=config, metric_fn=recording)
    return {"hist": history, "best": max(history), "s": round(time.perf_counter() - t0, 1)}


def main(argv):
    methods = argv[0].split(",") if argv else ["ppo"]
    devices = argv[1].split(",") if len(argv) > 1 else ["cuda", "cpu"]
    seeds = [int(s) for s in argv[2].split(",")] if len(argv) > 2 else [1000, 1001, 1002, 1003, 1004]
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for method, train_kw, method_kw, _ in cs.RANDOMWALKS:
        if method not in methods:
            continue
        for dev in devices:
            for seed in seeds:
                key = f"{method}/{dev}/{seed}"
                out[key] = run(method, train_kw, method_kw, dev, seed, os.path.join(cs.RUN_DIR, "probe_rw", key))
                print(f"[rw] {method} {dev} seed {seed}: {json.dumps(out[key])}", flush=True)
    print(cs.card_line() if torch.cuda.is_available() else "no CUDA device")
    for method in methods:
        for dev in devices:
            runs = [v for k, v in out.items() if k.startswith(f"{method}/{dev}/")]
            best, first = [r["best"] for r in runs], [r["hist"][0] for r in runs]
            print(f"[rw-summary] {method} {dev}: best {best} (mean {np.mean(best):.3f}), first eval {first} "
                  f"(mean {np.mean(first):.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
