"""Helpers of the port's fleet drills (``tests/test_torch_fleet_*.py``; not
collected): launch a role of ``tests/torch_fleet_worker.py`` as its own
process, wait for it under a hard wall limit (a hang kills it and fails the
test), and read the fleet directory's logs."""

import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_fleet_worker.py")
FLEET_ENV = ("TRLX_TPU_FAULTS", "TRLX_TPU_METRICS_PORT", "TRLX_TPU_FLEET_ROLE", "TRLX_TPU_FLEET_WORKER",
             "TRLX_TPU_FLEET_LEAVE_AFTER", "TRLX_TPU_SPANS", "TRLX_TPU_HEALTH")


def launch(role, ckpt, fleet_dir, staleness, extra_env=None):
    """Start one role (``serial``, ``rollout``, ``learner``) as a process;
    its output goes to ``<ckpt>.log``."""
    env = dict(os.environ)
    for var in FLEET_ENV:
        env.pop(var, None)
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    env["TRLX_TPU_NO_PROGRESS"] = "1"
    env["OMP_NUM_THREADS"] = "1"
    if role not in ("serial", "colocated"):
        env["TRLX_TPU_FLEET_ROLE"] = role
    env.update(extra_env or {})
    log = open(f"{ckpt}.log", "wb")
    proc = subprocess.Popen([sys.executable, WORKER, role, str(ckpt), str(fleet_dir), str(staleness)], env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    proc.log_path = f"{ckpt}.log"
    log.close()
    return proc


def finish(proc, timeout=120):
    """Wait for ``proc`` at most ``timeout`` seconds (then kill it and fail)
    and return its output."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        pytest.fail(f"fleet drill process overran its {timeout} s limit:\n{output(proc)[-4000:]}")
    return output(proc)


def output(proc) -> str:
    with open(proc.log_path, "rb") as f:
        return f.read().decode(errors="replace")


def kill_all(*procs):
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()


def read_jsonl(path):
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass  # a torn tail
    return out


def events(fleet_dir):
    return read_jsonl(os.path.join(str(fleet_dir), "fleet_events.jsonl"))


def losses(out):
    line = next(x for x in out.splitlines() if x.startswith("LOSSES "))
    return json.loads(line[len("LOSSES "):])


def assert_clean_threads(out, who):
    lines = [x for x in out.splitlines() if x.startswith("THREADS ")]
    assert lines, f"{who} never reported its thread census:\n{out[-2000:]}"
    assert json.loads(lines[-1][len("THREADS "):]) == [], f"{who} leaked threads: {lines[-1]}"


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
