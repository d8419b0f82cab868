"""Bounded retry and hang timeout for host callables (the counterpart of
``trlx_tpu.resilience.retry``).

The user's ``reward_fn`` is arbitrary Python that often crosses a network or
subprocess boundary: a transient exception or a hang costs a bounded retry,
not the run. The PPO orchestrator wraps its reward calls here, governed by
``train.reward_fn_timeout`` / ``reward_fn_retries`` / ``reward_fn_backoff``.
"""

import sys
import threading
import time


def _run_with_timeout(fn, timeout: float):
    """Run ``fn()`` on a daemon thread; raise TimeoutError if it outlives
    ``timeout`` seconds. The hung thread is abandoned (a daemon, so it never
    holds the interpreter at exit) and its eventual result is discarded. It
    nests under any calling thread, the score worker's included."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
            box["error"] = e

    t = threading.Thread(target=target, name="call-with-timeout", daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError(f"call still running after {timeout}s")
    if "error" in box:
        raise box["error"]
    return box["value"]


def call_with_retries(fn, *, retries: int = 2, backoff: float = 0.5, timeout: float = 0.0,
                      description: str = "call"):
    """``fn()`` with up to ``retries`` retries on an exception or a timeout.

    ``timeout <= 0`` disables the hang timeout (``fn`` runs on the calling
    thread). The backoff doubles per attempt, starting at ``backoff``
    seconds. The final failure re-raises the last error."""
    attempts = max(int(retries), 0) + 1
    last_error = None
    for attempt in range(attempts):
        try:
            if timeout and timeout > 0:
                return _run_with_timeout(fn, timeout)
            return fn()
        except BaseException as e:  # noqa: BLE001 — bounded, re-raised below
            last_error = e
            if attempt + 1 >= attempts:
                break
            delay = backoff * (2 ** attempt)
            print(f"[trlx_tpu_torch.resilience] {description} failed (attempt {attempt + 1}/{attempts}: "
                  f"{type(e).__name__}: {e}) — retrying in {delay:.2g}s", file=sys.stderr, flush=True)
            if delay > 0:
                time.sleep(delay)
    raise last_error
