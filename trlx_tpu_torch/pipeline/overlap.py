"""Overlapped rollout/train pipeline primitives (the counterpart of
``trlx_tpu.pipeline.overlap``).

The PPO loop has three phases (device generation, host reward scoring and
the train steps) that the serial schedule runs back to back, so the card
idles during reward scoring and the host idles during training. These
pieces overlap them, in plain ``threading``:

- ``staleness_gate_open``: the counter gate shared by the producer;
- ``PhaseTimer``: thread-safe per-phase wall accumulators feeding
  ``time/rollout_s`` / ``time/score_s`` / ``time/train_s`` /
  ``time/overlap_fraction``;
- ``ScoreWorker``: one background thread running host scoring (decode +
  ``reward_fn``), fed by a bounded FIFO queue;
- ``SerialFeed`` / ``PrefetchIterator``: the epoch loop's batch feed, the
  second staging batch k+1 on a thread while step k runs;
- ``RolloutProducer``: double-buffered experience production behind the
  staleness gate (``method.max_staleness``), with its ``history`` lineage.

All of it is off unless the method config sets ``rollout_overlap`` or
``max_staleness``. Every thread is named ``trlx-*``, and each records its
host spans on its own lane when tracing is armed (``score/host``,
``prefetch/stage``, ``rollout/produce``). The JAX module's graftscope lanes
and the sanitizer's race tracker are not ported.
"""

import queue
import threading
import time
from collections import deque
from contextlib import contextmanager

from trlx_tpu_torch.observability import graftscope
from trlx_tpu_torch.observability.spans import trace_span
from trlx_tpu_torch.parallel.mesh import group_set, producer_collectives


def staleness_gate_open(index: int, consumed: int, max_staleness: int) -> bool:
    """Production of store ``index`` may start iff the consumer is at most
    ``max_staleness`` iterations behind it. Pure counters, so the schedule
    is deterministic; at max_staleness=0 producer and consumer strictly
    alternate: the serial schedule."""
    return index - consumed <= max(0, int(max_staleness))


class PhaseTimer:
    """Thread-safe per-phase wall accumulators.

    Phases: ``rollout`` (generation + device scoring + store pushes,
    blocked wall), ``score`` (host decode + reward_fn wall, possibly on the
    worker thread), ``train`` (main-thread wall around the train steps, eval
    excluded). ``window()`` drains the accumulators and derives
    ``overlap_fraction``: the share of phase seconds hidden behind other
    phases within the window's wall clock (~0 when the phases ran serially,
    > 0 when they summed to more than the wall)."""

    PHASES = ("rollout", "score", "train")

    def __init__(self):
        self._lock = threading.Lock()
        self._acc = {p: 0.0 for p in self.PHASES}
        self._t0 = time.time()

    def add(self, phase: str, seconds: float):
        with self._lock:
            self._acc[phase] = self._acc.get(phase, 0.0) + float(seconds)

    @contextmanager
    def timed(self, phase: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.add(phase, time.time() - t0)

    def window(self) -> dict:
        """Per-phase seconds since the previous window() and the derived
        overlap fraction; resets the accumulators."""
        now = time.time()
        with self._lock:
            acc = dict(self._acc)
            wall = now - self._t0
            for p in self._acc:
                self._acc[p] = 0.0
            self._t0 = now
        total = sum(acc.values())
        overlap = max(0.0, min(1.0, (total - wall) / total)) if total > 1e-9 else 0.0
        out = {f"time/{p}_s": acc.get(p, 0.0) for p in self.PHASES}
        out["time/window_wall_s"] = wall
        out["time/overlap_fraction"] = overlap
        return out


class ScoreWorker:
    """Background host scoring: one worker thread, bounded FIFO in-queue.

    - FIFO: results come back in submission order, so the store push order
      is the serial path's.
    - Bounded: ``submit`` blocks once ``depth`` chunks are queued unscored.
    - An exception from the scoring fn is re-raised by ``result()`` on the
      caller's thread; the worker keeps draining, so ``close()`` never
      deadlocks."""

    _STOP = object()

    def __init__(self, fn, depth: int = 2):
        self._fn = fn
        self._in = queue.Queue(maxsize=max(1, int(depth)))
        self._out = queue.Queue()
        self.busy_s = 0.0  # wall inside fn; written only by the worker thread
        # The worker's collectives (the reward broadcast) take the group set
        # of the thread that starts it: a producer's worker never shares a
        # communicator with the train loop.
        self._group_set = group_set()
        self._thread = threading.Thread(target=self._run, name="trlx-score-worker", daemon=True)
        self._thread.start()

    def _run(self):
        with producer_collectives(self._group_set):
            self._loop()

    def _loop(self):
        while True:
            item = self._in.get()
            if item is self._STOP:
                return
            t0 = time.time()
            try:
                with trace_span("score/host"):
                    self._out.put(("ok", self._fn(item)))
            except BaseException as e:  # noqa: BLE001 — delivered via result()
                self._out.put(("err", e))
            finally:
                t1 = time.time()
                self.busy_s += t1 - t0
                graftscope.host_interval("score", t0, t1)

    def submit(self, item):
        self._in.put(item)

    def ready(self) -> bool:
        return not self._out.empty()

    def result(self, timeout=None):
        kind, payload = self._out.get(timeout=timeout)
        if kind == "err":
            raise payload
        return payload

    def close(self):
        """Signal and join. Safe on error paths: queued items still drain
        (their results land on the unbounded out-queue, unread), then the
        worker exits; after the join ``busy_s`` is the caller's to read."""
        self._in.put(self._STOP)
        self._thread.join()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()


class SerialFeed:
    """Depth-0 stand-in for PrefetchIterator: the transform runs inline on
    ``__next__`` (the serial schedule) behind the same ``close()``
    protocol, so the learn loop has one feed interface."""

    def __init__(self, source, transform=None):
        self._it = iter(source)
        self._transform = transform if transform is not None else (lambda x: x)

    def __iter__(self):
        return self

    def __next__(self):
        return self._transform(next(self._it))

    def close(self):
        pass


class PrefetchIterator:
    """Run ``transform`` up to ``depth`` items ahead on a background thread,
    so staging batch k+1 overlaps the train step on batch k.

    Ordering is the source's; exhaustion raises StopIteration every time
    after the first; a transform or source exception re-raises at the
    corresponding ``__next__``. ``close()`` is idempotent and unblocks and
    joins the worker even when the consumer abandons mid-epoch."""

    def __init__(self, source, transform=None, depth: int = 1):
        self._transform = transform if transform is not None else (lambda x: x)
        self._q = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._run, args=(iter(source),), name="trlx-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        # A bounded put that close() can always unblock: poll the stop flag
        # instead of parking forever on a full queue.
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it):
        try:
            for item in it:
                if self._stop.is_set():
                    return
                with trace_span("prefetch/stage"), graftscope.lane_span("prefetch"):
                    staged = ("ok", self._transform(item))
                if not self._put(staged):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at __next__
            self._put(("err", e))
            return
        self._put(("end", None))

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        kind, payload = self._q.get()
        if kind == "end":
            self._done = True
            raise StopIteration
        if kind == "err":
            self._done = True
            raise payload
        return payload

    def close(self):
        self._stop.set()
        try:  # drain so a blocked _put wakes and sees the stop flag
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
        self._done = True


class RolloutProducer:
    """Double-buffered experience production with an on-policy staleness
    gate.

    A background thread fills a fresh rollout store for training iteration
    n (n >= 1; iteration 0's store is the pre-learn fill) while the trainer
    consumes iteration n-1's:

        production of store n may START  ⇔  n - consumed <= max_staleness

    - ``max_staleness=0``: store n starts once n-1 iterations are consumed;
      the trainer blocks in ``next_store()`` for the whole phase, the serial
      schedule run on the producer thread.
    - ``max_staleness=S``: the producer runs up to S iterations ahead from
      the latest boundary SNAPSHOT handed over at each consume boundary.

    ``produce(store, index, snapshot, staleness, stop_fn)`` receives the
    store's staleness (index - consumed at production start) and a
    ``stop_fn`` to poll between chunks so ``shutdown()`` drains promptly. A
    producer exception is re-raised, the same object, by the next
    ``next_store()``. ``history`` keeps (index, staleness, version) of the
    last 64 completed stores, the version read from a dict snapshot's
    ``"version"`` (None otherwise).

    ``collective`` (several processes, whose producers run collectives with
    each other): what each rank's producer does must not depend on its
    timing. A stop must fall at the same point of every rank's program, so
    ``stop_fn`` never stops a phase, and after ``shutdown()`` the producer
    still makes every store whose gate the final consumed count opens (the
    same stores on every rank), then exits; ``shutdown`` waits for it. And
    the weights a store reads must be the same boundary's on every rank:
    ``prepare(snapshot)`` (the snapshot's adopt) runs before a store counts
    as started, and the trainer calls ``wait_due_started()`` before staging
    the next boundary, so store n reads boundary n - S (the initial weights
    for n <= S) on every rank."""

    def __init__(self, produce, new_store, max_staleness: int = 0, collective: bool = False, prepare=None):
        self._produce = produce
        self._new_store = new_store
        self.max_staleness = max(0, int(max_staleness))
        self.collective = bool(collective)
        self._prepare = prepare
        self._started = 0  # the last store index started (its snapshot adopted)
        self._cv = threading.Condition(threading.Lock())
        self._consumed = 0  # training iterations fully consumed
        self._ready = deque()  # completed stores, FIFO
        self.history = deque(maxlen=64)
        self._snapshot = None
        self._error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="trlx-rollout-producer", daemon=True)

    def start(self, snapshot=None):
        with self._cv:
            self._snapshot = snapshot
        self._thread.start()
        return self

    def _should_stop(self) -> bool:
        return self._stop.is_set() and not self.collective

    def _stopping(self, index: int) -> bool:
        """Store ``index`` is not to be made: stopped, and (collective) its
        gate shut at the final consumed count."""
        if not self._stop.is_set():
            return False
        return not (self.collective and staleness_gate_open(index, self._consumed, self.max_staleness))

    def _run(self):
        index = 1
        while True:
            with self._cv:
                while not self._stopping(index) and not staleness_gate_open(index, self._consumed,
                                                                            self.max_staleness):
                    self._cv.wait(timeout=0.5)
                if self._stopping(index):
                    return
                snapshot = self._snapshot
                staleness = index - self._consumed
            if self._prepare is not None:
                self._prepare(snapshot)
            with self._cv:
                self._started = index
                self._cv.notify_all()
            store = self._new_store()
            try:
                with trace_span("rollout/produce", index=index, staleness=staleness), graftscope.lane_span("producer"):
                    self._produce(store, index, snapshot, staleness, self._should_stop)
            except BaseException as e:  # noqa: BLE001 — re-raised in next_store()
                with self._cv:
                    self._error = e
                    self._cv.notify_all()
                return
            with self._cv:
                if self._stop.is_set():
                    if not self.collective:
                        return  # aborted mid-phase: the partial store is dropped
                    # collective: dropped too, but the next due store is still made
                else:
                    self._ready.append(store)
                    self.history.append({
                        "index": index,
                        "staleness": staleness,
                        "version": snapshot.get("version") if isinstance(snapshot, dict) else None,
                    })
                    self._cv.notify_all()
            index += 1

    def wait_due_started(self):
        """Block until no store whose gate is open waits to start (each
        started store has adopted its snapshot): then a new boundary may be
        staged without any store reading it by chance of timing."""
        with self._cv:
            while (staleness_gate_open(self._started + 1, self._consumed, self.max_staleness)
                   and self._thread.is_alive() and self._error is None and not self._stop.is_set()):
                self._cv.wait(timeout=0.5)

    def consume_done(self, snapshot=None):
        """Mark one training iteration fully consumed, optionally handing
        the producer the boundary snapshot to generate the next store from."""
        with self._cv:
            self._consumed += 1
            if snapshot is not None:
                self._snapshot = snapshot
            self._cv.notify_all()

    def next_store(self, timeout=None):
        """Block until the next completed store (FIFO). Re-raises a producer
        failure; raises TimeoutError past ``timeout`` seconds."""
        deadline = None if timeout is None else time.time() + timeout
        with self._cv:
            while True:
                if self._ready:
                    return self._ready.popleft()
                if self._error is not None:
                    e, self._error = self._error, None
                    raise e
                if not self._thread.is_alive():
                    raise RuntimeError("rollout producer thread exited without a completed store")
                if deadline is not None and time.time() >= deadline:
                    raise TimeoutError("timed out waiting for the rollout producer")
                self._cv.wait(timeout=0.5)

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._ready)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def shutdown(self, timeout: float = 60.0):
        """Stop and join. A mid-phase producer exits at its next
        between-chunk stop poll; the thread is a daemon, so a wedged produce
        fn cannot block process exit. ``collective``: the stores already due
        are finished first, and the join waits for them (a peer that never
        arrives is the collective guard's to end)."""
        with self._cv:
            self._stop.set()
            self._cv.notify_all()
        if self._thread.ident is not None and self._thread.is_alive():
            self._thread.join(timeout=None if self.collective else timeout)
