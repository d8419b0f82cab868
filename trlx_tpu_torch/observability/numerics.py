"""graftnum: the streaming numerics observatory (the counterpart of
``trlx_tpu.observability.numerics``): per-subtree gradient and update
telemetry, NaN provenance and quantization-error tracking.

Armed by ``train.graftnum`` (or ``TRLX_TPU_GRAFTNUM=1``), off by default.
Disarmed, every hook is one module-global load and the train step launches
what it launched before:

- **Per-subtree training telemetry.** ``train_step_stats`` reduces the
  eager gradient list and the parameters into ``num/grad_norm/<subtree>``,
  ``num/param_norm/<subtree>``, ``num/update_ratio/<subtree>`` (the
  REALIZED update over the parameter norm: exactly 0 on a guard-skipped
  step) and ``num/grad_global_norm``. Subtrees are the JAX tree's, one map
  level below the top-level groups (``transformer/h_0``, ``v_head/layers_0``),
  built from the port's dotted parameter names, which are the JAX tree's
  paths. The values stay device scalars (no host sync) and ride the
  Tracker → ``metrics.jsonl`` → ``MetricsExporter`` → report plumbing.
- **NaN provenance.** When the non-finite guard trips, ``nonfinite_census``
  names every non-finite gradient leaf by its JAX-form path
  (``transformer/h_0/attn/c_qkv/kernel``) and ``bisect_forward`` runs ONE
  eager re-forward of the offending batch with the probe taps of
  ``models/lm.py`` live (``embed`` → ``block_<i>`` → ``ln_f``), naming the
  first whose activations go non-finite. Both land in
  ``incidents/<step>/numerics.json``. The census also runs disarmed, whenever
  incidents are armed.
- **Quantization error.** ``record_weight_quant`` / ``record_kv_quant`` /
  ``record_weight_handoff`` measure the int8 round trip of the decode
  weights (per kernel class) and of an embedding-derived KV proxy at each
  weight handoff (the W8A16 quantize and refresh, the engine's
  ``update_weights``, the fleet's adoption), never inside a decode step:
  ``num/quant_err_max/<class>``, ``num/quant_err_rms/<class>``,
  ``num/quant_snr_db/<class>``, ``num/quant_weight_version`` and
  ``num/quant_versions_in_flight``.
- **Health.** ``GradNormSpikeDetector`` and ``UpdateRatioDetector`` ride the
  hysteresis state machine of ``observability.health``; with the health
  monitor armed they register through ``register_detector``, otherwise a
  CRIT escalates through ``observability.anomaly``'s emergency hook.

A probe tap returns its input, the same tensor, when no bisect session is
live, when the session belongs to another thread, and while the calling
stream captures a CUDA graph: no decode graph or train step ever holds a
live tap. Drill with ``TRLX_TPU_FAULTS=nan_layer@N``.
"""

import json
import math
import os
import threading

import numpy as np
import torch

from trlx_tpu_torch.observability.health import CRIT, OK, WARN, HysteresisDetector

__all__ = [
    "armed", "configure", "shutdown", "enabled", "instance", "train_step_stats", "param_subtrees",
    "subtree_of", "jax_path", "probe_tap", "bisect_forward", "latch_injection", "consume_injection",
    "nonfinite_census", "record_weight_quant", "record_kv_quant", "record_weight_handoff", "write_incident",
    "GradNormSpikeDetector", "UpdateRatioDetector", "escalate", "NUMERICS_FILENAME", "CENSUS_MAX_LEAVES",
]

NUMERICS_FILENAME = "numerics.json"

# Cap on census entries written to the incident bundle: a fully non-finite
# gradient has one entry per leaf; the first K by path are named and the
# rest counted.
CENSUS_MAX_LEAVES = 32


def armed(train_cfg) -> bool:
    """Config-or-environment arming, resolved when the trainer and its loss
    are built."""
    return bool(getattr(train_cfg, "graftnum", False)) or os.environ.get("TRLX_TPU_GRAFTNUM", "") not in ("", "0")


# ------------------------------------------------- per-subtree reductions


def jax_path(name: str) -> str:
    """A port parameter name in the JAX tree's path form:
    ``transformer.h_0.attn.c_qkv.kernel`` → ``transformer/h_0/attn/c_qkv/kernel``
    (the inverse of ``hf_import.params_from_jax``'s mapping)."""
    return name.replace(".", "/")


def subtree_of(name: str) -> str:
    """The subtree a parameter belongs to: its top-level group and the child
    below it (``transformer/h_0``), or the group alone for a top-level leaf."""
    return "/".join(name.split(".")[:2])


def param_subtrees(names) -> dict:
    """{subtree: [indices into ``names``]}, subtrees in first-seen order."""
    out = {}
    for i, name in enumerate(names):
        out.setdefault(subtree_of(name), []).append(i)
    return out


def tensor_sq(tensors, device) -> torch.Tensor:
    """[n] f32 device vector of each tensor's sum of squares (0 for None)."""
    present = [t.detach().float() for t in tensors if t is not None]
    norms = iter(torch._foreach_norm(present) if present else ())
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack([next(norms) if t is not None else zero for t in tensors]).pow(2)


_INDEX_CACHE = {}


def _host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor on ``device`` without a host sync (pinned, non
    blocking, on a CUDA device)."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def top_group(name: str) -> str:
    """A parameter's top-level group (``transformer``, ``v_head``)."""
    return name.split(".")[0]


def _group_index(names, key, weights, device):
    """(group names, [n] group id of each name, [n] weights or None) on
    ``device``, built once per (names, key, weights, device)."""
    cache_key = (tuple(names), key, None if weights is None else tuple(weights), str(device))
    hit = _INDEX_CACHE.get(cache_key)
    if hit is None:
        groups = {}
        for i, name in enumerate(names):
            groups.setdefault(key(name), []).append(i)
        ids = torch.empty((len(names),), dtype=torch.long)
        for j, idx in enumerate(groups.values()):
            ids[idx] = j
        w = None if weights is None else _host_to_device(torch.tensor(weights, dtype=torch.float32), device)
        hit = _INDEX_CACHE[cache_key] = (list(groups), _host_to_device(ids, device), w)
    return hit


def grouped_norms(names, sq: torch.Tensor, key=subtree_of, weights=None, group=None):
    """(group names, [rows, n_groups] norms): the rows of ``sq`` ([rows, n]
    sums of squares over ``names``) summed per group of ``key``, weighted by
    ``weights`` and all-reduced over ``group`` on a sharded mesh, then
    square-rooted. Device work only: no host sync."""
    dev = sq.device
    groups, ids, w = _group_index(names, key, weights, dev)
    if w is not None:
        sq = sq * w
    packed = torch.zeros((sq.shape[0], len(groups)), dtype=torch.float32, device=dev).index_add_(1, ids, sq)
    if group is not None:
        from trlx_tpu_torch.parallel import collectives as coll

        packed = coll.all_reduce(packed, group)
    return groups, packed.sqrt()


def train_step_stats(names, g_sq, p_sq, d_sq, weights=None, group=None) -> dict:
    """The ``num/*`` reductions of one train step, as device scalars (no
    host sync). ``g_sq``, ``p_sq`` and ``d_sq`` are [n] vectors over
    ``names`` (``tensor_sq``): each parameter's gradient (0 where none
    reaches it: a frozen one, as the JAX package's stopped gradient is), its
    value BEFORE the update, and its realized update ``new - old`` (0 where
    the step was skipped or the parameter is frozen). Per subtree of
    ``names``: the gradient norm, the parameter norm and the update ratio
    ``||new - old|| / (||old|| + 1e-12)``; and the global gradient norm. With
    ``weights`` (one over the processes holding the same piece) and
    ``group`` (every process of a sharded mesh) the sums run over the whole
    parameters."""
    subtrees, norms = grouped_norms(names, torch.stack([g_sq, p_sq, d_sq]), weights=weights, group=group)
    out = {"num/grad_global_norm": norms[0].pow(2).sum().sqrt()}
    for j, name in enumerate(subtrees):
        out[f"num/grad_norm/{name}"] = norms[0, j]
        out[f"num/param_norm/{name}"] = norms[1, j]
        out[f"num/update_ratio/{name}"] = norms[2, j] / (norms[1, j] + 1e-12)
    return out


# ------------------------------------------------------------- probe taps

_TAP_LOCK = threading.Lock()
_TAP_SESSION = None  # live ONLY inside bisect_forward's eager re-forward
_PENDING_INJECTION = None  # tap name latched by the nan_layer drill


def _capturing(x) -> bool:
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def probe_tap(name: str, x):
    """Activation tap at a model block boundary (``models/lm.py``). With no
    live session (every train step, every decode graph) this is one global
    load returning ``x`` itself. Live (inside ``bisect_forward``, on the
    bisecting thread, not under a graph capture) it records the tap's
    non-finite count and applies the drill's injection."""
    session = _TAP_SESSION
    if session is None or session.thread != threading.get_ident() or _capturing(x):
        return x
    return session.tap(name, x)


def latch_injection(tap_name: str):
    """Arm the ``nan_layer`` drill: the NEXT ``bisect_forward`` poisons the
    named tap's activations, the bisector's ground-truth target."""
    global _PENDING_INJECTION
    _PENDING_INJECTION = str(tap_name)


def consume_injection():
    global _PENDING_INJECTION
    target, _PENDING_INJECTION = _PENDING_INJECTION, None
    return target


class _TapSession:
    def __init__(self, inject=None):
        self.inject = inject
        self.records = []
        self.first_nonfinite = None
        self.thread = threading.get_ident()

    def tap(self, name, x):
        if self.inject is not None and name == self.inject:
            x = x * torch.tensor(float("nan"), dtype=x.dtype, device=x.device)
        if x.is_floating_point():
            nan, inf = int(torch.isnan(x).sum()), int(torch.isinf(x).sum())
        else:
            nan = inf = 0
        self.records.append({"tap": name, "nan": nan, "inf": inf, "size": int(x.numel())})
        if nan + inf and self.first_nonfinite is None:
            self.first_nonfinite = name
        return x

    def result(self) -> dict:
        return {"first_nonfinite": self.first_nonfinite, "injected": self.inject, "taps": self.records}


def bisect_forward(forward, inject=None) -> dict:
    """Run ``forward()`` (an eager model call on the offending batch) once
    with the probe taps live, and return which tap first produced NaN/Inf.
    Never raises: it runs on the incident path."""
    global _TAP_SESSION
    session = _TapSession(inject=inject)
    with _TAP_LOCK:
        _TAP_SESSION = session
        try:
            forward()
        except Exception as e:  # noqa: BLE001 — a NaN-tripped check mid-forward is fine
            session.records.append({"tap": "<error>", "error": repr(e)})
        finally:
            _TAP_SESSION = None
    return session.result()


# --------------------------------------------------------------- census


def nonfinite_census(named, max_leaves: int = CENSUS_MAX_LEAVES) -> dict:
    """Name every non-finite floating tensor of ``named`` ((port name,
    tensor) pairs) by its JAX-form path with its NaN / Inf counts. Reads
    each tensor on the host: incident path only."""
    out, total = [], 0
    for name, t in sorted(named, key=lambda kv: kv[0]):
        if t is None or not t.is_floating_point():
            continue
        nan, inf = int(torch.isnan(t).sum()), int(torch.isinf(t).sum())
        if nan + inf == 0:
            continue
        total += 1
        if len(out) < max_leaves:
            out.append({"path": jax_path(name), "nan": nan, "inf": inf, "size": int(t.numel())})
    return {"nonfinite_leaves": out, "total_nonfinite_leaves": total}


# ------------------------------------------------------ quantization error


def _accumulate(probe: dict, cls: str, w: torch.Tensor, deq: torch.Tensor):
    """Fold one round trip into ``probe[cls]`` = [max_abs_err, sum_sq_err,
    sum_sq_signal, count], the sums kept on the device (read once, by
    ``_quant_gauges``)."""
    err = w - deq
    stats = torch.stack([err.abs().max(), (err * err).sum(), (w * w).sum()])
    slot = probe.get(cls)
    if slot is None:
        probe[cls] = [stats, int(w.numel())]
    else:
        slot[0] = torch.stack([torch.maximum(slot[0][0], stats[0]), slot[0][1] + stats[1], slot[0][2] + stats[2]])
        slot[1] += int(w.numel())


def _quant_gauges(probe: dict, version=None) -> dict:
    gauges = {}
    for cls in sorted(probe):
        stats, count = probe[cls]
        max_err, sq_err, sq_sig = (float(v) for v in stats.tolist())
        gauges[f"num/quant_err_max/{cls}"] = float(max_err)
        gauges[f"num/quant_err_rms/{cls}"] = math.sqrt(sq_err / max(count, 1))
        # SNR in dB; an exact round trip caps at 200 so the gauge stays finite.
        gauges[f"num/quant_snr_db/{cls}"] = 10.0 * math.log10(sq_sig / sq_err) if sq_err > 0 and sq_sig > 0 else 200.0
    if gauges and version is not None:
        gauges["num/quant_weight_version"] = float(version)
    return gauges


def weight_quant_probe(module) -> dict:
    """{kernel class: [max_abs_err, sum_sq_err, sum_sq_signal, count]} of the
    int8 round trip (``ops.w8a16.quantize_channels``) of every Dense of
    ``module`` named in ``QUANT_KERNEL_NAMES``. On a sharded mesh each rank
    reads its own pieces."""
    from trlx_tpu_torch.ops.w8a16 import QUANT_KERNEL_NAMES, quantize_channels

    probe = {}
    with torch.no_grad():
        for name, mod in module.named_modules():
            cls = name.rpartition(".")[2]
            if cls not in QUANT_KERNEL_NAMES or not hasattr(mod, "kernel"):
                continue
            w = mod.kernel.detach().float()
            codes, scale = quantize_channels(w)
            _accumulate(probe, cls, w, codes.float() * scale)
    return probe


def kv_quant_probe(x: torch.Tensor, label: str = "kv") -> dict:
    """The int8 KV round trip (``models.lm.quantize_kv``) of ``x`` [b, t, h, d]."""
    from trlx_tpu_torch.models.lm import quantize_kv

    probe = {}
    with torch.no_grad():
        xf = x.detach().float()
        q, scale = quantize_kv(xf)
        _accumulate(probe, label, xf, q.float() * scale[..., None])
    return probe


def record_weight_quant(module, version=None) -> dict:
    """The int8 round-trip error of ``module``'s quantizable kernels, per
    kernel class, recorded as gauges on the armed observatory. Best-effort:
    a handoff never fails for telemetry."""
    state = _STATE
    if state is None:
        return {}
    try:
        gauges = _quant_gauges(weight_quant_probe(module), version=version)
    except Exception:  # noqa: BLE001
        return {}
    state.update_gauges(gauges)
    return gauges


def record_kv_quant(x, label: str = "kv") -> dict:
    """The int8 KV round-trip error over an activation tensor (at a weight
    handoff, the embedding proxy of ``record_weight_handoff``)."""
    state = _STATE
    if state is None:
        return {}
    try:
        gauges = _quant_gauges(kv_quant_probe(x, label))
    except Exception:  # noqa: BLE001
        return {}
    state.update_gauges(gauges)
    return gauges


def _embedding_proxy(module, rows: int = 64):
    """A [1, rows, 1, d_model] pseudo-activation: the first rows of the token
    embedding table, a deterministic stand-in for KV content at a handoff
    (the per-version trend is the signal, not the absolute SNR)."""
    for name, p in module.named_parameters():
        if name.endswith("wte.embedding") and p.dim() == 2:
            take = min(rows, int(p.shape[0]))
            return p.detach()[:take].reshape(1, take, 1, int(p.shape[1]))
    return None


# Versions seen at recent weight handoffs, newest last: with in-flight
# updates a phase's episodes can span several versions, and this window
# says how many are live at once.
_HANDOFF_VERSIONS: list = []
_HANDOFF_WINDOW = 8


def record_weight_handoff(module, version=None) -> dict:
    """The quantization probe at a versioned weight handoff (the engine's
    ``update_weights``, the fleet's adoption): the weights' round-trip error
    per kernel class, the embedding proxy's KV error, and the distinct
    versions across the recent handoffs. A no-op when disarmed."""
    if _STATE is None or module is None:
        return {}
    gauges = dict(record_weight_quant(module, version=version))
    proxy = _embedding_proxy(module)
    if proxy is not None:
        gauges.update(record_kv_quant(proxy))
    if version is not None:
        _HANDOFF_VERSIONS.append(int(version))
        del _HANDOFF_VERSIONS[:-_HANDOFF_WINDOW]
        inflight = {"num/quant_versions_in_flight": float(len(set(_HANDOFF_VERSIONS)))}
        _STATE.update_gauges(inflight)
        gauges.update(inflight)
    return gauges


# ------------------------------------------------------------- detectors


class GradNormSpikeDetector(HysteresisDetector):
    """Global gradient norm against its own rolling p50: WARN past
    ``warn_factor`` × p50, CRIT past ``crit_factor`` × p50 (or non-finite).
    A spike is judged before it enters the window."""

    name = "grad_norm_spike"

    def __init__(self, warn_factor: float = 3.0, crit_factor: float = 10.0, window: int = 64, warmup: int = 5,
                 **streaks):
        super().__init__(**streaks)
        self.warn_factor = float(warn_factor)
        self.crit_factor = float(crit_factor)
        self.window = int(window)
        self.warmup = int(warmup)
        self.value = 0.0
        self._history = []

    def p50(self) -> float:
        return float(np.median(self._history)) if self._history else 0.0

    def severity(self, obs) -> int:
        g = float(obs)
        self.value = g
        baseline = self.p50()
        seeded = len(self._history) >= self.warmup
        sev = 0
        if not math.isfinite(g):
            sev = 2
        elif seeded and baseline > 0:
            if g > self.crit_factor * baseline:
                sev = 2
            elif g > self.warn_factor * baseline:
                sev = 1
        if sev == 0 and math.isfinite(g):
            self._history.append(g)  # only clean observations feed the baseline
            if len(self._history) > self.window:
                self._history.pop(0)
        return sev


class UpdateRatioDetector(HysteresisDetector):
    """Per-subtree update/parameter ratio band [lo, hi]: above it the
    optimizer rewrites a subtree; a wholly stalled step (every ratio 0: a
    guard skip, a dead schedule) violates too. Severity scales with the
    violating share."""

    name = "update_ratio"

    def __init__(self, lo: float = 1e-8, hi: float = 1e-1, warmup: int = 5, **streaks):
        super().__init__(**streaks)
        self.lo = float(lo)
        self.hi = float(hi)
        self.warmup = int(warmup)
        self.seen = 0
        self.violating = 0
        self.total = 0

    def severity(self, obs) -> int:
        ratios = {k: float(v) for k, v in dict(obs).items()}
        self.total = len(ratios)
        self.seen += 1
        if not ratios:
            return 0
        bad = sum(1 for r in ratios.values() if not math.isfinite(r) or r > self.hi or (0.0 < r < self.lo))
        stalled = all(r == 0.0 for r in ratios.values())
        self.violating = bad + (self.total if stalled else 0)
        if self.seen <= self.warmup:
            return 0
        extreme = any(not math.isfinite(r) or r > 10.0 * self.hi for r in ratios.values())
        if extreme or self.violating >= max(1, self.total // 2 + self.total % 2):
            return 2 if self.violating else 0
        return 1 if self.violating else 0


def escalate(detector, obs):
    """CRIT escalation with no health monitor to adopt the detectors: the
    emergency incident hook, under the monitor's own ``health_<name>``
    reason."""
    from trlx_tpu_torch.observability.anomaly import emergency_capture

    detail = {"detector": detector.name, "severity": int(detector.last_severity)}
    if isinstance(obs, dict):
        detail.update({k: v for k, v in obs.items() if isinstance(v, (int, float))})
    else:
        try:
            detail["observation"] = float(obs)
        except (TypeError, ValueError):
            pass
    emergency_capture(f"health_{detector.name}", detail=detail)


# -------------------------------------------------------- module instance


class _Numerics:
    """Process-global armed state: the two detectors and the latest
    quantization gauges (set at handoffs, drained at log boundaries)."""

    def __init__(self):
        self.grad_detector = GradNormSpikeDetector()
        self.ratio_detector = UpdateRatioDetector()
        self.detectors = (self.grad_detector, self.ratio_detector)
        self._gauges = {}
        self._lock = threading.Lock()

    def update_gauges(self, gauges: dict):
        if not gauges:
            return
        with self._lock:
            self._gauges.update(gauges)

    def observe_train(self, stats_host: dict):
        """The log-boundary feed from the synced stats."""
        g = stats_host.get("num/grad_global_norm")
        if g is not None:
            self.grad_detector.observe(float(g))
        prefix = "num/update_ratio/"
        ratios = {k[len(prefix):]: v for k, v in stats_host.items() if k.startswith(prefix)}
        if ratios:
            self.ratio_detector.observe(ratios)

    def gauges(self, include_states: bool = False) -> dict:
        """The latest quantization gauges (and the detectors' states when no
        health monitor emits them)."""
        with self._lock:
            out = dict(self._gauges)
        if include_states:
            level = {OK: 0.0, WARN: 1.0, CRIT: 2.0}
            for d in self.detectors:
                out[f"health/{d.name}_state"] = level[d.state]
        return out


_STATE = None


def configure() -> _Numerics:
    """Arm the process-global observatory (trainer construction owns it: an
    earlier trainer's gauges do not leak into this run)."""
    global _STATE
    _STATE = _Numerics()
    del _HANDOFF_VERSIONS[:]
    return _STATE


def shutdown():
    global _STATE, _PENDING_INJECTION
    _STATE = None
    _PENDING_INJECTION = None


def enabled() -> bool:
    return _STATE is not None


def instance():
    return _STATE


# -------------------------------------------------------- incident writer


def write_incident(bundle_dir: str, payload: dict):
    """Attach the numerics forensics to an incident bundle (best-effort).
    Returns the written path or None."""
    if not bundle_dir:
        return None
    try:
        path = os.path.join(bundle_dir, NUMERICS_FILENAME)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        return path
    except (OSError, TypeError, ValueError):
        return None
