"""graftnum in the port (``trlx_tpu_torch.observability.numerics``) against
the JAX package's (``trlx_tpu.observability.numerics``), on the CPU.

Twins of ``tests/test_numerics.py`` on the same seeded inputs: the probe
tap (the same tensor back when disarmed, when the session belongs to
another thread and under a graph capture, the torch counterpart of the
JAX test's identical jaxpr), the per-subtree reductions against the JAX
reductions (rel 1e-5, f32 both sides) and with no host sync, the census
and its cap, the bisector on a synthetic chain and on a tiny model on
shared weights (the same taps and NaN counts as the JAX model's), the
injection latch, the quantization probes against the JAX probes (rel 1e-5),
quantization with graftnum armed giving the same int8 codes as disarmed,
the engine's two handoffs, the no-op records, both detectors (their
severities held against the JAX detectors' on the same seeded streams), the
escalation, the instance, the Prometheus names, the armed ``nan_layer``
drill and the disarmed ``nan_grad`` census (C6).

Beyond the twins, on shared weights (``params_from_jax``) through
``trlx_tpu.train`` and ``trlx_tpu_torch.train`` with the forced-bigram
task (sampling is deterministic, so both packages train on the same
batches): the ``num/*`` values of the first steps per subtree (rel 2e-4,
the PPO step tolerance ``tests/test_torch_train.py`` states), the guard-skip
census (the same leaf paths and NaN/Inf counts: the port differentiates
only the trainable parameters, and the JAX package's stopped gradient gives
the frozen ones zeros, so the two name the same leaves) and the bisect's
first block under ``nan_layer@N``.
"""

import dataclasses
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import trlx_tpu  # noqa: E402
import trlx_tpu_torch  # noqa: E402
from randomwalks import base_config, generate_random_walks  # noqa: E402
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig  # noqa: E402
from trlx_tpu.models import LMConfig as JaxLMConfig  # noqa: E402
from trlx_tpu.models import LMWithValueHead as JaxLMWithValueHead  # noqa: E402
from trlx_tpu.models.lm import quantize_kv as jax_quantize_kv  # noqa: E402
from trlx_tpu.models.lm import quantize_weights as jax_quantize_weights  # noqa: E402
from trlx_tpu.observability import numerics as jax_numerics  # noqa: E402
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.models.heads import LMWithValueHead  # noqa: E402
from trlx_tpu_torch.models.hf_import import params_from_jax  # noqa: E402
from trlx_tpu_torch.models.lm import LMConfig  # noqa: E402
from trlx_tpu_torch.observability import anomaly as obs_anomaly  # noqa: E402
from trlx_tpu_torch.observability import numerics as obs_numerics  # noqa: E402
from trlx_tpu_torch.observability import report  # noqa: E402
from trlx_tpu_torch.observability import spans as obs_spans  # noqa: E402
from trlx_tpu_torch.observability.export import _VALID, sanitize_metric_name  # noqa: E402
from trlx_tpu_torch.observability.health import CRIT, OK, WARN  # noqa: E402
from trlx_tpu_torch.observability.numerics import (  # noqa: E402
    GradNormSpikeDetector,
    UpdateRatioDetector,
    bisect_forward,
    nonfinite_census,
    param_subtrees,
    probe_tap,
    tensor_sq,
    train_step_stats,
)
from trlx_tpu_torch.ops.w8a16 import quantize_weights  # noqa: E402
from trlx_tpu_torch.trainer import register_model  # noqa: E402
from trlx_tpu_torch.trainer.ppo import PPOTrainer  # noqa: E402

torch.set_num_threads(1)

STATS_RTOL = 1e-5  # f32 reductions of the same values in both packages
RUN_RTOL = 2e-4  # values after PPO steps on shared weights (tests/test_torch_train.py's step tolerance)


@pytest.fixture(autouse=True)
def _numerics_isolation():
    """graftnum's state is process-global: disarm both packages' after each
    test."""
    yield
    obs_numerics.shutdown()
    jax_numerics.shutdown()
    obs_spans.shutdown()
    obs_anomaly.register_emergency(None)


def _flatten(tree, prefix=""):
    """A nested dict of arrays → [(dotted name, array)] in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out += _flatten(v, name)
        else:
            out.append((name, v))
    return out


def _tiny_models(n_layer=2):
    """(JAX module, JAX params, the port's module on the same weights)."""
    kw = dict(vocab_size=23, n_layer=n_layer, n_head=2, d_model=32, max_position=64, dtype="float32")
    jmodel = JaxLMWithValueHead(JaxLMConfig(**kw))
    rng = jax.random.PRNGKey(0)
    ids = jax.random.randint(rng, (2, 6), 2, kw["vocab_size"])
    mask = jnp.ones((2, 6), jnp.int32)
    params = jax.device_get(jmodel.init(rng, ids, mask)["params"])
    tmodel = LMWithValueHead(LMConfig(**kw), device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tmodel))
    tmodel.requires_grad_(False)
    return jmodel, {"params": params}, tmodel, np.array(ids), np.array(mask)


# --------------------------------------------------------- disarmed contract


def test_disarmed_tap_returns_the_same_tensor_and_is_inert_under_capture(monkeypatch):
    """The port's form of the JAX test's identical jaxpr: a tap with no live
    session returns the very tensor it was given (nothing runs, nothing is
    copied); a live session on another thread, or a stream under graph
    capture, leaves it untouched too, so a decode graph never holds a live
    tap."""
    x = torch.ones((3, 4))
    assert probe_tap("embed", x) is x
    seen = {}

    def other_thread():
        seen["tap"] = probe_tap("block_0", x)

    def forward():
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
        seen["own"] = probe_tap("block_0", x)

    out = bisect_forward(forward, inject="block_0")
    assert seen["tap"] is x  # another thread's forward is not the bisector's
    assert seen["own"] is not x and torch.isnan(seen["own"]).all()
    assert [t["tap"] for t in out["taps"]] == ["block_0"]

    monkeypatch.setattr(obs_numerics, "_capturing", lambda t: True)
    captured = {}
    bisect_forward(lambda: captured.setdefault("tap", probe_tap("block_0", x)), inject="block_0")
    assert captured["tap"] is x  # a capture never records a live tap


def test_armed_resolves_config_or_env(monkeypatch):
    class T:
        graftnum = False

    monkeypatch.delenv("TRLX_TPU_GRAFTNUM", raising=False)
    for env, flag, want in ((None, False, False), (None, True, True), ("1", False, True), ("0", False, False)):
        if env is not None:
            monkeypatch.setenv("TRLX_TPU_GRAFTNUM", env)
        T.graftnum = flag
        assert obs_numerics.armed(T()) == jax_numerics.armed(T()) == want


# ------------------------------------------------------ reduction parity


def _stats_tree(seed):
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.normal(size=shape).astype(np.float32)

    params = {"policy": {"h_0": {"w": leaf(4, 4), "b": leaf(4)}, "wte": {"embedding": leaf(9, 4)}},
              "value_head": {"kernel": leaf(4, 1)}}
    grads = jax.tree_util.tree_map(lambda p: p * 0.1 + 0.3, params)
    new = jax.tree_util.tree_map(lambda p, g: p - 0.01 * g, params, grads)
    return params, grads, new


def _port_stats(params, grads, new):
    names = [n for n, _ in _flatten(params)]
    t = {n: torch.from_numpy(np.asarray(a)) for n, a in _flatten(params)}
    g = {n: torch.from_numpy(np.asarray(a)) for n, a in _flatten(grads)}
    d = {n: torch.from_numpy(np.asarray(a)) for n, a in _flatten(new)}
    g_sq = tensor_sq([g[n] for n in names], torch.device("cpu"))
    p_sq = tensor_sq([t[n] for n in names], torch.device("cpu"))
    d_sq = tensor_sq([d[n] - t[n] for n in names], torch.device("cpu"))
    return names, train_step_stats(names, g_sq, p_sq, d_sq)


@pytest.mark.parametrize("seed", [7, 8])
def test_train_step_stats_equal_jax(seed):
    params, grads, new = _stats_tree(seed)
    ref = {k: float(v) for k, v in jax_numerics.train_step_stats(
        jax.tree_util.tree_map(jnp.asarray, grads), jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, new)).items()}
    names, got = _port_stats(params, grads, new)
    assert set(param_subtrees(names)) == {"policy/h_0", "policy/wte", "value_head/kernel"}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), ref[k], rtol=STATS_RTOL, err_msg=k)


def test_train_step_stats_make_no_host_sync(monkeypatch):
    """The armed statistics stay on the device: every host read of a tensor
    raises inside the call, and the values come back as tensors."""
    params = {"g": {"w": np.ones((3, 3), np.float32)}}
    grads = {"g": {"w": np.full((3, 3), 2.0, np.float32)}}
    new = {"g": {"w": np.full((3, 3), 0.5, np.float32)}}

    def refuse(*a, **k):
        raise AssertionError("host sync")

    for attr in ("item", "tolist", "numpy", "cpu", "__float__", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    names, out = _port_stats(params, grads, new)
    monkeypatch.undo()
    assert all(isinstance(v, torch.Tensor) for v in out.values())
    assert float(out["num/grad_global_norm"]) == pytest.approx(6.0)
    assert float(out["num/update_ratio/g/w"]) == pytest.approx(0.5, rel=1e-5)


# ----------------------------------------------------------------- census


def test_census_names_exact_poisoned_leaf():
    kernel = np.ones((4, 4), np.float32)
    bad = kernel.copy()
    bad[1, 2] = np.nan
    tree = {"policy": {"h_0": {"kernel": kernel}, "h_1": {"kernel": bad}}, "ids": np.ones((3,), np.int32)}
    ref = jax_numerics.nonfinite_census(jax.tree_util.tree_map(jnp.asarray, tree))
    got = nonfinite_census([(n, torch.from_numpy(a)) for n, a in _flatten(tree)])
    assert got == ref
    assert got["total_nonfinite_leaves"] == 1
    (entry,) = got["nonfinite_leaves"]
    assert entry == {"path": "policy/h_1/kernel", "nan": 1, "inf": 0, "size": 16}


def test_census_caps_named_leaves_but_counts_all():
    tree = {f"g_{i:02d}": np.full((2,), np.inf, np.float32) for i in range(40)}
    ref = jax_numerics.nonfinite_census(jax.tree_util.tree_map(jnp.asarray, tree), max_leaves=5)
    got = nonfinite_census([(n, torch.from_numpy(a)) for n, a in _flatten(tree)], max_leaves=5)
    assert got == ref
    assert got["total_nonfinite_leaves"] == 40 and len(got["nonfinite_leaves"]) == 5
    assert all(e["inf"] == 2 for e in got["nonfinite_leaves"])


# --------------------------------------------------------------- bisector


def test_bisect_synthetic_chain_names_injected_tap():
    def chain(tap, x):
        for i in range(3):
            x = tap(f"block_{i}", x * 1.5)

    got = bisect_forward(lambda: chain(probe_tap, torch.ones((2, 3))), inject="block_1")
    ref = jax_numerics.bisect_forward(lambda: chain(jax_numerics.probe_tap, jnp.ones((2, 3))), inject="block_1")
    assert got == ref
    assert got["first_nonfinite"] == "block_1" and got["injected"] == "block_1"
    assert [t["tap"] for t in got["taps"]] == ["block_0", "block_1", "block_2"]
    assert got["taps"][0]["nan"] == 0 and got["taps"][1]["nan"] == got["taps"][1]["size"] == 6
    x = torch.ones(())
    assert probe_tap("block_1", x) is x  # the session is torn down


def test_bisect_clean_forward_and_error_capture():
    assert bisect_forward(lambda: probe_tap("a", torch.ones(())))["first_nonfinite"] is None

    def boom():
        probe_tap("a", torch.ones(()))
        raise RuntimeError("mid-forward assert")

    out = bisect_forward(boom)
    assert out["first_nonfinite"] is None
    assert out["taps"][-1]["tap"] == "<error>" and "mid-forward assert" in out["taps"][-1]["error"]


@pytest.mark.parametrize("inject", ["block_1", "embed"])
def test_bisect_real_model_equals_jax(inject):
    """The taps ``models/lm.py`` registers (embed → block_<i> → ln_f) fire in
    an eager forward, in the JAX model's order, with its NaN counts, and the
    injected tap is named first."""
    jmodel, jparams, tmodel, ids, mask = _tiny_models(n_layer=3)
    ref = jax_numerics.bisect_forward(lambda: jmodel.apply(jparams, jnp.asarray(ids), jnp.asarray(mask)),
                                      inject=inject)
    with torch.no_grad():
        got = bisect_forward(lambda: tmodel(torch.from_numpy(ids), torch.from_numpy(mask)), inject=inject)
    assert got == ref
    assert got["first_nonfinite"] == inject
    names = [t["tap"] for t in got["taps"]]
    assert names == ["embed", "block_0", "block_1", "block_2", "ln_f"]


def test_injection_latch_is_one_shot():
    obs_numerics.latch_injection("block_3")
    assert obs_numerics.consume_injection() == "block_3"
    assert obs_numerics.consume_injection() is None


# ------------------------------------------------------ quantization error


def test_quant_probe_gauges_equal_jax():
    """The weight round trip per kernel class and the KV round trip, against
    the JAX package's probes on the same seeded values."""
    _, jparams, tmodel, _, _ = _tiny_models()
    jprobe = {}
    jax_quantize_weights(jax.tree_util.tree_map(jnp.asarray, jparams["params"]), probe=jprobe)
    ref = jax_numerics._quant_gauges(jprobe, version=4)
    got = obs_numerics._quant_gauges(obs_numerics.weight_quant_probe(tmodel), version=4)
    assert set(got) == set(ref) and got["num/quant_weight_version"] == 4.0
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=STATS_RTOL, err_msg=k)
    for cls in {k.rpartition("/")[2] for k in got if k.startswith("num/quant_err_rms/")}:
        assert 0.0 < got[f"num/quant_err_rms/{cls}"] < 1.0
        assert got[f"num/quant_err_max/{cls}"] >= got[f"num/quant_err_rms/{cls}"]
        assert 20.0 < got[f"num/quant_snr_db/{cls}"] <= 200.0

    x = np.random.default_rng(3).normal(size=(1, 4, 2, 8)).astype(np.float32)
    kv_probe = {}
    jax_quantize_kv(jnp.asarray(x), probe=kv_probe, probe_class="kv")
    kv_ref = jax_numerics._quant_gauges(kv_probe)
    kv_got = obs_numerics._quant_gauges(obs_numerics.kv_quant_probe(torch.from_numpy(x)))
    assert set(kv_got) == set(kv_ref) and kv_got["num/quant_err_rms/kv"] > 0.0
    for k in kv_ref:
        np.testing.assert_allclose(kv_got[k], kv_ref[k], rtol=STATS_RTOL, err_msg=k)


def test_armed_quantization_gives_identical_codes():
    """Disarmed quantization is what it was: with graftnum armed and a
    record at the handoff, the int8 codes and scales are bit-equal to a
    disarmed quantization of the same weights."""
    _, _, a, _, _ = _tiny_models()
    _, _, b, _, _ = _tiny_models()
    quantize_weights(a)
    obs_numerics.configure()
    quantize_weights(b)
    assert obs_numerics.record_weight_quant(b, version=1)
    held_a = {n: m.w8 for n, m in a.named_modules() if getattr(m, "w8", None) is not None}
    held_b = {n: m.w8 for n, m in b.named_modules() if getattr(m, "w8", None) is not None}
    assert held_a and held_a.keys() == held_b.keys()
    for n in held_a:
        assert torch.equal(held_a[n][1], held_b[n][1]) and torch.equal(held_a[n][2], held_b[n][2]), n


def test_quant_gauges_across_two_engine_weight_versions():
    """Two ``update_weights`` handoffs refresh the armed observatory's
    gauges with the new version tag, and scaled weights move the error
    gauges (a live probe, not a cached constant)."""
    from trlx_tpu_torch.engine import RolloutEngine
    from trlx_tpu_torch.ops.sampling import GenerateConfig

    _, _, tmodel, _, _ = _tiny_models()
    engine = RolloutEngine(tmodel, GenerateConfig(max_new_tokens=4, do_sample=False, pad_token_id=0), n_slots=2,
                           prompt_width=4)
    obs_numerics.configure()
    try:
        engine.update_weights(tmodel, version=0)
        g0 = obs_numerics.instance().gauges()
        rms = [k for k in g0 if k.startswith("num/quant_err_rms/")]
        assert rms and g0["num/quant_weight_version"] == 0.0
        assert any(k.startswith("num/quant_snr_db/kv") for k in g0)  # the embedding proxy
        with torch.no_grad():
            for p in tmodel.parameters():
                p.mul_(3.0)
        engine.update_weights(tmodel, version=1)
        g1 = obs_numerics.instance().gauges()
        assert g1["num/quant_weight_version"] == 1.0 and g1["num/quant_versions_in_flight"] == 2.0
        assert any(g1[k] != g0[k] for k in rms)
    finally:
        engine.shutdown()


def test_record_functions_are_noops_when_disarmed():
    _, _, tmodel, _, _ = _tiny_models()
    assert obs_numerics.record_weight_quant(tmodel) == {}
    assert obs_numerics.record_weight_handoff(tmodel, version=1) == {}
    assert not obs_numerics.enabled()


# -------------------------------------------------------------- detectors


def _walk(port, ref, values):
    for v in values:
        assert port.observe(v) == ref.observe(v), v
        assert port.last_severity == ref.last_severity
    return port


def test_grad_spike_detector_walks_warn_then_crit():
    kw = dict(warn_factor=3.0, crit_factor=10.0, warmup=4, warn_streak=1, crit_streak=2)
    d = GradNormSpikeDetector(**kw)
    ref = jax_numerics.GradNormSpikeDetector(**kw)
    for _ in range(6):
        assert d.observe(1.0) == ref.observe(1.0) == OK
    assert d.observe(5.0) == WARN and ref.observe(5.0) == WARN
    assert d.observe(50.0) == WARN and ref.observe(50.0) == WARN
    assert d.observe(50.0) == CRIT and ref.observe(50.0) == CRIT
    assert d.p50() == pytest.approx(1.0) == ref.p50()
    assert d.severity(float("nan")) == 2


@pytest.mark.parametrize("seed", range(2))
def test_detectors_equal_jax_on_seeded_streams(seed):
    """Seeded grad-norm and update-ratio streams with spikes, stalls and
    non-finite values: both packages' detectors walk the same states."""
    rng = np.random.default_rng(seed)
    norms = [float(v) for v in rng.lognormal(0, 0.3, 80)]
    for i in rng.integers(0, 80, 10):
        norms[int(i)] *= float(rng.choice([5.0, 20.0, np.nan]))
    _walk(GradNormSpikeDetector(warmup=3, warn_streak=1, crit_streak=2),
          jax_numerics.GradNormSpikeDetector(warmup=3, warn_streak=1, crit_streak=2), norms)
    ratios = []
    for _ in range(60):
        r = {f"s{j}": float(rng.choice([1e-4, 0.0, 0.5, 2.0, np.inf], p=[0.7, 0.1, 0.1, 0.05, 0.05]))
             for j in range(3)}
        ratios.append(r)
    _walk(UpdateRatioDetector(warmup=2, warn_streak=1, crit_streak=2),
          jax_numerics.UpdateRatioDetector(warmup=2, warn_streak=1, crit_streak=2), ratios)


def test_grad_spike_detector_warmup_suppresses_judgment():
    d = GradNormSpikeDetector(warmup=5, warn_streak=1, crit_streak=1)
    for v in (1.0, 100.0, 1.0, 100.0):  # fewer than warmup clean observations
        assert d.severity(v) == 0


def test_update_ratio_detector_bands():
    d = UpdateRatioDetector(lo=1e-6, hi=1e-2, warmup=1, warn_streak=1, crit_streak=2)
    ok = {"a": 1e-4, "b": 1e-3, "c": 1e-3}
    assert d.observe(ok) == OK
    assert d.observe(ok) == OK
    assert d.observe({**ok, "a": 5e-2}) == WARN
    assert d.observe({**ok, "a": 5e-1}) == WARN
    assert d.observe({**ok, "a": 5e-1}) == CRIT
    d2 = UpdateRatioDetector(warmup=0, warn_streak=1, crit_streak=1)
    assert d2.observe({"a": 0.0, "b": 0.0}) == CRIT  # a wholly stalled step


def test_escalate_without_monitor_captures_health_incident():
    captured = []

    class _FakeCapture:
        def capture(self, step, reason, detail=None):
            captured.append((reason, detail))

    obs_anomaly.register_emergency(_FakeCapture())
    d = GradNormSpikeDetector(warmup=1, warn_streak=1, crit_streak=1)
    d.on_crit = obs_numerics.escalate
    d.observe(1.0), d.observe(1.0)
    d.observe(1e6)
    assert captured and captured[0][0] == "health_grad_norm_spike"
    assert captured[0][1]["detector"] == "grad_norm_spike"


def test_numerics_instance_feeds_detectors_and_emits_states():
    inst = obs_numerics.configure()
    stats = {"num/grad_global_norm": 1.0, "num/update_ratio/policy/h_0": 1e-4, "loss": 0.5}
    for _ in range(8):
        inst.observe_train(stats)
    g = inst.gauges(include_states=True)
    assert g["health/grad_norm_spike_state"] == 0.0 and g["health/update_ratio_state"] == 0.0
    assert inst.grad_detector.observations == 8
    assert obs_numerics.instance().gauges(include_states=False) == {}


def test_all_num_keys_survive_prometheus_sanitization_without_collisions():
    """Every key graftnum emits (from the port's own parameter names) maps
    to a unique legal Prometheus name."""
    _, _, tmodel, _, _ = _tiny_models()
    names = [n for n, _ in tmodel.named_parameters()]
    sq = tensor_sq([p for _, p in tmodel.named_parameters()], torch.device("cpu"))
    keys = set(train_step_stats(names, sq, sq, sq))
    keys |= set(obs_numerics._quant_gauges(obs_numerics.weight_quant_probe(tmodel), version=1))
    keys |= set(obs_numerics._quant_gauges(obs_numerics.kv_quant_probe(torch.ones(1, 2, 1, 4))))
    keys |= set(obs_numerics.configure().gauges(include_states=True))
    keys.add("num/quant_versions_in_flight")
    sanitized = {}
    for k in keys:
        name = sanitize_metric_name(k)
        assert _VALID.match(name), (k, name)
        assert name not in sanitized, f"collision: {k} vs {sanitized[name]}"
        sanitized[name] = k


# ------------------------------------------------------------ integration


@pytest.fixture(scope="module")
def task():
    return generate_random_walks(n_nodes=15, max_length=8, n_walks=60, seed=1000)


def _walk_config(ckpt_dir, **train):
    jcfg = base_config("ppo", 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.epochs = 1
    config.train.batch_size = 16
    config.train.eval_interval = 100
    config.train.checkpoint_dir = str(ckpt_dir)
    config.method.num_rollouts = 16
    config.method.chunk_size = 16
    for k, v in train.items():
        setattr(config.train, k, v)
    return config


def _prompts():
    return [[int(np.random.default_rng(i).integers(1, 15))] for i in range(32)]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _numerics_payloads(ckpt_dir):
    out = []
    incidents = os.path.join(str(ckpt_dir), "incidents")
    for name in sorted(os.listdir(incidents)):
        p = os.path.join(incidents, name, "numerics.json")
        if os.path.exists(p):
            with open(p) as f:
                out.append(json.load(f))
    return out


def test_e2e_nan_layer_drill_names_layer_and_leaves(task, tmp_path, monkeypatch):
    """Armed PPO under nan_layer@2 on a 4-layer model: the guard skips step
    2, the bundle's numerics.json names block_2 first (the latched injection)
    and the non-finite gradient leaves by path, num/* rides metrics.jsonl,
    and the report (written by learn()) has the Numerics section."""
    monkeypatch.setenv("TRLX_TPU_FAULTS", "nan_layer@2")
    _, logit_mask, metric_fn, reward_fn = task
    config = _walk_config(tmp_path, total_steps=4, graftnum=True)
    config.model.model_arch["n_layer"] = 4
    model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(), eval_prompts=[[1]], metric_fn=metric_fn,
                                 config=config, logit_mask=logit_mask, device="cpu")
    assert model.skipped_steps >= 1
    assert not any(t.name.startswith("trlx-") for t in threading.enumerate())
    scalars = [r for r in _records(os.path.join(str(tmp_path), "metrics.jsonl")) if "num/grad_global_norm" in r]
    assert scalars
    assert any(k.startswith("num/update_ratio/") for k in scalars[-1])
    assert any(k.startswith("num/grad_norm/") for k in scalars[-1])

    (payload,) = _numerics_payloads(tmp_path)
    census = payload["grad_census"]
    assert census["total_nonfinite_leaves"] > 0
    assert all("/" in e["path"] for e in census["nonfinite_leaves"])
    bisect = payload["forward_bisect"]
    assert bisect["injected"] == "block_2" and bisect["first_nonfinite"] == "block_2"
    taps = {t["tap"]: t for t in bisect["taps"] if "tap" in t}
    assert taps["block_1"]["nan"] == 0  # the blocks before are clean
    assert obs_numerics.consume_injection() is None

    with open(os.path.join(str(tmp_path), "report.md")) as f:
        md = f.read()
    for text in (md, report.build_report(str(tmp_path))):
        assert "## Numerics (graftnum)" in text and "block_2" in text and "nonfinite grad leaves" in text


# --------------------------------------------- shared weights: port vs JAX

V, P, R = 31, 10, 6
_JAX_INIT = {}


@register_model("PPONumericsFromJaxInit")
class _PPONumerics(PPOTrainer):
    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        self.load_params(params_from_jax(_JAX_INIT["params"], self.model),
                         params_from_jax(_JAX_INIT["extras"], self.model))


def _bigram_config(ckpt_dir, **train):
    arch = dict(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
                extra={"lm_head_bias": True})
    return {
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32"),
        "train": {**dict(total_steps=4, seq_length=P + R, epochs=1, batch_size=8, lr_ramp_steps=2, lr_decay_steps=12,
                         weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4,
                         checkpoint_interval=10**6, eval_interval=100, checkpoint_dir=str(ckpt_dir), seed=11), **train},
        "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=2, init_kl_coef=0.3, target=1.0,
                       horizon=50, vf_coef=0.5,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    }


def _run_both(tmp_path, **train):
    """The forced-bigram PPO run through both packages, the port from the
    JAX trainer's initial weights (each token has one allowed successor, so
    both sample the same episodes). Returns {package: (model, records,
    ckpt dir)}."""
    rng = np.random.default_rng(0)
    succ = rng.permutation(V)
    logit_mask = np.ones((V, V), dtype=bool)
    logit_mask[np.arange(V), succ] = False
    prompts = [rng.integers(1, V, size=int(rng.integers(3, P + 1))).tolist() for _ in range(16)]

    def reward_fn(samples):
        return [float(np.sum(s) % 7) - 3.0 for s in samples]

    if "params" not in _JAX_INIT:
        init = JaxPPOTrainer(JaxTRLConfig.from_dict(_bigram_config(tmp_path / "init")))
        _JAX_INIT["params"] = jax.device_get(init.state.params)
        _JAX_INIT["extras"] = jax.device_get(init.state.extras)
        del init
    out = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        cfg = _bigram_config(d, **train)
        if name == "jax":
            model = trlx_tpu.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                                   config=JaxTRLConfig.from_dict(cfg), logit_mask=logit_mask)
        else:
            cfg["model"]["model_type"] = "PPONumericsFromJaxInit"
            model = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=prompts, eval_prompts=prompts[:5],
                                         config=TRLConfig.from_dict(cfg), logit_mask=logit_mask, device="cpu")
        out[name] = (model, _records(os.path.join(d, "metrics.jsonl")), d)
    return out


def test_disarmed_nan_grad_still_gets_census_and_zero_num_residue(tmp_path, monkeypatch):
    """C6: graftnum off, the guard on, incidents armed by the anomaly knob: a
    nan_grad trip writes a census-only numerics.json (no bisect) naming the
    same leaves, with the same counts, as the JAX package's census on the
    same weights and batch, and metrics.jsonl carries no num/* key."""
    monkeypatch.setenv("TRLX_TPU_FAULTS", "nan_grad@2")
    monkeypatch.delenv("TRLX_TPU_GRAFTNUM", raising=False)
    runs = _run_both(tmp_path, anomaly_factor=1000.0)
    (jm, _, jdir), (tm, trecs, tdir) = runs["jax"], runs["torch"]
    assert tm._graftnum is None and not obs_numerics.enabled()
    assert tm.skipped_steps == jm.skipped_steps == 1
    (got,), (ref,) = _numerics_payloads(tdir), _numerics_payloads(jdir)
    assert "forward_bisect" not in got and "forward_bisect" not in ref
    assert got["grad_census"]["total_nonfinite_leaves"] > 0
    assert got["grad_census"] == ref["grad_census"]
    assert not any(k.startswith("num/") for r in trecs for k in r)


def test_armed_num_stats_equal_jax_per_subtree(tmp_path):
    """graftnum armed on shared weights: every num/* value of the logged
    steps, per subtree (frozen ones too: gradient and ratio 0), within the
    PPO step tolerance of the JAX package's."""
    runs = _run_both(tmp_path, graftnum=True)
    (_, jrecs, _), (_, trecs, _) = runs["jax"], runs["torch"]
    jsteps = {r["step"]: r for r in jrecs if "num/grad_global_norm" in r}
    tsteps = {r["step"]: r for r in trecs if "num/grad_global_norm" in r}
    assert sorted(tsteps) == sorted(jsteps) and len(tsteps) >= 2
    for step in sorted(jsteps):
        ref = {k: v for k, v in jsteps[step].items() if k.startswith("num/")}
        got = {k: v for k, v in tsteps[step].items() if k.startswith("num/")}
        assert set(got) == set(ref), step
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=RUN_RTOL, atol=1e-7, err_msg=f"{step} {k}")
    frozen = [k for k in ref if k.startswith("num/grad_norm/transformer/h_0")]
    assert frozen and all(got[k] == 0.0 for k in frozen)


@pytest.mark.parametrize("at", [1, 2])
def test_nan_layer_census_and_bisect_equal_jax(tmp_path, monkeypatch, at):
    """nan_layer@N with graftnum armed on shared weights: both packages skip
    step N, their censuses name the same leaves with the same counts, and
    both bisects name block_N (clamped to the depth) first."""
    monkeypatch.setenv("TRLX_TPU_FAULTS", f"nan_layer@{at}")
    runs = _run_both(tmp_path, graftnum=True)
    (jm, _, jdir), (tm, _, tdir) = runs["jax"], runs["torch"]
    assert tm.skipped_steps == jm.skipped_steps == 1
    (got,), (ref,) = _numerics_payloads(tdir), _numerics_payloads(jdir)
    assert got["grad_census"] == ref["grad_census"]
    assert got["forward_bisect"]["first_nonfinite"] == ref["forward_bisect"]["first_nonfinite"] == f"block_{at}"
    assert [t["tap"] for t in got["forward_bisect"]["taps"]] == [t["tap"] for t in ref["forward_bisect"]["taps"]]


@pytest.mark.parametrize("armed", [False, True], ids=["disarmed-nan_grad", "armed-nan_layer"])
def test_ilql_guard_skip_gets_census_and_bisect(tmp_path, monkeypatch, armed):
    """The census (and, armed, the bisect) for ILQL too: ``train(dataset=...)``
    with a poisoned step writes numerics.json naming the non-finite trainable
    leaves by their JAX-form paths, the Q heads' among them; armed under
    nan_layer@2 on a 3-layer model, the bisect names block_2 first."""
    monkeypatch.setenv("TRLX_TPU_FAULTS", "nan_layer@2" if armed else "nan_grad@2")
    arch = dict(vocab_size=31, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
                extra={"lm_head_bias": True}, eos_token_id=0)
    cfg = {
        "model": dict(model_path="", tokenizer_path="", model_type="ilql", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32"),
        "train": dict(total_steps=3, seq_length=12, epochs=2, batch_size=8, lr_ramp_steps=2, lr_decay_steps=12,
                      weight_decay=1e-4, learning_rate_init=3e-3, learning_rate_target=3e-4, checkpoint_interval=10**6, eval_interval=100, checkpoint_dir=str(tmp_path), seed=11,
                      orchestrator="OfflineOrchestrator", graftnum=armed, anomaly_factor=0.0 if armed else 1000.0),
        "method": dict(name="ilqlconfig", tau=0.7, gamma=0.99, cql_scale=0.1, awac_scale=1.0, alpha=0.1,
                       steps_for_target_q_sync=1, betas=[2.0], two_qs=True,
                       gen_kwargs=dict(prompt_length=5, max_new_tokens=6, top_k=8, do_sample=False)),
    }
    rng = np.random.default_rng(0)
    samples = [rng.integers(1, 31, size=int(rng.integers(3, 15))).astype(np.int32) for _ in range(16)]
    rewards = rng.normal(size=(16,)).astype(np.float32).tolist()
    model = trlx_tpu_torch.train(dataset=(samples, rewards), eval_prompts=[[1, 2]], config=TRLConfig.from_dict(cfg),
                                 device="cpu")
    assert model.skipped_steps == 1
    (payload,) = _numerics_payloads(tmp_path)
    trainable = sorted(n.replace(".", "/") for n, p in model.model.named_parameters() if p.requires_grad)
    census = payload["grad_census"]
    named = [e["path"] for e in census["nonfinite_leaves"]]
    # The poisoned rewards reach the Q heads' TD loss (their leaves are all
    # named); parameters only the other terms reach may keep finite gradients.
    assert 0 < census["total_nonfinite_leaves"] <= len(trainable) and named == sorted(named)
    assert set(named) <= set(trainable) and {"q1_head/layers_1/kernel", "q2_head/layers_1/kernel"} <= set(named)
    if armed:
        assert payload["forward_bisect"]["first_nonfinite"] == payload["forward_bisect"]["injected"] == "block_2"
    else:
        assert "forward_bisect" not in payload
