"""Twins of ``tests/test_ring_attention.py``: the port's ring attention
(``trlx_tpu_torch.parallel.ring_attention``) against the JAX package's
``ring_attention_sharded`` on a JAX mesh whose sp axis matches ((1, 1, 1, n)
over n of the conftest's CPU devices), on the same numpy inputs.

Each twin runs on four sp groups: ``LocalSpGroup`` of 2 and of 4 (every
rank in this process) and a real gloo group of 2 and of 4 processes
(``tests/torch_sp_worker.py``; one spawn of each size runs every case and
joins within its timeout). Every rank of a gloo group must return the same
full output and gradients (the entry's transpose all-gathers them).

Tolerances: the ops within 1e-5 (float32 on both sides, the JAX tests'
tolerance). The model: the ring against the port's local model, logits
within 2e-4 and gradients within 5e-4 (``tests/test_ring_attention.py:78,87``);
against the JAX ring model the same, plus 1e-5 relative on the gradients,
which reach |g| ~ 1e3 (a float32 sum over 4 x 64 rows taken in another
order by another framework differs there by ~1e-6 relative).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_sp_worker
from trlx_tpu.models import LMConfig as JaxLMConfig, TransformerLM as JaxTransformerLM
from trlx_tpu.parallel import mesh as jax_mesh
from trlx_tpu.parallel.ring_attention import causal_live_half_pairs as jax_live_half_pairs
from trlx_tpu.parallel.ring_attention import ring_attention_sharded as jax_ring
from trlx_tpu_torch.models.hf_import import params_from_jax
from trlx_tpu_torch.parallel import mesh as port_mesh
from trlx_tpu_torch.parallel.ring_attention import causal_live_half_pairs

torch.set_num_threads(1)

OP_TOL = dict(rtol=0, atol=1e-5)
VARIANTS = ["local2", "local4", "gloo2", "gloo4"]
SPAWN_TIMEOUT = 240.0
MODEL_BASE = dict(vocab_size=61, n_layer=2, n_head=4, d_model=32, max_position=128, pos_type="rotary", rotary_dim=8,
                  dtype="float32", attn_impl="xla")


def _qkv(seed, b, T, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, T, h, d)).astype(np.float32) for _ in range(3)]


def _op_data(seed, b, T, h, d, pad_row, pad):
    q, k, v = _qkv(seed, b, T, h, d)
    mask = np.ones((b, T), np.float32)
    mask[pad_row, :pad] = 0
    return dict(q=q, k=k, v=v, mask=mask, qvalid=mask[:, :, None, None].copy(), scale=d ** -0.5)


def _data():
    """The JAX tests' inputs (their seeds and shapes), and the model's
    parameters from the JAX module's init."""
    window = _op_data(8, 2, 64, 2, 8, 0, 0)
    window["window"] = 24
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 61, (4, 64)).astype(np.int32)
    mask = np.ones((4, 64), np.int32)
    mask[0, :7] = 0
    params = JaxTransformerLM(JaxLMConfig(**MODEL_BASE)).init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                                              jnp.asarray(mask))["params"]
    params = {n: t.numpy() for n, t in params_from_jax(jax.device_get(params)).items()}
    return dict(op=_op_data(0, 4, 64, 4, 16, 0, 9), flash=_op_data(3, 4, 64, 4, 16, 0, 9),
                layouts=_op_data(7, 2, 64, 4, 16, 1, 7), window=window,
                model=dict(base=MODEL_BASE, ids=ids, mask=mask, params=params, jax_params=params))


def _jax_op(n, d, **kw):
    mesh = jax_mesh.make_mesh((1, 1, 1, n), devices=jax.devices()[:n])
    q, k, v = (jnp.asarray(d[x]) for x in ("q", "k", "v"))
    mask, qvalid = jnp.asarray(d["mask"]), jnp.asarray(d["qvalid"])
    f = jax.jit(lambda q, k, v: jax_ring(q, k, v, mask, scale=float(d["scale"]), mesh=mesh, **kw))
    grads = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(f(q, k, v)) * qvalid), (0, 1, 2))(q, k, v)
    return {"out": np.asarray(f(q, k, v)), "grads": [np.asarray(g) for g in grads]}


def _jax_model(n, m, T):
    mesh = jax_mesh.make_mesh((1, 1, 1, n), devices=jax.devices()[:n])
    prior = jax_mesh.peek_mesh()
    jax_mesh.set_mesh(mesh)
    try:
        model = JaxTransformerLM(JaxLMConfig(**m["base"], sp_size=n))
        ids, mask = jnp.asarray(m["ids"][:, :T]), jnp.asarray(m["mask"][:, :T])
        fmask = mask[:, :, None].astype(jnp.float32)
        params = _unflatten(m["jax_params"])
        logits = jax.jit(lambda p: model.apply({"params": p}, ids, mask)["logits"])(params)
        grads = jax.jit(jax.grad(lambda p: jnp.sum(jnp.tanh(model.apply({"params": p}, ids, mask)["logits"])
                                                   * fmask)))(params)
    finally:
        jax_mesh.set_mesh(prior)
    flat = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else key
            if isinstance(val, dict):
                walk(val, name)
            else:
                flat[name] = np.asarray(val)

    walk(jax.device_get(grads), "")
    return {"logits": np.asarray(logits), "grads": flat}


def _unflatten(flat):
    tree = {}
    for name, val in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return tree


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def jax_results(data):
    out = {}
    for n in (2, 4):
        out[n] = {
            "op": _jax_op(n, data["op"]),
            "flash": _jax_op(n, data["flash"], use_flash=True),
            "zigzag": _jax_op(n, data["layouts"], layout="zigzag"),
            "contiguous": _jax_op(n, data["layouts"], layout="contiguous"),
            "noncausal": _jax_op(n, data["layouts"], layout="contiguous", causal=False),
            "window": _jax_op(n, data["window"], window=24, layout="zigzag"),
            "model": _jax_model(n, data["model"], 64),
            "model_60": _jax_model(n, data["model"], 60),
        }
    return out


@pytest.fixture(scope="module")
def port_results(data, tmp_path_factory):
    """Per variant, the results of every rank (one for a LocalSpGroup)."""
    out = {}
    prior = port_mesh.peek_mesh()
    try:
        for n in (2, 4):
            mesh = port_mesh.make_mesh((1, 1, 1, n), sp_group=port_mesh.LocalSpGroup(n))
            out[f"local{n}"] = [torch_sp_worker.ring_cases(mesh, data)]
    finally:
        port_mesh.set_mesh(prior)
    tmp = str(tmp_path_factory.mktemp("ring"))
    for n in (2, 4):
        out[f"gloo{n}"] = torch_sp_worker.spawn("ring", n, data, tmp, SPAWN_TIMEOUT)
    return out


def _n(variant: str) -> int:
    return int(variant[-1])


def _ranks(port_results, variant, key):
    """Every rank's result for ``key``; a gloo group's ranks must agree bit
    for bit (the same full output and gradients everywhere)."""
    ranks = [r[key] for r in port_results[variant]]
    for other in ranks[1:]:
        _assert_tree_equal(other, ranks[0])
    return ranks[0]


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _close_op(got, ref, qvalid, tol=OP_TOL):
    np.testing.assert_allclose(got["out"] * qvalid, ref["out"] * qvalid, **tol)
    for g, r in zip(got["grads"], ref["grads"]):
        np.testing.assert_allclose(g, r, **tol)


def _reference(d, window=0):
    """Single-device attention (the JAX tests' ``ref``), in numpy float64."""
    q, k, v, mask = (d[x].astype(np.float64) for x in ("q", "k", "v", "mask"))
    T = q.shape[1]
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * float(d["scale"])
    qi, ki = np.arange(T)[:, None], np.arange(T)[None, :]
    m = ki <= qi
    if window:
        m = m & (ki > qi - window)
    m = m[None, None] & (mask[:, None, None, :] > 0)
    s = np.where(m, s, -1e9)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("variant", VARIANTS)
def test_op_matches_full_attention(variant, data, jax_results, port_results):
    d = data["op"]
    got = _ranks(port_results, variant, "op")
    _close_op(got, jax_results[_n(variant)]["op"], d["qvalid"])
    np.testing.assert_allclose(got["out"] * d["qvalid"], _reference(d) * d["qvalid"], **OP_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_sequence_parallel_matches_local(variant, data, jax_results, port_results):
    """The ring model (sp_size = n) against the port's local model (the JAX
    test's own comparison) and against the JAX ring model on the same
    parameters; with remat, the same bits as without (T = 64 zig-zag; T = 60
    zig-zag on 2 ranks, contiguous on 4)."""
    fmask = data["model"]["mask"][:, :, None].astype(np.float32)
    got, local = _ranks(port_results, variant, "model"), _ranks(port_results, variant, "model_local")
    np.testing.assert_allclose(got["logits"] * fmask, local["logits"] * fmask, rtol=0, atol=2e-4)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, local["grads"][name], rtol=0, atol=5e-4, err_msg=name)
    for key, T in (("model", 64), ("model_60", 60)):
        got = _ranks(port_results, variant, key)
        ref = jax_results[_n(variant)][key]
        np.testing.assert_allclose(got["logits"] * fmask[:, :T], ref["logits"] * fmask[:, :T], rtol=0, atol=2e-4)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, ref["grads"][name], rtol=1e-5, atol=5e-4, err_msg=name)
        _assert_tree_equal(_ranks(port_results, variant, key + "_remat"), got)


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_stays_local(variant, port_results):
    """ring_eligible: full-sequence passes take the ring; decode with a
    cache, an unaligned length and sp_size 0 stay local."""
    assert _ranks(port_results, variant, "eligible") == [True, False, False, False]


@pytest.mark.parametrize("variant", VARIANTS)
def test_ring_flash_path_matches_full_attention(variant, data, jax_results, port_results):
    """The flash engine (the kernels' offset mode, here their plain
    versions) with the exact lse combine, against the Pallas ring in
    interpret mode and single-device attention."""
    d = data["flash"]
    got = _ranks(port_results, variant, "flash")
    _close_op(got, jax_results[_n(variant)]["flash"], d["qvalid"])
    np.testing.assert_allclose(got["out"] * d["qvalid"], _reference(d) * d["qvalid"], **OP_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_zigzag_live_work_balanced(variant, port_results):
    """The load-balance model equals the JAX package's, with its properties;
    and on this group the zig-zag body attended exactly the model's live
    half-pairs on every rank (2n + 1)."""
    for n in (2, 4, 8):
        zz = causal_live_half_pairs(n, "zigzag")
        assert zz == jax_live_half_pairs(n, "zigzag")
        assert max(zz) - min(zz) <= 1, zz
        assert sum(zz) == n * (2 * n + 1)
        cont = causal_live_half_pairs(n, "contiguous")
        assert cont == jax_live_half_pairs(n, "contiguous")
        assert max(cont) - min(cont) == (n - 1) * 2 * 2
        assert sum(cont) == 2 * n * (n + 1)
        assert sum(zz) < sum(cont)
    n = _n(variant)
    seen = np.sum([r["live_pairs"] for r in port_results[variant]], axis=0)
    assert list(seen) == causal_live_half_pairs(n, "zigzag") == [2 * n + 1] * n


@pytest.mark.parametrize("variant", VARIANTS)
def test_zigzag_matches_contiguous_layout(variant, data, jax_results, port_results):
    """Forced zig-zag against forced contiguous, and each against the JAX
    package's, on the valid query rows; the contiguous non-causal layout
    against the JAX one."""
    d = data["layouts"]
    z, c = _ranks(port_results, variant, "zigzag"), _ranks(port_results, variant, "contiguous")
    _close_op(z, c, d["qvalid"])
    for key in ("zigzag", "contiguous", "noncausal"):
        _close_op(_ranks(port_results, variant, key), jax_results[_n(variant)][key], d["qvalid"])


@pytest.mark.parametrize("variant", VARIANTS)
def test_zigzag_windowed_matches_full(variant, data, jax_results, port_results):
    """Local (windowed) attention through the zig-zag liveness rule."""
    d = data["window"]
    got = _ranks(port_results, variant, "window")
    np.testing.assert_allclose(got["out"], _reference(d, window=24), **OP_TOL)
    _close_op(got, jax_results[_n(variant)]["window"], d["qvalid"])


def test_refusals():
    """The JAX entry's errors: zig-zag without causality, zig-zag with T
    not divisible by 2n."""
    from trlx_tpu_torch.parallel.ring_attention import ring_attention_sharded

    mesh = port_mesh.make_mesh((1, 1, 1, 2), sp_group=port_mesh.LocalSpGroup(2))
    x = torch.zeros((1, 6, 1, 4))
    with pytest.raises(ValueError, match="causal-balance"):
        ring_attention_sharded(x, x, x, torch.ones((1, 6)), scale=1.0, causal=False, mesh=mesh, layout="zigzag")
    with pytest.raises(ValueError, match="divisible"):
        ring_attention_sharded(x, x, x, torch.ones((1, 6)), scale=1.0, mesh=mesh, layout="zigzag")
