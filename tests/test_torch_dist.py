"""Data, fully sharded and tensor parallelism (the mesh's dp, fsdp and tp
axes) against the JAX package: twins of ``tests/test_mesh.py`` and the
slice's own cases.

The port runs one process a rank (gloo on the CPU: ``tests/torch_sp_worker.py
dist`` with the cases of ``tests/torch_dist_case.py``); the JAX package runs
in this process over the conftest's 8 CPU devices (16 in a subprocess). The
same seeded numpy inputs and the JAX package's initial weights go through
both. Tolerances:

- the sharded train step's loss within 1e-5 relative and every gradient
  within rtol 2e-4 / atol 2e-5 of the JAX package's ``(2, 2, 2, 1)`` step
  (its own test's tolerances): the sums over ranks run in another order;
- greedy tokens in float32 identical;
- ``train()`` on a mesh against the one-process port and the JAX package:
  step 1's statistics within 1e-5, step 2's within 2e-4
  (``tests/test_torch_train.py``'s tolerances), the parameters within 2e-4;
- a checkpoint reloaded on another mesh: bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_case  # noqa: F401  (registers the trainers the cases use)
import torch_sp_train_case as case
import torch_sp_worker
import trlx_tpu
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.models import LMConfig as JaxLMConfig
from trlx_tpu.models import LMWithValueHead as JaxLMWithValueHead
from trlx_tpu.parallel import batch_sharding, lm_partition_rules, make_mesh, match_partition_rules, shard_pytree
from trlx_tpu.parallel.sharding import sanitize_specs
from trlx_tpu.trainer.ilql import ILQLTrainer as JaxILQLTrainer
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.models.heads import LMWithILQLHeads, LMWithValueHead
from trlx_tpu_torch.models.lm import LMConfig, placement_of
from trlx_tpu_torch.parallel import sharding
from trlx_tpu_torch.parallel.collectives import AxisGroup
from trlx_tpu_torch.parallel.mesh import Mesh, LocalSpGroup, peek_mesh, set_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240.0
V = 32  # divides tp: the vocabulary splits

LAYOUTS = {
    "gpt2": dict(vocab_size=V, n_layer=2, n_head=4, d_model=32, max_position=64, pos_type="learned",
                 parallel_residual=False, fused_qkv=True, qkv_bias=True, tie_word_embeddings=True),
    "gptj": dict(vocab_size=V, n_layer=2, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
                 parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                 tie_word_embeddings=False, extra={"lm_head_bias": True}),
    "neo": dict(vocab_size=V, n_layer=2, n_head=4, d_model=32, max_position=64, pos_type="learned",
                parallel_residual=False, fused_qkv=False, qkv_bias=False, out_bias=True, scale_attn=False,
                attention_layers=("global", "local"), window_size=5, tie_word_embeddings=True),
    "neox": dict(vocab_size=V, n_layer=2, n_head=4, d_model=32, d_ff=48, max_position=64, pos_type="rotary",
                 rotary_dim=4, parallel_residual=True, use_parallel_ln=True, fused_qkv=True, qkv_bias=True,
                 tie_word_embeddings=False, activation="gelu", extra={"neox_rotary": True}),
}


def _arch(layout, **over):
    return dict(LAYOUTS[layout], dtype="float32", param_dtype="float32", **over)


def _jax_params(arch, seed=0, ilql=False, n_soft=0):
    cfg = JaxLMConfig.from_dict(dict(arch, n_soft_tokens=n_soft))
    if ilql:
        from trlx_tpu.models import LMWithILQLHeads as JaxILQL

        model = JaxILQL(cfg)
    else:
        model = JaxLMWithValueHead(cfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    return model, jax.device_get(model.init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))["params"])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


class _Sizes:
    def __init__(self, fsdp, tp):
        self.shape = {"dp": 1, "fsdp": fsdp, "tp": tp, "sp": 1}


def _jax_dims(spec, ndim):
    """(fsdp dim, tp dim) of a PartitionSpec."""
    axes = list(spec) + [None] * (ndim - len(spec))
    return (axes.index("fsdp") if "fsdp" in axes else None, axes.index("tp") if "tp" in axes else None)


# ------------------------------------------------------------------ rules


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_partition_rules_megatron_layout(layout):
    """Every parameter of the layout, the value head, the ILQL heads and the
    soft prompt gets the JAX package's split dims, sanitized alike, in the
    sharded model's placements (fsdp 2 × tp 2)."""
    for ilql, n_soft in ((False, 0), (True, 0), (False, 3)):
        arch = _arch(layout)
        _, params = _jax_params(arch, ilql=ilql, n_soft=n_soft)
        raw = match_partition_rules(lm_partition_rules(), params)
        specs = _flat(sanitize_specs(_Sizes(2, 2), params, raw))
        raw = _flat(raw)
        leaves = _flat(params)
        cfg = LMConfig(**dict(arch, n_soft_tokens=n_soft)).with_mesh(tp=2, fsdp=2)
        model = LMWithILQLHeads(cfg, device="cpu") if ilql else LMWithValueHead(cfg, branch_layer=-1, device="cpu")
        placed = {n: placement_of(model, n) for n, _ in model.named_parameters()}
        assert sorted(placed) == sorted(leaves), layout
        for name, spec in specs.items():
            pl = placed[name]
            assert (pl.fsdp_dim, pl.tp_dim) == _jax_dims(spec, np.ndim(leaves[name])), (layout, name, spec)
            assert pl.full_shape == tuple(np.shape(leaves[name])), name
            assert sharding.match_rule(name) == tuple(raw[name]), name


def test_rules_are_the_jax_list():
    """The copied rules are the JAX package's, pattern for pattern, spec
    for spec."""
    port = sharding.lm_partition_rules()
    ref = lm_partition_rules()
    assert [p for p, _ in port] == [p for p, _ in ref]
    assert [tuple(s) for _, s in port] == [tuple(s) for _, s in ref]


@pytest.mark.parametrize("layout", ["gpt2", "neox"])
def test_cqkv_is_split_per_head_of_q_k_and_v(layout, tmp_path):
    """The fused c_qkv: tp rank r's piece holds ITS heads' columns of each of
    q, k and v (not a contiguous third), and the tp = 2 model's logits and
    values equal the JAX package's on the whole batch."""
    arch = _arch(layout)
    jmodel, params = _jax_params(arch)
    whole = _flat(params)
    name = "transformer.h_0.attn.c_qkv.kernel"
    pl = sharding.placement(name, whole[name].shape, {"fsdp": 1, "tp": 2}, qkv=True)
    d, hd = arch["d_model"], arch["d_model"] // arch["n_head"]
    full = torch.as_tensor(np.asarray(whole[name]))
    for r in range(2):
        piece = pl.shard(full, 0, r)
        heads = range(r * 2, r * 2 + 2)
        want = torch.cat([full[:, part * d + h * hd:part * d + (h + 1) * hd] for part in range(3) for h in heads], 1)
        assert torch.equal(piece, want)
    assert torch.equal(pl.assemble({(0, 0): pl.shard(full, 0, 0), (0, 1): pl.shard(full, 0, 1)}), full)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, V, size=(4, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, :2] = 0
    ref = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    got = torch_sp_worker.spawn("dist", 2, dict(case="forward", shape=(1, 1, 2, 1), arch=arch, params=whole, ids=ids,
                                                mask=mask), str(tmp_path), TIMEOUT)
    for r in got:
        np.testing.assert_allclose(r["logits"], np.asarray(ref["logits"]), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["values"], np.asarray(ref["values"]), rtol=2e-5, atol=2e-5)


def test_optimizer_state_shards_like_params():
    """ZeRO: the Adam moments are pieces of the parameters' placements; the
    JAX package's moments of c_qkv are P(fsdp, tp) at (1, 2, 4, 1), the
    port's the same dims."""
    from trlx_tpu_torch.trainer.base import build_optimizer
    from trlx_tpu_torch.data.configs import TRLConfig

    import optax

    arch = dict(vocab_size=V, n_layer=1, n_head=4, d_model=32, dtype="float32")
    jmodel, params = _jax_params(arch)
    opt_state = optax.adamw(1e-4).init(params)
    sharded, _ = shard_pytree(opt_state, make_mesh((1, 2, 4, 1)))
    jspec = sharded[0].mu["transformer"]["h_0"]["attn"]["c_qkv"]["kernel"].sharding.spec
    assert jspec == P("fsdp", "tp")
    model = LMWithValueHead(LMConfig(**arch).with_mesh(tp=4, fsdp=2), device="cpu")
    named = list(model.named_parameters())
    cfg = TRLConfig.from_dict(case.ppo_config("unused", (1, 2, 4, 1)))
    opt, _ = build_optimizer(cfg.train, [p for _, p in named], [n for n, _ in named])
    for (name, p), mu, nu in zip(named, opt.mu, opt.nu):
        assert mu.shape == nu.shape == p.shape == placement_of(model, name).local_shape, name
    pl = placement_of(model, "transformer.h_0.attn.c_qkv.kernel")
    assert (pl.fsdp_dim, pl.tp_dim) == _jax_dims(jspec, 2) == (0, 1)
    assert pl.local_shape == (16, 24)


# ------------------------------------------------------------- the mesh rules


def test_decode_capture_rule_reads_the_tp_backend(monkeypatch):
    """Decode steps are captured as CUDA graphs only where every collective
    in them can be: tp of size 1 or over NCCL; over gloo the steps run
    eagerly. The CPU never captures."""
    from trlx_tpu_torch.ops import generate

    class _PG:
        pass

    def mesh_with(backend, size):
        g = AxisGroup(None, range(size), 0, "tp")
        g.backend = backend if size > 1 else "none"
        return Mesh((1, 1, size, 1), LocalSpGroup(1), groups={"tp": g} if size > 1 else {})

    prior = peek_mesh()
    cuda = torch.device("cuda")
    try:
        for backend, size, want in (("gloo", 2, False), ("nccl", 2, True), ("gloo", 1, True)):
            set_mesh(mesh_with(backend, size))
            assert generate.graphs_allowed(cuda) is want, (backend, size)
            assert generate.graphs_allowed(torch.device("cpu")) is False
        set_mesh(None)
        assert generate.graphs_allowed(cuda) is True
    finally:
        set_mesh(prior)


def test_staging_is_chosen_by_backend_name():
    """A CUDA tensor on a gloo group is staged through host memory; on NCCL,
    or a CPU tensor, it stays where it lies."""
    from trlx_tpu_torch.parallel import collectives as coll

    class _T:
        def __init__(self, cuda):
            self.is_cuda = cuda

    for backend, cuda, want in (("gloo", True, True), ("gloo", False, False), ("nccl", True, False)):
        g = AxisGroup(None, (0, 1), 0, "x")
        g.backend = backend
        assert coll._staged(g, _T(cuda)) is want


def test_mesh_groups_follow_the_jax_device_order():
    """Each axis group's ranks are the JAX mesh's device ids along that axis
    (sp fastest), for the shapes the configs use."""
    from trlx_tpu_torch.parallel.mesh import MESH_AXES, axis_lines

    for shape in ((2, 2, 2, 1), (1, 2, 4, 1), (1, 4, 2, 1), (1, 2, 2, 2), (8, 1, 1, 1)):
        ids = np.arange(8).reshape(shape)
        lines = axis_lines(shape)
        for i, axis in enumerate(MESH_AXES):
            if shape[i] == 1:
                assert axis not in lines
                continue
            want = sorted(np.moveaxis(ids, i, -1).reshape(-1, shape[i]).tolist())
            assert sorted(lines[axis]) == want, (shape, axis)
        data = np.moveaxis(ids, (0, 1), (2, 3)).reshape(-1, shape[0] * shape[1]).tolist()
        if shape[0] * shape[1] > 1:
            assert sorted(lines["data"]) == sorted(data)


# --------------------------------------------------------- against the JAX package


def test_sharded_train_step_matches_single_device(tmp_path):
    """test_mesh.py's twin: a loss + grad step at (2, 2, 2, 1) on 8 ranks
    equals the JAX package's on its (2, 2, 2, 1) mesh."""
    arch = dict(vocab_size=V, n_layer=2, n_head=4, d_model=64, dtype="float32")
    jmodel, params = _jax_params(arch)
    rng = jax.random.PRNGKey(0)
    ids = jax.random.randint(rng, (8, 6), 0, V)
    mask = jnp.ones((8, 6), jnp.int32)

    def loss_fn(p, i, m):
        out = jmodel.apply({"params": p}, i, m)
        return jnp.mean(out["logits"].astype(jnp.float32) ** 2) + jnp.mean(out["values"] ** 2)

    mesh = make_mesh((2, 2, 2, 1))
    sp, _ = shard_pytree(params, mesh)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(sp, jax.device_put(ids, batch_sharding(mesh)),
                                                      jax.device_put(mask, batch_sharding(mesh)))
    ref = _flat(jax.device_get(grads))
    got = torch_sp_worker.spawn("dist", 8, dict(case="grad", shape=(2, 2, 2, 1), arch=arch, params=_flat(params),
                                                ids=np.asarray(ids), mask=np.asarray(mask)), str(tmp_path), TIMEOUT)
    np.testing.assert_allclose(got[0]["loss"], float(loss), rtol=1e-5)
    assert sorted(got[0]["grads"]) == sorted(ref)
    for name, g in ref.items():
        np.testing.assert_allclose(got[0]["grads"][name], np.asarray(g), rtol=2e-4, atol=2e-5, err_msg=name)
    for r in got[1:]:
        for name, g in got[0]["grads"].items():
            np.testing.assert_array_equal(r["grads"][name], g, err_msg=name)


def test_sharded_generation_matches_single_device(tmp_path):
    """test_mesh.py's twin: greedy decode at (1, 2, 4, 1) (one head a tp
    rank, the rows over fsdp) emits the JAX package's single-device tokens,
    in float32."""
    from trlx_tpu.ops.generate import make_generate_fn
    from trlx_tpu.ops.sampling import GenerateConfig

    arch = dict(vocab_size=V, n_layer=2, n_head=4, d_model=64, max_position=64, dtype="float32")
    jmodel, params = _jax_params(arch)
    ids = jax.random.randint(jax.random.PRNGKey(0), (8, 6), 2, V)
    mask = jnp.ones((8, 6), jnp.int32)
    gen = make_generate_fn(jmodel, GenerateConfig(max_new_tokens=5, do_sample=False, eos_token_id=None, pad_token_id=0))
    ref, _ = gen({"params": params}, ids, mask, jax.random.PRNGKey(1))
    got = torch_sp_worker.spawn("dist", 8, dict(case="generate", shape=(1, 2, 4, 1), arch=arch, params=_flat(params),
                                                ids=np.asarray(ids), mask=np.asarray(mask), new=5),
                                str(tmp_path), TIMEOUT)
    for r in got:
        np.testing.assert_array_equal(r["tokens"], np.asarray(ref))


def test_uneven_valid_tokens_reduce_over_the_whole_batch(tmp_path):
    """Whitening, the loss means and every statistic are global: rank 0's
    rows hold 3 valid tokens, rank 1's 11. The 2-rank loss, statistics and
    the gradients of the logprobs and values equal one process's over the
    whole batch (a per-rank mean would weigh rank 0's tokens 11/3 times)."""
    from trlx_tpu_torch.ops.rl_losses import ppo_loss

    rng = np.random.default_rng(0)
    B, R = 4, 6
    mask = np.zeros((B, R), np.float32)
    mask[0, :2], mask[1, :1] = 1, 1
    mask[2, :6], mask[3, :5] = 1, 1
    batch = {k: rng.normal(size=(B, R)).astype(np.float32) for k in
             ("logprobs", "vpred", "old_logprobs", "old_values", "rewards")}
    batch["mask"] = mask
    kw = dict(gamma=0.99, lam=0.95, cliprange=0.2, cliprange_value=0.2, vf_coef=0.5)
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    lp, vp = t["logprobs"].clone().requires_grad_(), t["vpred"].clone().requires_grad_()
    loss, stats = ppo_loss(lp, vp, t["old_logprobs"], t["old_values"], t["rewards"], t["mask"], **kw)
    loss.backward()
    got = torch_sp_worker.spawn("dist", 2, dict(case="uneven", shape=(2, 1, 1, 1), batch=batch, kw=kw),
                                str(tmp_path), TIMEOUT)
    for r in got:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6, atol=1e-7)
        for k, v in stats.items():
            np.testing.assert_allclose(r["stats"][k], float(v), rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r["grad_lp"], lp.grad.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["grad_vp"], vp.grad.numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------- train() on a mesh


def _tol(step):
    return 1e-5 if step == 1 else 2e-4


def _close_stats(got, ref, keys, steps):
    assert sorted(got) == sorted(ref) == list(range(1, steps + 1))
    for step in range(1, steps + 1):
        for k in keys:
            np.testing.assert_allclose(got[step][k], ref[step][k], rtol=_tol(step), atol=_tol(step),
                                       err_msg=f"step {step} {k}")


ARCH = dict(vocab_size=V, n_layer=3, n_head=4, d_model=32, max_position=64, pos_type="rotary", rotary_dim=4,
            parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
            extra={"lm_head_bias": True})


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """PPO (and ILQL) on [1, 2, 2, 1] (4 gloo ranks), on one process of the
    port, and through the JAX package on (2, 2, 2, 1); the mesh run saves a
    sharded checkpoint at its end."""
    root = tmp_path_factory.mktemp("dist_train")
    t = case.task(vocab=V)
    jcfg = case.ppo_config(str(root / "jax"), (2, 2, 2, 1), arch=ARCH)
    init = JaxPPOTrainer(JaxTRLConfig.from_dict(jcfg))
    whole = dict(params=jax.device_get(init.state.params), extras=jax.device_get(init.state.extras))
    del init
    jm = trlx_tpu.train(reward_fn=case.reward_fn, prompts=t["prompts"], eval_prompts=t["eval_prompts"],
                        config=JaxTRLConfig.from_dict(jcfg), logit_mask=t["logit_mask"])
    out = {"jax": case.step_stats(str(root / "jax" / "metrics.jsonl"), case.PPO_STAT_KEYS),
           "jax_iter": jm.iter_count, "root": root}
    pcfg = case.ppo_config("unused", (1, 1, 1, 1), arch=ARCH)
    pcfg["train"]["desync_check_interval"] = 1  # the consistency guard witnesses bit-equal replicas
    data = dict(case="ppo", task=t, config=pcfg, dir=str(root), **whole)
    prior = peek_mesh()
    try:
        out["single"] = torch_dist_case.case_ppo(dict(data, shape=(1, 1, 1, 1), name="single"))
    finally:
        set_mesh(prior)
    out["mesh"] = torch_sp_worker.spawn("dist", 4, dict(data, shape=(1, 2, 2, 1), save=True), str(root / "w"),
                                        TIMEOUT)
    icfg = case.ilql_config("unused", (1, 1, 1, 1), arch=ARCH)
    jinit = JaxILQLTrainer(JaxTRLConfig.from_dict(case.ilql_config(str(root / "jilql"), (8, 1, 1, 1), arch=ARCH)))
    iwhole = dict(params=jax.device_get(jinit.state.params), extras=jax.device_get(jinit.state.extras))
    del jinit
    idata = dict(case="ilql", task=t, config=icfg, dir=str(root), **iwhole)
    try:
        out["ilql_single"] = torch_dist_case.case_ilql(dict(idata, shape=(1, 1, 1, 1), name="ilql_single"))
    finally:
        set_mesh(prior)
    out["ilql_mesh"] = torch_sp_worker.spawn("dist", 4, dict(idata, shape=(1, 2, 2, 1)), str(root / "wi"), TIMEOUT)
    # The fused route (the Q heads through the fused head, its plain
    # versions on the CPU): under tp the hidden and layers_1 are gathered.
    fcfg = case.ilql_config("unused", (1, 1, 1, 1), arch=dict(ARCH, extra={"lm_head_bias": True,
                                                                         "fused_logprob": "force"}))
    fdata = dict(idata, config=fcfg)
    try:
        out["ilql_fused_single"] = torch_dist_case.case_ilql(dict(fdata, shape=(1, 1, 1, 1), name="ilql_fused1"))
    finally:
        set_mesh(prior)
    out["ilql_fused_mesh"] = torch_sp_worker.spawn("dist", 4, dict(fdata, shape=(1, 2, 2, 1), name="ilql_fused4"),
                                                   str(root / "wf"), TIMEOUT)
    return out


def test_ppo_on_fsdp_tp_mesh_matches_single_device_and_jax(mesh_runs):
    r0 = mesh_runs["mesh"][0]
    assert r0["mesh"] == {"dp": 1, "fsdp": 2, "tp": 2, "sp": 1}
    assert r0["iter_count"] == mesh_runs["single"]["iter_count"] == mesh_runs["jax_iter"] == case.STEPS
    _close_stats(r0["stats"], mesh_runs["single"]["stats"], case.PPO_STAT_KEYS, case.STEPS)
    _close_stats(r0["stats"], mesh_runs["jax"], case.PPO_STAT_KEYS, case.STEPS)
    for name, p in r0["params"].items():
        np.testing.assert_allclose(p, mesh_runs["single"]["params"][name], rtol=2e-4, atol=2e-4, err_msg=name)
        for r in mesh_runs["mesh"][1:]:
            np.testing.assert_array_equal(r["params"][name], p, err_msg=name)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 1, 1, 1)])
def test_sharded_checkpoint_loads_on_another_mesh(mesh_runs, shape, tmp_path):
    """The [1, 2, 2, 1] save (pieces per (fsdp, tp) coordinate beside
    layout.json, one manifest, latest.txt last) loads on one process and
    on a dp = 2 mesh, bit-equal to the whole parameters and moments."""
    root = mesh_runs["root"]
    saved = str(root / "saved")
    files = sorted(os.listdir(os.path.join(saved, "state_2")))
    assert "layout.json" in files and "params.f1t1.pt" in files and "train_state.pt" in files
    with open(os.path.join(saved, "latest.txt")) as f:
        assert f.read().strip() == "state_2"
    data = dict(case="load", config=case.ppo_config("unused", shape, arch=ARCH), shape=shape,
                dir=str(tmp_path), **{"from": saved})
    if shape == (1, 1, 1, 1):
        prior = peek_mesh()
        try:
            got = [torch_dist_case.case_load(data)]
        finally:
            set_mesh(prior)
    else:
        got = torch_sp_worker.spawn("dist", 2, data, str(tmp_path / "w"), TIMEOUT)
    want = mesh_runs["mesh"][0]
    for r in got:
        assert r["step"] == 2
        for name, p in want["params"].items():
            np.testing.assert_array_equal(r["params"][name], p, err_msg=name)
        for name, m in want["moments"].items():
            np.testing.assert_array_equal(r["moments"][name], m, err_msg=name)


@pytest.mark.parametrize("route", ["dense", "fused"])
def test_ilql_on_fsdp_tp_mesh(mesh_runs, route):
    """ILQL on [1, 2, 2, 1]: 3 steps, the ranks' whole parameters equal,
    statistics as the one-process run's, on the dense route and on the
    fused one (``fused_logprob: force``)."""
    key = "ilql" if route == "dense" else "ilql_fused"
    r0, single = mesh_runs[f"{key}_mesh"][0], mesh_runs[f"{key}_single"]
    assert r0["iter_count"] == single["iter_count"] == 3
    _close_stats(r0["stats"], single["stats"], case.ILQL_STAT_KEYS, 3)
    for name, p in r0["params"].items():
        np.testing.assert_allclose(p, single["params"][name], rtol=2e-4, atol=2e-4, err_msg=name)
        for r in mesh_runs[f"{key}_mesh"][1:]:
            np.testing.assert_array_equal(r["params"][name], p, err_msg=name)


# ------------------------------------------------------- the configs as written


def _yaml_case(name, tmp_path, world, n_layer=2):
    """A shipped recipe as written, read from the port's own copy (mesh,
    method, batch and sequence sizes), at tiny width: no checkpoint or tokenizer to fetch, token
    prompts, 2 steps."""
    import yaml

    with open(os.path.join(ROOT, "trlx_tpu_torch", "configs", name)) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(model_path="", tokenizer_path="",
                        model_arch=dict(ARCH, n_layer=n_layer, max_position=cfg["train"]["seq_length"]))
    cfg["train"].update(total_steps=2, checkpoint_interval=10**6, eval_interval=10**6)
    t = case.task(vocab=V)
    t["logit_mask"] = None
    return dict(case="ppo", task=t, config=cfg, shape=tuple(cfg["train"]["mesh"]), dir=str(tmp_path))


def test_ppo_gptj_config_runs_as_written(tmp_path):
    """ppo_gptj_config.yml's [-1, 4, 2, 1] on 8 ranks (fsdp 4 × tp 2): two
    steps with finite statistics, every rank's whole parameters equal."""
    data = _yaml_case("ppo_gptj_config.yml", tmp_path, 8)
    assert data["shape"] == (-1, 4, 2, 1)
    got = torch_sp_worker.spawn("dist", 8, data, str(tmp_path / "w"), TIMEOUT)
    assert got[0]["mesh"] == {"dp": 1, "fsdp": 4, "tp": 2, "sp": 1} and got[0]["iter_count"] == 2
    assert all(np.isfinite(v) for s in got[0]["stats"].values() for v in s.values())
    for r in got[1:]:
        for name, p in got[0]["params"].items():
            np.testing.assert_array_equal(r["params"][name], p, err_msg=name)


def test_ppo_long_config_runs_as_written(tmp_path):
    """ppo_long_config.yml's [1, 2, 2, -1] as [1, 2, 2, 2] on 8 ranks: the
    4096-token sequences (3072 prompt + 1024 new, the int8 KV cache) and
    the sp ring beside fsdp and tp, two steps."""
    data = _yaml_case("ppo_long_config.yml", tmp_path, 8, n_layer=1)
    assert data["shape"] == (1, 2, 2, -1)
    got = torch_sp_worker.spawn("dist", 8, data, str(tmp_path / "w"), 600.0)
    assert got[0]["mesh"] == {"dp": 1, "fsdp": 2, "tp": 2, "sp": 2} and got[0]["iter_count"] == 2
    assert all(np.isfinite(v) for s in got[0]["stats"].values() for v in s.values())
    for r in got[1:]:
        for name, p in got[0]["params"].items():
            np.testing.assert_array_equal(r["params"][name], p, err_msg=name)


def test_dryrun_all_four_axes_16_devices(tmp_path):
    """test_mesh.py's twin: all four axes above 1 at once ((2, 2, 2, 2) on
    16 ranks), PPO two steps with every rank's whole parameters equal."""
    data = dict(case="ppo", task=case.task(vocab=V), config=case.ppo_config("unused", (1, 1, 1, 1), arch=ARCH),
                shape=(2, 2, 2, 2), dir=str(tmp_path))
    got = torch_sp_worker.spawn("dist", 16, data, str(tmp_path / "w"), TIMEOUT)
    assert got[0]["mesh"] == {"dp": 2, "fsdp": 2, "tp": 2, "sp": 2} and got[0]["iter_count"] == case.STEPS
    for r in got[1:]:
        for name, p in got[0]["params"].items():
            np.testing.assert_array_equal(r["params"][name], p, err_msg=name)
