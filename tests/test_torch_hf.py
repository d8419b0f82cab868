"""The port's HF layer against ``transformers``, ``safetensors`` and the JAX
package, on tiny in-process models written to ``tmp_path`` (no download).

- Import (twins of ``tests/test_hf_parity.py``): for gpt2, gptj, gpt_neo and
  gpt_neox the port's trunk equals JAX ``load_hf_trunk``'s bit for bit, and
  its logits equal the HF model's within atol 2e-4 / rtol 1e-3;
  ``read_hf_config`` gives the LMConfig ``AutoConfig`` gives.
- Export (twins of ``tests/test_hf_export.py``): round trips bit-equal per
  family and in the non-canonical variants, files that
  ``transformers.from_pretrained`` loads to the same state dict, the
  refusals, the heads sidecar, and the trainers' ``save_pretrained``.
- Streaming (twins of ``tests/test_hf_stream.py``): a sharded mixed-dtype
  checkpoint, a single file, the export through the loader.
- ``models/safetensors_io.py``: the reader against ``safetensors.safe_open``
  per dtype, single and sharded; the writer's files read by ``safetensors``
  and ``transformers``; a load and an export with ``transformers`` and
  ``safetensors`` blocked.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")
from safetensors import safe_open  # noqa: E402
from safetensors.torch import save_file as st_save_file  # noqa: E402

from trlx_tpu.models.hf_import import lm_config_from_hf as jax_lm_config_from_hf  # noqa: E402
from trlx_tpu.models.hf_import import load_hf_trunk as jax_load_hf_trunk  # noqa: E402
from trlx_tpu.models.lm import LMConfig as JaxLMConfig  # noqa: E402
from trlx_tpu_torch.data.configs import TRLConfig  # noqa: E402
from trlx_tpu_torch.models import safetensors_io as stio  # noqa: E402
from trlx_tpu_torch.models.hf_export import (  # noqa: E402
    build_hf_config,
    export_hf,
    export_state_dict,
    hf_state_keys,
    infer_family,
    validate_exportable,
)
from trlx_tpu_torch.models.hf_import import (  # noqa: E402
    convert_gpt2,
    convert_gpt_neo,
    convert_gptj,
    convert_neox,
    init_params,
    lm_config_from_hf,
    load_hf_trunk,
    params_from_jax,
    read_hf_config,
)
from trlx_tpu_torch.models.lm import LMConfig, TransformerLM  # noqa: E402

torch.set_num_threads(1)

HF_MODELS = {
    "gpt2": lambda: transformers.GPT2LMHeadModel(
        transformers.GPT2Config(n_layer=2, n_head=4, n_embd=64, vocab_size=128, n_positions=64)),
    "gptj": lambda: transformers.GPTJForCausalLM(
        transformers.GPTJConfig(n_layer=2, n_head=4, n_embd=64, vocab_size=128, n_positions=64, rotary_dim=8)),
    "gpt_neox": lambda: transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        num_hidden_layers=2, num_attention_heads=4, hidden_size=64, intermediate_size=256, vocab_size=128,
        max_position_embeddings=64, rotary_pct=0.25)),
    # Alternating global/local layers with a window shorter than the
    # sequence, so the windowed mask changes the logits; unscaled attention.
    "gpt_neo": lambda: transformers.GPTNeoForCausalLM(transformers.GPTNeoConfig(
        num_layers=2, num_heads=4, hidden_size=64, vocab_size=128, max_position_embeddings=64,
        attention_types=[[["global", "local"], 1]], window_size=8)),
}
SEQ = {"gpt2": 12, "gptj": 12, "gpt_neox": 12, "gpt_neo": 24}


def _hf_dir(family, tmp_path):
    torch.manual_seed(0)
    hf = HF_MODELS[family]().eval()
    path = str(tmp_path / f"hf_{family}")
    hf.save_pretrained(path, safe_serialization=True)
    return hf, path


def _port_lm(cfg: LMConfig, trunk) -> TransformerLM:
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(trunk, strict=True)
    return model.eval()


def _lm_dict(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(LMConfig)}


# ------------------------------------------------------------------ import


@pytest.mark.parametrize("family", list(HF_MODELS))
def test_hf_import_parity(family, tmp_path):
    """The trunk from an HF directory equals JAX ``load_hf_trunk``'s bit for
    bit; the port's logits equal the HF model's (atol 2e-4, rtol 1e-3)."""
    hf, path = _hf_dir(family, tmp_path)
    cfg = lm_config_from_hf(read_hf_config(path), dtype="float32", param_dtype="float32")
    trunk = load_hf_trunk(path, cfg)
    convert = {"gpt2": convert_gpt2, "gptj": convert_gptj, "gpt_neo": convert_gpt_neo, "gpt_neox": convert_neox}
    eager = convert[family]({k: v.detach() for k, v in hf.state_dict().items()}, cfg)
    assert set(eager) == set(trunk) and all(torch.equal(eager[k], trunk[k]) for k in trunk)
    jcfg = jax_lm_config_from_hf(hf.config, dtype="float32", param_dtype="float32")
    jtrunk = params_from_jax(jax.device_get(jax_load_hf_trunk(path, jcfg)))
    assert set(trunk) == set(jtrunk)
    for k in trunk:
        assert trunk[k].dtype == jtrunk[k].dtype and torch.equal(trunk[k], jtrunk[k]), k

    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, SEQ[family]))
    with torch.no_grad():
        ref = hf(torch.as_tensor(ids)).logits.numpy()
        got = _port_lm(cfg, trunk)(torch.as_tensor(ids, dtype=torch.int32))["logits"].float().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("family", list(HF_MODELS))
def test_read_hf_config_matches_autoconfig(family, tmp_path):
    """``read_hf_config`` of a saved config.json, and of one stripped to
    ``model_type`` and a few fields (the class defaults fill the rest), maps
    to the LMConfig the JAX package maps ``AutoConfig`` to."""
    _, path = _hf_dir(family, tmp_path)
    got = _lm_dict(lm_config_from_hf(read_hf_config(path)))
    want = jax_lm_config_from_hf(transformers.AutoConfig.from_pretrained(path))
    for k, v in got.items():
        assert v == getattr(want, k), k
    with open(os.path.join(path, "config.json")) as f:
        full = json.load(f)
    keep = {"model_type", "vocab_size", "n_layer", "num_layers", "num_hidden_layers", "attention_types"}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({k: v for k, v in full.items() if k in keep}, f)
    got = _lm_dict(lm_config_from_hf(read_hf_config(path)))
    want = jax_lm_config_from_hf(transformers.AutoConfig.from_pretrained(path))
    for k, v in got.items():
        assert v == getattr(want, k), k


# ------------------------------------------------------------------ export

FAMILIES = {
    "gpt2": dict(pos_type="learned", parallel_residual=False, fused_qkv=True, qkv_bias=True, out_bias=True,
                 tie_word_embeddings=True, activation="gelu_new"),
    "gptj": dict(pos_type="rotary", rotary_dim=8, parallel_residual=True, use_parallel_ln=False, fused_qkv=False,
                 qkv_bias=False, out_bias=False, tie_word_embeddings=False, activation="gelu_new",
                 extra={"lm_head_bias": True}),
    "gpt_neo": dict(pos_type="learned", parallel_residual=False, fused_qkv=False, qkv_bias=False, out_bias=True,
                    scale_attn=False, attention_layers=("global", "local"), window_size=16,
                    tie_word_embeddings=True, activation="gelu_new"),
    "gpt_neox": dict(pos_type="rotary", rotary_dim=8, parallel_residual=True, use_parallel_ln=True, fused_qkv=True,
                     qkv_bias=True, tie_word_embeddings=False, activation="gelu", extra={"neox_rotary": True}),
}


def tiny_cfg(family, **overrides) -> LMConfig:
    return LMConfig(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_position=64, dtype="float32",
                    param_dtype="float32", **{**FAMILIES[family], **overrides})


def _seeded_trunk(cfg, seed=0):
    model = TransformerLM(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-trivial LayerNorms and biases
        g = torch.Generator().manual_seed(seed + 1)
        for name, p in model.named_parameters():
            if name.endswith(".bias") or name.endswith(".scale"):
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return model


def _assert_roundtrip(model, cfg, out, family):
    own = {k: v.detach() for k, v in model.state_dict().items()}
    back = load_hf_trunk(out, cfg)
    assert set(back) == set(own)
    for k in own:
        assert torch.equal(back[k], own[k]), k
    # transformers reads the files as the family's model, to the same state.
    hf = transformers.AutoModelForCausalLM.from_pretrained(out)
    assert type(hf).__name__ == build_hf_config(cfg, family)["architectures"][0]
    want = export_state_dict(own, cfg, family)
    got = hf.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    return hf


@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_roundtrip_trunk(family, tmp_path):
    """Trunk → HF directory → the port's import: bit-equal; the directory
    loads in transformers as the family's model with the exported tensors,
    computes the port's logits, and JAX ``load_hf_trunk`` reads it too."""
    cfg = tiny_cfg(family)
    assert infer_family(cfg) == family
    model = _seeded_trunk(cfg)
    out = export_hf(dict(model.named_parameters()), cfg, str(tmp_path / family))
    hf = _assert_roundtrip(model, cfg, out, family)
    ids = np.arange(16)[None] % 128
    with torch.no_grad():
        ref = hf.eval()(torch.as_tensor(ids)).logits.numpy()
        got = model.eval()(torch.as_tensor(ids, dtype=torch.int32))["logits"].float().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
    jcfg = JaxLMConfig(**{k: v for k, v in _lm_dict(cfg).items() if k in JaxLMConfig.__dataclass_fields__})
    jtrunk = params_from_jax(jax.device_get(jax_load_hf_trunk(out, jcfg)))
    for k, v in model.state_dict().items():
        assert torch.equal(jtrunk[k], v), k


@pytest.mark.parametrize(
    "family,overrides",
    [
        ("gpt2", {"tie_word_embeddings": False}),  # an untied head must export
        ("gptj", {"tie_word_embeddings": True, "extra": {}}),  # tied rotary
        ("gptj", {"extra": {}}),  # untied, no lm_head bias
        ("gpt2", {"d_ff": 48}),  # a non-default inner dim → n_inner
        ("gpt_neox", {"tie_word_embeddings": True, "activation": "gelu_new", "extra": {"neox_rotary": True}}),
    ],
)
def test_export_roundtrip_non_canonical_variants(family, overrides, tmp_path):
    """Architectures off the family's canonical layout (tying, head bias,
    inner dim) round-trip exactly and load in transformers."""
    cfg = tiny_cfg(family, **overrides)
    model = _seeded_trunk(cfg, seed=1)
    out = export_hf(dict(model.named_parameters()), cfg, str(tmp_path / "m"))
    _assert_roundtrip(model, cfg, out, family)


def test_export_rejects_unrepresentable_semantics():
    """Semantics HF cannot express fail loudly, not export wrong logits."""
    cases = [
        (tiny_cfg("gpt_neo").replace(scale_attn=True), "gpt_neo", "UNSCALED"),
        (tiny_cfg("gpt2").replace(scale_attn=False), "gpt2", "scale_attn"),
        (tiny_cfg("gptj").replace(extra={"neox_rotary": True}), "gptj", "interleaved"),
        (tiny_cfg("gpt2").replace(parallel_residual=True), "gpt2", "sequential"),
        (tiny_cfg("gptj").replace(qkv_bias=True), "gptj", "qkv_bias"),
        (tiny_cfg("gptj").replace(out_bias=True), "gptj", "out_bias"),
        (tiny_cfg("gpt2").replace(attention_layers=("global", "local")), "gpt2", "local-attention"),
    ]
    for cfg, family, match in cases:
        with pytest.raises(ValueError, match=match):
            validate_exportable(cfg, family)


def test_soft_prompt_exports_to_sidecar(tmp_path):
    """A trunk that carries a tuned soft prompt (HF has no slot for it)
    exports it in the heads sidecar instead of dropping it."""
    cfg = tiny_cfg("gpt2")
    params = dict(_seeded_trunk(cfg).named_parameters())
    params["soft_prompt"] = torch.arange(4 * 32, dtype=torch.float32).reshape(4, 32)
    out = export_hf(params, cfg, str(tmp_path / "m"))
    data = np.load(f"{out}/trlx_tpu_heads.npz")
    np.testing.assert_array_equal(data["soft_prompt"], params["soft_prompt"].numpy())


def test_export_includes_rl_heads(tmp_path):
    cfg = tiny_cfg("gpt2")
    params = {f"transformer.{k}": v for k, v in _seeded_trunk(cfg).named_parameters()}
    heads = {"v_head.layers_0.kernel": torch.ones(32, 64)}
    out = export_hf(params, cfg, str(tmp_path / "m"), head_params=heads)
    data = np.load(f"{out}/trlx_tpu_heads.npz")
    np.testing.assert_array_equal(data["v_head/layers_0/kernel"], np.ones((32, 64)))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hf_state_keys_match_transformers(family):
    """The port's per-family key list is the HF model's state dict, less
    the buffers (the rule ``load_state_dict(strict=False)`` checked in the
    JAX package)."""
    cfg = tiny_cfg(family)
    hf_cfg = transformers.AutoConfig.for_model(**build_hf_config(cfg, family))
    hf = getattr(transformers, build_hf_config(cfg, family)["architectures"][0])(hf_cfg)
    buffers = {n for n, _ in hf.named_buffers()}
    assert hf_state_keys(family, cfg) == set(hf.state_dict()) - buffers
    want = transformers.AutoConfig.for_model(**build_hf_config(cfg, family)).to_diff_dict()
    got = build_hf_config(cfg, family)
    for k, v in want.items():
        if k not in ("transformers_version", "torch_dtype", "dtype", "architectures"):
            assert got[k] == v, k


def _randomwalks_config(method, tmp_path, **arch):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
    from randomwalks import base_config

    jcfg = base_config(method, 15, 8)
    config = TRLConfig.from_dict({k: dataclasses.asdict(getattr(jcfg, k)) for k in ("model", "train", "method")})
    config.train.batch_size = 16
    config.train.checkpoint_dir = str(tmp_path / "ck")
    if method == "ppo":
        config.method.chunk_size = 16
        config.method.num_rollouts = 16
    config.model.model_arch.update({"pos_type": "learned", "fused_qkv": True, "tie_word_embeddings": True, **arch})
    return config


def test_ilql_trainer_save_pretrained_exports_q_heads(tmp_path):
    """ILQL export: the trunk becomes the HF checkpoint; both Q heads and the
    V head ride in the sidecar."""
    from trlx_tpu_torch.trainer.ilql import ILQLTrainer

    trainer = ILQLTrainer(_randomwalks_config("ilql", tmp_path), device="cpu")
    out = trainer.save_pretrained(str(tmp_path / "hf"))
    data = np.load(f"{out}/trlx_tpu_heads.npz")
    for head in ("q1_head/", "q2_head/", "v_head/"):
        assert any(k.startswith(head) for k in data.files), head
    np.testing.assert_array_equal(data["q1_head/layers_1/kernel"],
                                  trainer.model.q1_head.layers_1.kernel.detach().numpy())
    back = load_hf_trunk(out, trainer.model.cfg)
    for k, v in trainer.model.transformer.state_dict().items():
        assert torch.equal(back[k], v), k


def test_trainer_save_pretrained_roundtrips(tmp_path):
    """A PPOTrainer's parameters export to an HF directory that a fresh
    trainer loads as ``model_path``: the RLHF → HF → RLHF cycle. The value
    head stays fresh (seeded), the trunk is the exported one."""
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    config = _randomwalks_config("ppo", tmp_path)
    trainer = PPOTrainer(config, device="cpu")
    with torch.no_grad():
        for p in trainer.model.transformer.parameters():
            p.add_(0.01)
    out = trainer.save_pretrained(str(tmp_path / "hf"))
    config2 = _randomwalks_config("ppo", tmp_path)
    config2.model.model_path, config2.model.model_arch = out, {}
    fresh = PPOTrainer(config2, device="cpu")
    assert fresh.load_log["policy"]["bytes"] > 0
    for (k, a), (k2, b) in zip(trainer.model.transformer.state_dict().items(),
                               fresh.model.transformer.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    # the extras (the frozen reference) are copies of the loaded trunk
    for k, v in fresh.extras.items():
        assert torch.equal(v, dict(fresh.model.named_parameters())[k]), k


# --------------------------------------------------------------- streaming


def _save_sharded_mixed_dtype(model, out_dir, n_shards=3):
    """The state dict as ``n_shards`` safetensors files with an index (a
    multi-shard HF download's layout), tensor dtypes f16 / bf16 / f32 by
    shard."""
    os.makedirs(out_dir, exist_ok=True)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    keys = list(sd)
    dtypes = [torch.float16, torch.bfloat16, torch.float32]
    weight_map = {}
    for s in range(n_shards):
        fname = f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"
        shard = {k: sd[k].to(dtypes[s % 3]).contiguous() for k in keys[s::n_shards]}
        weight_map.update({k: fname for k in shard})
        st_save_file(shard, os.path.join(out_dir, fname))
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    model.config.save_pretrained(out_dir)


def test_sharded_mixed_dtype_load_logits_parity(tmp_path):
    """A 3-shard f16 / bf16 / f32 checkpoint streams into a trainer's
    parameters (cast to f32) and computes the logits of a torch forward over
    the same rounded weights; the trunk equals JAX's streamed load bit for
    bit."""
    torch.manual_seed(0)
    hf = transformers.GPTJForCausalLM(transformers.GPTJConfig(
        n_layer=3, n_head=4, n_embd=64, vocab_size=128, n_positions=64, rotary_dim=8))
    ckpt = str(tmp_path / "ckpt")
    _save_sharded_mixed_dtype(hf, ckpt)
    sd = stio.SafetensorsReader(ckpt)
    hf.load_state_dict({k: sd[k].float() for k in sd})
    hf.eval()

    cfg = lm_config_from_hf(read_hf_config(ckpt), dtype="float32", param_dtype="float32")
    model = TransformerLM(cfg, device="cpu")
    trunk = load_hf_trunk(ckpt, cfg, put=lambda name, t: model.get_parameter(name).data.copy_(t))
    jcfg = jax_lm_config_from_hf(hf.config, dtype="float32", param_dtype="float32")
    jtrunk = params_from_jax(jax.device_get(jax_load_hf_trunk(
        ckpt, jcfg, put=lambda path, arr: jnp.asarray(np.asarray(arr, np.float32)))))
    for k, v in trunk.items():
        assert torch.equal(v, jtrunk[k]), k
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 12))
    with torch.no_grad():
        ref = hf(torch.as_tensor(ids)).logits.numpy()
        got = model.eval()(torch.as_tensor(ids, dtype=torch.int32))["logits"].numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_single_file_safetensors_load(tmp_path):
    """``save_pretrained``'s single ``model.safetensors`` (no index) loads
    through the same path."""
    hf, ckpt = _hf_dir("gpt2", tmp_path)
    assert os.path.exists(os.path.join(ckpt, "model.safetensors"))
    cfg = lm_config_from_hf(read_hf_config(ckpt), dtype="float32", param_dtype="float32")
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 10))
    with torch.no_grad():
        ref = hf(torch.as_tensor(ids)).logits.numpy()
        got = _port_lm(cfg, load_hf_trunk(ckpt, cfg))(torch.as_tensor(ids, dtype=torch.int32))["logits"].numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_export_roundtrip_through_streamed_loader(tmp_path):
    """A bare trunk exported (gptj, sharded by a small limit) re-imports
    bit-exactly; so does a legacy ``pytorch_model.bin`` of it."""
    cfg = LMConfig.from_dict(dict(vocab_size=97, n_layer=2, n_head=4, d_model=32, max_position=64, **FAMILIES["gptj"]))
    model = _seeded_trunk(cfg, seed=3)
    out = str(tmp_path / "export")
    export_hf(dict(model.named_parameters()), cfg, out, family="gptj", max_shard_bytes=20_000)
    assert os.path.exists(os.path.join(out, "model.safetensors.index.json"))
    assert sum(f.endswith(".safetensors") for f in os.listdir(out)) > 1
    own = model.state_dict()
    for src in ("safetensors", "bin"):
        if src == "bin":
            binf = str(tmp_path / "bin")
            os.makedirs(binf)
            torch.save(export_state_dict(own, cfg), os.path.join(binf, "pytorch_model.bin"))
            out = binf
        back = load_hf_trunk(out, cfg)
        assert set(back) == set(own)
        for k, v in own.items():
            assert torch.equal(back[k], v), (src, k)


# ---------------------------------------------------------- safetensors_io

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.bool]


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, shape in enumerate([(3, 5), (7,), (2, 3, 4), (1,), ()]):
        x = torch.randn(shape, generator=g) * 100
        out[f"t{i}.{shape}"] = x > 0 if dtype == torch.bool else x.to(dtype)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reader_matches_safe_open(dtype, tmp_path):
    """A file ``safetensors`` wrote, single and sharded with an index, reads
    back bit-equal, entry for entry, to ``safe_open``'s tensors."""
    ts = _tensors(dtype)
    single = tmp_path / "single"
    single.mkdir()
    st_save_file(ts, str(single / "model.safetensors"), metadata={"format": "pt"})
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    keys = sorted(ts)
    weight_map = {}
    for s, part in enumerate((keys[:2], keys[2:])):
        fname = f"model-{s + 1:05d}-of-00002.safetensors"
        st_save_file({k: ts[k] for k in part}, str(sharded / fname))
        weight_map.update({k: fname for k in part})
    (sharded / "model.safetensors.index.json").write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))
    for path in (single, sharded):
        reader = stio.SafetensorsReader(str(path))
        assert sorted(reader) == keys and len(reader) == len(keys)
        for k in keys:
            with safe_open(str(path / weight_map[k]) if path == sharded else str(path / "model.safetensors"),
                           framework="pt") as f:
                want = f.get_tensor(k)
            got = reader[k]
            assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_writer_read_by_safetensors(dtype, tmp_path):
    """The writer's files (single, and sharded with an index past the
    limit) are read by ``safe_open`` bit-equal, with the ``{"format":
    "pt"}`` metadata, and each tensor's data starts at a multiple of its
    item size."""
    ts = _tensors(dtype, seed=1)
    for name, limit in (("single", stio.DEFAULT_MAX_SHARD_BYTES), ("sharded", 40)):
        out = str(tmp_path / name)
        files = stio.write_safetensors(out, ts, max_shard_bytes=limit)
        assert (stio.INDEX_FILE in files) == (name == "sharded")
        for fname in files:
            if not fname.endswith(".safetensors"):
                continue
            with safe_open(os.path.join(out, fname), framework="pt") as f:
                assert f.metadata() == {"format": "pt"}
                for k in f.keys():
                    assert torch.equal(f.get_tensor(k), ts[k]), k
            header, start = stio.read_header(os.path.join(out, fname))
            assert start % 8 == 0
            for k, e in header.items():
                if k != "__metadata__":
                    assert e["data_offsets"][0] % ts[k].element_size() == 0, k
        reader = stio.SafetensorsReader(out)
        assert set(reader) == set(ts)


def test_writer_and_reader_refuse_bad_input(tmp_path):
    """A dtype outside the six is refused by name on write and on read; a
    lazy tensor that produces another shape than it declared is refused."""
    with pytest.raises(ValueError, match="float64"):
        stio.write_safetensors(str(tmp_path / "a"), {"x": torch.zeros(2, dtype=torch.float64)})
    (tmp_path / "b").mkdir()
    st_save_file({"x": torch.zeros(2, dtype=torch.float64)}, str(tmp_path / "b" / "model.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        stio.SafetensorsReader(str(tmp_path / "b"))
    bad = stio.LazyTensor((2, 2), torch.float32, lambda: torch.zeros(3))
    with pytest.raises(ValueError, match="declared"):
        stio.write_safetensors(str(tmp_path / "c"), {"x": bad})
    # The shards huggingface_hub's split (save_pretrained's) makes: an
    # oversized tensor gets its own shard while the open one stays open.
    from huggingface_hub import split_torch_state_dict_into_shards

    for sizes in ([3, 3, 9, 1], [2, 3, 1], [5, 1, 4, 6, 2]):
        sd = {f"t{i}": torch.zeros(n, dtype=torch.int8) for i, n in enumerate(sizes)}
        want = split_torch_state_dict_into_shards(sd, max_shard_size=5, filename_pattern="m{suffix}")
        got = stio.plan_shards([(k, v.numel()) for k, v in sd.items()], 5)
        assert sorted(map(sorted, got)) == sorted(map(sorted, want.filename_to_tensors.values())), sizes


def test_load_and_export_without_transformers_or_safetensors(tmp_path, monkeypatch):
    """With ``transformers`` and ``safetensors`` unimportable, a trainer
    loads an HF directory as ``model_path`` and ``save_pretrained`` exports
    it; the export reads back equal."""
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    _, path = _hf_dir("gptj", tmp_path)
    for name in ("transformers", "safetensors", "safetensors.torch"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import transformers as _  # noqa: F401
    config = _randomwalks_config("ppo", tmp_path)
    config.model.model_path, config.model.model_arch = path, {}
    trainer = PPOTrainer(config, device="cpu")
    out = trainer.save_pretrained(str(tmp_path / "out"))
    back = load_hf_trunk(out, trainer.model.cfg)
    for k, v in trainer.model.transformer.state_dict().items():
        assert torch.equal(back[k], v), k
