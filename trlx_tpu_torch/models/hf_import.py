"""Model configs and weights: ``model_arch`` or an HF checkpoint directory →
``LMConfig``; a seeded from-scratch initialization; an HF checkpoint's trunk
streamed into the model's parameters; and the Flax parameter tree → state
dict map.

Counterpart of ``trlx_tpu.models.hf_import``. HF is only a weight source
and it is read without ``transformers``: ``config.json`` as JSON
(``read_hf_config``), safetensors through ``models/safetensors_io.py``
(single file or sharded index), a legacy ``pytorch_model.bin`` through
``torch.load(weights_only=True, mmap=True)``. The conversion is a spec (one
thunk per target parameter), so the load materialises one source tensor at
a time and copies it, cast to the parameter's dtype, into the live
parameter in place: host memory stays O(largest tensor) and no host copy of
the model exists. Families: gpt2, gpt-j, gpt-neo, gpt-neox.
"""

import json
import os
from collections.abc import Mapping
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from trlx_tpu_torch.models.lm import Dense, Embed, LayerNorm, LMConfig
from trlx_tpu_torch.models.safetensors_io import SafetensorsReader

# Every field each transformers config class writes into config.json, with
# the class's default (transformers 4.57, ``to_diff_dict`` of a default
# config): ``read_hf_config`` fills what a config.json leaves out from here,
# as ``AutoConfig`` does, and ``hf_export.build_hf_config`` starts from it.
_NEO_LAYERS = ["global", "local"] * 12
HF_CONFIG_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12, n_head=12, n_inner=None,
                 activation_function="gelu_new", resid_pdrop=0.1, embd_pdrop=0.1, attn_pdrop=0.1,
                 layer_norm_epsilon=1e-5, initializer_range=0.02, summary_type="cls_index", summary_use_proj=True,
                 summary_activation=None, summary_first_dropout=0.1, summary_proj_to_labels=True,
                 scale_attn_weights=True, use_cache=True, scale_attn_by_inverse_layer_idx=False,
                 reorder_and_upcast_attn=False, bos_token_id=50256, eos_token_id=50256, tie_word_embeddings=True),
    "gptj": dict(vocab_size=50400, n_positions=2048, n_embd=4096, n_layer=28, n_head=16, n_inner=None, rotary_dim=64,
                 activation_function="gelu_new", resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
                 layer_norm_epsilon=1e-5, initializer_range=0.02, use_cache=True, bos_token_id=50256,
                 eos_token_id=50256, tie_word_embeddings=False),
    "gpt_neo": dict(vocab_size=50257, max_position_embeddings=2048, hidden_size=2048, num_layers=24, num_heads=16,
                    intermediate_size=None, window_size=256, activation_function="gelu_new", resid_dropout=0.0,
                    embed_dropout=0.0, attention_dropout=0.0, classifier_dropout=0.1, layer_norm_epsilon=1e-5,
                    initializer_range=0.02, use_cache=True, bos_token_id=50256, eos_token_id=50256,
                    attention_types=[[["global", "local"], 12]], attention_layers=_NEO_LAYERS,
                    tie_word_embeddings=True),
    "gpt_neox": dict(vocab_size=50432, max_position_embeddings=2048, hidden_size=6144, num_hidden_layers=44,
                     num_attention_heads=64, intermediate_size=24576, hidden_act="gelu", rotary_pct=0.25,
                     partial_rotary_factor=0.25, rotary_emb_base=10000, rope_theta=10000, attention_dropout=0.0,
                     hidden_dropout=0.0, classifier_dropout=0.1, initializer_range=0.02, layer_norm_eps=1e-5,
                     use_cache=True, use_parallel_residual=True, rope_scaling=None, attention_bias=True,
                     bos_token_id=0, eos_token_id=2, tie_word_embeddings=False),
}


def read_hf_config(path: str) -> SimpleNamespace:
    """``<path>/config.json`` as an attribute namespace, with the config
    class's defaults for the fields it leaves out (what ``AutoConfig``
    gives for the fields ``lm_config_from_hf`` reads). GPT-Neo's
    ``attention_layers`` is expanded from ``attention_types`` when absent."""
    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    t = d.get("model_type")
    if t not in HF_CONFIG_DEFAULTS:
        raise ValueError(f"unsupported HF model_type for conversion: {t}")
    if t == "gpt_neo" and "attention_layers" not in d:
        types = d.get("attention_types", HF_CONFIG_DEFAULTS[t]["attention_types"])
        d["attention_layers"] = [kind for kinds, n in types for _ in range(n) for kind in kinds]
    return SimpleNamespace(**{**HF_CONFIG_DEFAULTS[t], **d})


def build_lm_config(config) -> LMConfig:
    """Resolve an LMConfig from the config's ``model_arch`` overrides or, with
    none, from the HF checkpoint's ``config.json`` at ``model_path``."""
    mc = config.model
    base: Dict[str, Any] = dict(
        dtype=mc.dtype,
        param_dtype=mc.param_dtype,
        remat=mc.remat,
        remat_policy=getattr(mc, "remat_policy", "full"),
        kv_cache_quant=getattr(mc, "kv_cache_quant", False),
    )
    if mc.model_arch:
        return LMConfig.from_dict({**base, **mc.model_arch})
    if not mc.model_path:
        raise ValueError("Either model.model_path or model.model_arch must be set")
    return lm_config_from_hf(read_hf_config(mc.model_path), **base)


def lm_config_from_hf(hf, **overrides) -> LMConfig:
    """An HF config (``read_hf_config``'s namespace or a transformers
    config) → LMConfig, per family, as the JAX package maps it."""
    t = hf.model_type
    if t == "gpt2":
        d = dict(vocab_size=hf.vocab_size, n_layer=hf.n_layer, n_head=hf.n_head, d_model=hf.n_embd,
                 max_position=hf.n_positions, pos_type="learned", parallel_residual=False, fused_qkv=True,
                 qkv_bias=True, tie_word_embeddings=True, activation="gelu_new", ln_eps=hf.layer_norm_epsilon)
    elif t == "gptj":
        d = dict(vocab_size=hf.vocab_size, n_layer=hf.n_layer, n_head=hf.n_head, d_model=hf.n_embd,
                 max_position=hf.n_positions, pos_type="rotary", rotary_dim=hf.rotary_dim or (hf.n_embd // hf.n_head),
                 parallel_residual=True, use_parallel_ln=False, fused_qkv=False, qkv_bias=False, out_bias=False,
                 tie_word_embeddings=False, activation="gelu_new", ln_eps=hf.layer_norm_epsilon,
                 extra={"lm_head_bias": True})
    elif t == "gpt_neo":
        d = dict(vocab_size=hf.vocab_size, n_layer=hf.num_layers, n_head=hf.num_heads, d_model=hf.hidden_size,
                 d_ff=hf.intermediate_size or 0, max_position=hf.max_position_embeddings, pos_type="learned",
                 parallel_residual=False, fused_qkv=False, qkv_bias=False, out_bias=True,
                 scale_attn=False,  # gpt-neo attention is unscaled
                 attention_layers=tuple(hf.attention_layers), window_size=hf.window_size, tie_word_embeddings=True,
                 activation=hf.activation_function, ln_eps=hf.layer_norm_epsilon)
    elif t == "gpt_neox":
        head_dim = hf.hidden_size // hf.num_attention_heads
        d = dict(vocab_size=hf.vocab_size, n_layer=hf.num_hidden_layers, n_head=hf.num_attention_heads,
                 d_model=hf.hidden_size, d_ff=hf.intermediate_size, max_position=hf.max_position_embeddings,
                 pos_type="rotary", rotary_dim=int(hf.rotary_pct * head_dim),
                 parallel_residual=getattr(hf, "use_parallel_residual", True), use_parallel_ln=True, fused_qkv=True,
                 qkv_bias=True, tie_word_embeddings=False, activation="gelu", ln_eps=hf.layer_norm_eps,
                 extra={"neox_rotary": True})
    else:
        raise ValueError(f"unsupported HF model_type for conversion: {t}")
    d.update(overrides)
    return LMConfig.from_dict(d)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded from-scratch init, in place, on the parameters' device:
    Dense kernels N(0, 1/fan_in), embeddings N(0, 1/features), LayerNorm
    scale 1, every bias 0, a soft prompt N(0, 0.02^2) (the variances of the
    Flax initializers)."""
    for mod in model.modules():
        if isinstance(getattr(mod, "soft_prompt", None), torch.Tensor):
            mod.soft_prompt.normal_(0.0, 0.02, generator=generator)
        if isinstance(mod, Dense):
            mod.kernel.normal_(0.0, float(mod.kernel.shape[0]) ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Embed):
            mod.embedding.normal_(0.0, float(mod.embedding.shape[1]) ** -0.5, generator=generator)
        elif isinstance(mod, LayerNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()


@torch.no_grad()
def load_or_init_params(model: nn.Module, config, generator: torch.Generator) -> Optional[Dict[str, Any]]:
    """Seeded init of every parameter on its device; then, when the config
    names a checkpoint (``model_path`` without ``model_arch``), the HF
    trunk streamed over ``model.transformer``: each converted tensor is
    cast to its parameter's dtype and copied into it in place, one at a
    time. Heads (value, Q) stay fresh. Returns the load's record (bytes,
    seconds) or None when nothing was loaded."""
    import time

    init_params(model, generator)
    mc = config.model
    if not (mc.model_path and not mc.model_arch):
        return None
    # A soft prompt has no HF counterpart: it keeps its seeded init.
    own = {n: p for n, p in model.transformer.named_parameters() if n != "soft_prompt"}
    t0 = time.perf_counter()
    nbytes = 0

    def put(name: str, t: torch.Tensor):
        nonlocal nbytes
        p = own[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != parameter shape {tuple(p.shape)}")
        nbytes += t.numel() * t.element_size()
        # To the device in the checkpoint's dtype and layout (a transposed
        # view keeps its strides: one memcpy of its storage), then cast and
        # transposed there by copy_.
        p.copy_(t if p.device.type == "cpu" else t.to(p.device))
        return None

    sd = open_state_dict(mc.model_path)
    spec = trunk_spec(_family_of(sd), model.transformer.cfg)
    missing, extra = sorted(set(own) - set(spec)), sorted(set(spec) - set(own))
    if missing or extra:
        raise KeyError(f"the checkpoint's spec does not cover the trunk: missing {missing[:4]}, unexpected {extra[:4]}")
    materialize_spec(spec, sd, put=put)
    if any(p.device.type == "cuda" for p in own.values()):
        torch.cuda.synchronize()
    return {"path": mc.model_path, "bytes": nbytes, "load_s": time.perf_counter() - t0}


def open_state_dict(model_path: str) -> Mapping:
    """The checkpoint's state dict, lazily: safetensors (single or sharded)
    through ``SafetensorsReader``, else ``pytorch_model.bin`` mapped by
    ``torch.load(weights_only=True, mmap=True)``."""
    try:
        return SafetensorsReader(model_path)
    except (FileNotFoundError, NotADirectoryError):
        pass
    binf = os.path.join(model_path, "pytorch_model.bin")
    if not os.path.isfile(binf):
        raise FileNotFoundError(f"no safetensors checkpoint and no pytorch_model.bin under {model_path!r}")
    return torch.load(binf, map_location="cpu", weights_only=True, mmap=True)


def load_hf_trunk(model_path: str, cfg: LMConfig, put: Optional[Callable] = None) -> Dict[str, Any]:
    """Convert an HF checkpoint's transformer trunk to the port's parameter
    names (relative to ``transformer.``), one tensor at a time: each
    converted tensor goes through ``put(name, tensor)`` as soon as it is
    made (the value stored is what ``put`` returns), or is kept as a host
    tensor when ``put`` is None."""
    sd = open_state_dict(model_path)
    return materialize_spec(trunk_spec(_family_of(sd), cfg), sd, put=put)


def _family_of(sd) -> str:
    t = _detect_family(sd)
    if t == "unknown":
        raise ValueError(f"cannot detect supported family from state dict ({list(sd)[:3]}...)")
    return t


def _detect_family(sd) -> str:
    if any(k.startswith("transformer.h.") and ".attn.c_attn." in k for k in sd):
        return "gpt2"
    if any(".attn.attention.q_proj." in k for k in sd):
        return "gpt_neo"
    if any(".attn.q_proj." in k for k in sd):
        return "gptj"
    if any("gpt_neox.layers." in k for k in sd):
        return "gpt_neox"
    return "unknown"


# --------------------------------------------------------------------------
# Conversion specs: flat {port name: thunk(sd) -> tensor}, so a lazy state
# dict materialises ONE source tensor per target parameter. The eager
# convert_* functions are materialisations of these specs.


def _id(key):
    return lambda sd: sd[key]


def _t(key):
    return lambda sd: sd[key].t()


def _ln_spec(p: Dict, prefix: str, src: str):
    p[f"{prefix}.scale"] = _id(f"{src}.weight")
    p[f"{prefix}.bias"] = _id(f"{src}.bias")


def materialize_spec(spec: Dict[str, Callable], sd, put: Optional[Callable] = None) -> Dict[str, Any]:
    """Evaluate a spec against a (possibly lazy) state dict, handing each
    tensor to ``put(name, tensor)`` as soon as it is converted."""
    out = {}
    for name, thunk in spec.items():
        t = thunk(sd)
        out[name] = put(name, t) if put is not None else t.contiguous()
    return out


def trunk_spec(family: str, cfg: LMConfig) -> Dict[str, Callable]:
    if family == "gpt2":
        return _spec_gpt2(cfg)
    if family == "gptj":
        return _spec_gptj(cfg)
    if family == "gpt_neo":
        return _spec_gpt_neo(cfg)
    if family == "gpt_neox":
        return _spec_neox(cfg)
    raise ValueError(f"unsupported family: {family}")


def _spec_gpt2(cfg: LMConfig) -> Dict[str, Callable]:
    """GPT-2: HF Conv1D weights are already [in, out] — direct copy."""
    p: Dict[str, Callable] = {"wte.embedding": _id("transformer.wte.weight"),
                              "wpe.embedding": _id("transformer.wpe.weight")}
    _ln_spec(p, "ln_f", "transformer.ln_f")
    if not cfg.tie_word_embeddings:
        # Canonical gpt2 ties; an untied checkpoint (e.g. an export of an
        # untied from-scratch arch) carries a real head.
        p["lm_head.kernel"] = _t("lm_head.weight")
    for i in range(cfg.n_layer):
        h, o = f"transformer.h.{i}", f"h_{i}"
        _ln_spec(p, f"{o}.ln_1", f"{h}.ln_1")
        _ln_spec(p, f"{o}.ln_2", f"{h}.ln_2")
        for ours, theirs in (("attn.c_qkv", "attn.c_attn"), ("attn.c_proj", "attn.c_proj"),
                             ("mlp.c_fc", "mlp.c_fc"), ("mlp.c_proj", "mlp.c_proj")):
            p[f"{o}.{ours}.kernel"] = _id(f"{h}.{theirs}.weight")
            p[f"{o}.{ours}.bias"] = _id(f"{h}.{theirs}.bias")
    return p


def _spec_gptj(cfg: LMConfig) -> Dict[str, Callable]:
    """GPT-J: nn.Linear weights are [out, in] — transposed to [in, out]."""
    p: Dict[str, Callable] = {"wte.embedding": _id("transformer.wte.weight")}
    _ln_spec(p, "ln_f", "transformer.ln_f")
    if not cfg.tie_word_embeddings:
        p["lm_head.kernel"] = _t("lm_head.weight")
        if cfg.extra.get("lm_head_bias", False):
            p["lm_head.bias"] = _id("lm_head.bias")
    for i in range(cfg.n_layer):
        h, o = f"transformer.h.{i}", f"h_{i}"
        _ln_spec(p, f"{o}.ln_1", f"{h}.ln_1")
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                             ("c_proj", "out_proj")):
            p[f"{o}.attn.{ours}.kernel"] = _t(f"{h}.attn.{theirs}.weight")
        for ours, theirs in (("c_fc", "fc_in"), ("c_proj", "fc_out")):
            p[f"{o}.mlp.{ours}.kernel"] = _t(f"{h}.mlp.{theirs}.weight")
            p[f"{o}.mlp.{ours}.bias"] = _id(f"{h}.mlp.{theirs}.bias")
    return p


def _spec_gpt_neo(cfg: LMConfig) -> Dict[str, Callable]:
    """GPT-Neo: a gpt2-style trunk with nn.Linear projections ([out, in] →
    transposed), biasless q/k/v, tied head."""
    p: Dict[str, Callable] = {"wte.embedding": _id("transformer.wte.weight"),
                              "wpe.embedding": _id("transformer.wpe.weight")}
    _ln_spec(p, "ln_f", "transformer.ln_f")
    if not cfg.tie_word_embeddings:
        p["lm_head.kernel"] = _t("lm_head.weight")
    for i in range(cfg.n_layer):
        h, o = f"transformer.h.{i}", f"h_{i}"
        a = f"{h}.attn.attention"
        _ln_spec(p, f"{o}.ln_1", f"{h}.ln_1")
        _ln_spec(p, f"{o}.ln_2", f"{h}.ln_2")
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                             ("c_proj", "out_proj")):
            p[f"{o}.attn.{ours}.kernel"] = _t(f"{a}.{theirs}.weight")
        p[f"{o}.attn.c_proj.bias"] = _id(f"{a}.out_proj.bias")
        for name in ("c_fc", "c_proj"):
            p[f"{o}.mlp.{name}.kernel"] = _t(f"{h}.mlp.{name}.weight")
            p[f"{o}.mlp.{name}.bias"] = _id(f"{h}.mlp.{name}.bias")
    return p


def _spec_neox(cfg: LMConfig) -> Dict[str, Callable]:
    """GPT-NeoX: the fused query_key_value is laid out [n_head, 3, head_dim]
    on the output dim — permuted into the port's q|k|v block layout."""
    nh, hd, d = cfg.n_head, cfg.head_dim, cfg.d_model

    def qkv_w(key):
        def f(sd):  # [3d, d] torch → [d, 3d] ours (q|k|v)
            w = sd[key].reshape(nh, 3, hd, d)  # heads-major interleave
            return torch.cat([w[:, j] for j in range(3)], dim=0).reshape(3 * d, d).t()

        return f

    def qkv_b(key):
        def f(sd):
            b = sd[key].reshape(nh, 3, hd)
            return torch.cat([b[:, j] for j in range(3)], dim=0).reshape(3 * d)

        return f

    p: Dict[str, Callable] = {"wte.embedding": _id("gpt_neox.embed_in.weight")}
    _ln_spec(p, "ln_f", "gpt_neox.final_layer_norm")
    if not cfg.tie_word_embeddings:
        p["lm_head.kernel"] = _t("embed_out.weight")
    for i in range(cfg.n_layer):
        h, o = f"gpt_neox.layers.{i}", f"h_{i}"
        _ln_spec(p, f"{o}.ln_1", f"{h}.input_layernorm")
        _ln_spec(p, f"{o}.ln_2", f"{h}.post_attention_layernorm")
        p[f"{o}.attn.c_qkv.kernel"] = qkv_w(f"{h}.attention.query_key_value.weight")
        p[f"{o}.attn.c_qkv.bias"] = qkv_b(f"{h}.attention.query_key_value.bias")
        p[f"{o}.attn.c_proj.kernel"] = _t(f"{h}.attention.dense.weight")
        p[f"{o}.attn.c_proj.bias"] = _id(f"{h}.attention.dense.bias")
        for ours, theirs in (("c_fc", "dense_h_to_4h"), ("c_proj", "dense_4h_to_h")):
            p[f"{o}.mlp.{ours}.kernel"] = _t(f"{h}.mlp.{theirs}.weight")
            p[f"{o}.mlp.{ours}.bias"] = _id(f"{h}.mlp.{theirs}.bias")
    return p


# Eager converters (tests and tooling): materialisations of the specs above.


def convert_gpt2(sd: Mapping, cfg: LMConfig) -> Dict[str, torch.Tensor]:
    return materialize_spec(_spec_gpt2(cfg), sd)


def convert_gptj(sd: Mapping, cfg: LMConfig) -> Dict[str, torch.Tensor]:
    return materialize_spec(_spec_gptj(cfg), sd)


def convert_gpt_neo(sd: Mapping, cfg: LMConfig) -> Dict[str, torch.Tensor]:
    return materialize_spec(_spec_gpt_neo(cfg), sd)


def convert_neox(sd: Mapping, cfg: LMConfig) -> Dict[str, torch.Tensor]:
    return materialize_spec(_spec_neox(cfg), sd)


def params_from_jax(params: Mapping, model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Map a Flax parameter tree of host arrays (``jax.device_get`` of the
    JAX package's params, or of its frozen-branch extras) onto the port's
    parameter names: ``transformer/h_0/attn/q_proj/kernel`` →
    ``transformer.h_0.attn.q_proj.kernel``. The two packages keep the same
    names and layouts (Dense kernels [in, out], LayerNorm scale/bias,
    embeddings [V, D]), so every leaf carries over as it is.

    With ``model``, every name and shape is checked against its parameters
    (a subset is allowed: the branch extras are one)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, name)
            else:
                out[name] = torch.from_numpy(np.array(val, copy=True))

    walk(params, "")
    if model is not None:
        known = dict(model.named_parameters())
        for name, t in out.items():
            if name not in known:
                raise KeyError(f"JAX parameter {name!r} has no counterpart in {type(model).__name__}")
            if tuple(known[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: JAX shape {tuple(t.shape)} != port shape {tuple(known[name].shape)}")
    return out
