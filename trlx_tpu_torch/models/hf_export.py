"""Port parameters → HF checkpoint export (the counterpart of
``trlx_tpu.models.hf_export``), without ``transformers``.

The inverse of ``hf_import``: the trained trunk is written as an ordinary
HuggingFace checkpoint directory — ``config.json`` (``build_hf_config``, the
fields the transformers config class writes) and f32 safetensors, sharded
with an index past 5 GB as ``save_pretrained`` does
(``models/safetensors_io.py``) — that ``AutoModelForCausalLM.from_pretrained``
loads and ``hf_import`` re-imports. The export is a spec of lazy tensors:
each HF tensor is made from its parameter (transposed and cast on the
parameter's device), copied to the host, written and dropped, so host
memory stays O(largest tensor).

RL heads (value, Q) have no HF slot and go beside the checkpoint as
``trlx_tpu_heads.npz``. Families mirror ``hf_import``: gpt2, gptj, gpt_neo,
gpt_neox.
"""

import json
import os
from collections.abc import Mapping
from typing import Callable, Dict, List, Optional, Set

import numpy as np
import torch

from trlx_tpu_torch.models.hf_import import HF_CONFIG_DEFAULTS
from trlx_tpu_torch.models.lm import LMConfig
from trlx_tpu_torch.models.safetensors_io import DEFAULT_MAX_SHARD_BYTES, LazyTensor, write_safetensors

HF_ARCHITECTURES = {
    "gpt2": "GPT2LMHeadModel",
    "gptj": "GPTJForCausalLM",
    "gpt_neo": "GPTNeoForCausalLM",
    "gpt_neox": "GPTNeoXForCausalLM",
}
HEADS_FILE = "trlx_tpu_heads.npz"


def infer_family(cfg: LMConfig) -> str:
    """Canonical family from the architecture flags (the same axes
    hf_import's per-family tables set)."""
    if cfg.pos_type == "rotary":
        return "gpt_neox" if cfg.fused_qkv else "gptj"
    return "gpt2" if cfg.fused_qkv else "gpt_neo"


def validate_exportable(cfg: LMConfig, family: str):
    """Fail LOUDLY when the LMConfig's semantics can't be represented by the
    target HF family — a silent mismatch would export a checkpoint that
    computes different logits than the trained model."""
    problems = []
    if family == "gpt_neo":
        if cfg.scale_attn:
            problems.append("HF gpt_neo attention is UNSCALED: requires scale_attn=False")
    elif not cfg.scale_attn:
        problems.append(f"HF {family} scales attention by 1/sqrt(head_dim): requires scale_attn=True")
    # Residual structure is fixed per family — except gpt_neox, whose HF
    # config carries use_parallel_residual itself (both styles exportable).
    if family != "gpt_neox":
        wants_parallel = family == "gptj"
        if cfg.parallel_residual != wants_parallel:
            problems.append(
                f"HF {family} uses {'parallel' if wants_parallel else 'sequential'} "
                f"residuals: requires parallel_residual={wants_parallel}"
            )
    # Attention-projection biases are fixed per family; a trained bias the
    # family can't carry would silently vanish from the checkpoint.
    want_qkv_bias = family in ("gpt2", "gpt_neox")
    want_out_bias = family != "gptj"
    if cfg.qkv_bias != want_qkv_bias:
        problems.append(f"HF {family} q/k/v projections: requires qkv_bias={want_qkv_bias}")
    if cfg.out_bias != want_out_bias:
        problems.append(f"HF {family} attention out projection: requires out_bias={want_out_bias}")
    # Local-attention layer patterns exist only in gpt_neo.
    if family != "gpt_neo" and any(t == "local" for t in cfg.attention_layers):
        problems.append(f"HF {family} has no local-attention layers: requires all-global attention_layers")
    if family == "gptj":
        if cfg.extra.get("neox_rotary"):
            problems.append("HF gptj uses interleaved rotary: drop extra.neox_rotary")
        if cfg.use_parallel_ln:
            problems.append("HF gptj has a single shared pre-LN: requires use_parallel_ln=False")
    if family == "gpt_neox" and not cfg.extra.get("neox_rotary"):
        problems.append("HF gpt_neox uses half-rotation rotary: requires extra.neox_rotary=True")
    if problems:
        raise ValueError(f"LMConfig not exportable as {family}: " + "; ".join(problems))


def _trunk(params: Mapping) -> Dict[str, torch.Tensor]:
    """The trunk's tensors by name relative to ``transformer.`` (``params``
    is a model's named parameters, or a bare trunk)."""
    if any(k.startswith("transformer.") for k in params):
        return {k[len("transformer."):]: v for k, v in params.items() if k.startswith("transformer.")}
    return dict(params)


def _f32(t: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor] = lambda x: x) -> LazyTensor:
    """A lazy f32 host tensor ``fn(t)``, made on ``t``'s device when written."""
    shape = tuple(fn(torch.empty(t.shape, device="meta")).shape)
    return LazyTensor(shape, torch.float32, lambda: fn(t.detach().float()).contiguous().cpu())


def _T(t):
    return _f32(t, lambda x: x.t())


def export_spec(params: Mapping, cfg: LMConfig, family: Optional[str] = None) -> Dict[str, LazyTensor]:
    """The trunk as a flat HF state dict of lazy f32 tensors (the HF
    model's ``state_dict`` names, the tied head included)."""
    family = family or infer_family(cfg)
    validate_exportable(cfg, family)
    t = _trunk(params)
    if family == "gpt2":
        return _export_gpt2(t, cfg)
    if family == "gptj":
        return _export_gptj(t, cfg)
    if family == "gpt_neo":
        return _export_gpt_neo(t, cfg)
    if family == "gpt_neox":
        return _export_neox(t, cfg)
    raise ValueError(f"unsupported export family: {family}")


def export_state_dict(params: Mapping, cfg: LMConfig, family: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Trunk parameters → flat HF state dict (f32 host tensors)."""
    return {k: v.fn() for k, v in export_spec(params, cfg, family).items()}


def _put_ln(sd, prefix, t, name):
    sd[f"{prefix}.weight"] = _f32(t[f"{name}.scale"])
    sd[f"{prefix}.bias"] = _f32(t[f"{name}.bias"])


def _head_weight(t, cfg) -> LazyTensor:
    """The LM head as HF's [vocab, d] weight — the tied embedding or the
    trained untied Dense (dropping the untied head would silently export
    wrong logits)."""
    if cfg.tie_word_embeddings:
        return _f32(t["wte.embedding"])
    return _T(t["lm_head.kernel"])


def _head_bias(t, cfg) -> LazyTensor:
    """HF GPTJ's lm_head always has a bias; ours only with
    extra.lm_head_bias — zeros are exported otherwise (numerically
    identical)."""
    if not cfg.tie_word_embeddings and "lm_head.bias" in t:
        return _f32(t["lm_head.bias"])
    return LazyTensor((cfg.vocab_size,), torch.float32, lambda: torch.zeros(cfg.vocab_size))


def _export_gpt2(t, cfg) -> Dict[str, LazyTensor]:
    """Inverse of hf_import's gpt2 spec (Conv1D keeps [in, out])."""
    sd = {"transformer.wte.weight": _f32(t["wte.embedding"]), "transformer.wpe.weight": _f32(t["wpe.embedding"])}
    _put_ln(sd, "transformer.ln_f", t, "ln_f")
    for i in range(cfg.n_layer):
        h, o = f"transformer.h.{i}", f"h_{i}"
        _put_ln(sd, f"{h}.ln_1", t, f"{o}.ln_1")
        _put_ln(sd, f"{h}.ln_2", t, f"{o}.ln_2")
        for theirs, ours in (("attn.c_attn", "attn.c_qkv"), ("attn.c_proj", "attn.c_proj"),
                             ("mlp.c_fc", "mlp.c_fc"), ("mlp.c_proj", "mlp.c_proj")):
            sd[f"{h}.{theirs}.weight"] = _f32(t[f"{o}.{ours}.kernel"])
            sd[f"{h}.{theirs}.bias"] = _f32(t[f"{o}.{ours}.bias"])
    sd["lm_head.weight"] = _head_weight(t, cfg)
    return sd


def _export_gptj(t, cfg) -> Dict[str, LazyTensor]:
    """Inverse of hf_import's gptj spec (nn.Linear wants [out, in])."""
    sd = {"transformer.wte.weight": _f32(t["wte.embedding"]), "lm_head.weight": _head_weight(t, cfg),
          "lm_head.bias": _head_bias(t, cfg)}
    _put_ln(sd, "transformer.ln_f", t, "ln_f")
    for i in range(cfg.n_layer):
        h, o = f"transformer.h.{i}", f"h_{i}"
        _put_ln(sd, f"{h}.ln_1", t, f"{o}.ln_1")
        for theirs, ours in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                             ("out_proj", "c_proj")):
            sd[f"{h}.attn.{theirs}.weight"] = _T(t[f"{o}.attn.{ours}.kernel"])
        for theirs, ours in (("fc_in", "c_fc"), ("fc_out", "c_proj")):
            sd[f"{h}.mlp.{theirs}.weight"] = _T(t[f"{o}.mlp.{ours}.kernel"])
            sd[f"{h}.mlp.{theirs}.bias"] = _f32(t[f"{o}.mlp.{ours}.bias"])
    return sd


def _export_gpt_neo(t, cfg) -> Dict[str, LazyTensor]:
    """Inverse of hf_import's gpt_neo spec."""
    sd = {"transformer.wte.weight": _f32(t["wte.embedding"]), "transformer.wpe.weight": _f32(t["wpe.embedding"])}
    _put_ln(sd, "transformer.ln_f", t, "ln_f")
    for i in range(cfg.n_layer):
        h, o = f"transformer.h.{i}", f"h_{i}"
        a = f"{h}.attn.attention"
        _put_ln(sd, f"{h}.ln_1", t, f"{o}.ln_1")
        _put_ln(sd, f"{h}.ln_2", t, f"{o}.ln_2")
        for theirs, ours in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                             ("out_proj", "c_proj")):
            sd[f"{a}.{theirs}.weight"] = _T(t[f"{o}.attn.{ours}.kernel"])
        sd[f"{a}.out_proj.bias"] = _f32(t[f"{o}.attn.c_proj.bias"])
        for name in ("c_fc", "c_proj"):
            sd[f"{h}.mlp.{name}.weight"] = _T(t[f"{o}.mlp.{name}.kernel"])
            sd[f"{h}.mlp.{name}.bias"] = _f32(t[f"{o}.mlp.{name}.bias"])
    sd["lm_head.weight"] = _head_weight(t, cfg)
    return sd


def _export_neox(t, cfg) -> Dict[str, LazyTensor]:
    """Inverse of hf_import's neox spec: the q|k|v blocks re-interleaved
    into the heads-major [nh, 3, hd] fused layout."""
    nh, hd, d = cfg.n_head, cfg.head_dim, cfg.d_model

    def qkv_w_inv(w):  # ours [d, 3d] → torch [3d, d] heads-major interleave
        return torch.stack(list(w.t().reshape(3, nh, hd, d)), dim=1).reshape(3 * d, d)

    def qkv_b_inv(b):
        return torch.stack(list(b.reshape(3, nh, hd)), dim=1).reshape(3 * d)

    sd = {"gpt_neox.embed_in.weight": _f32(t["wte.embedding"]), "embed_out.weight": _head_weight(t, cfg)}
    _put_ln(sd, "gpt_neox.final_layer_norm", t, "ln_f")
    for i in range(cfg.n_layer):
        h, o = f"gpt_neox.layers.{i}", f"h_{i}"
        _put_ln(sd, f"{h}.input_layernorm", t, f"{o}.ln_1")
        _put_ln(sd, f"{h}.post_attention_layernorm", t, f"{o}.ln_2")
        sd[f"{h}.attention.query_key_value.weight"] = _f32(t[f"{o}.attn.c_qkv.kernel"], qkv_w_inv)
        sd[f"{h}.attention.query_key_value.bias"] = _f32(t[f"{o}.attn.c_qkv.bias"], qkv_b_inv)
        sd[f"{h}.attention.dense.weight"] = _T(t[f"{o}.attn.c_proj.kernel"])
        sd[f"{h}.attention.dense.bias"] = _f32(t[f"{o}.attn.c_proj.bias"])
        for theirs, ours in (("dense_h_to_4h", "c_fc"), ("dense_4h_to_h", "c_proj")):
            sd[f"{h}.mlp.{theirs}.weight"] = _T(t[f"{o}.mlp.{ours}.kernel"])
            sd[f"{h}.mlp.{theirs}.bias"] = _f32(t[f"{o}.mlp.{ours}.bias"])
    return sd


def hf_state_keys(family: str, cfg: LMConfig) -> Set[str]:
    """The keys of the family's HF causal-LM ``state_dict`` (parameters
    only: the attention-mask and rotary buffers are not saved), written out
    per family: the check the export's key set must pass."""
    keys: List[str] = []
    if family in ("gpt2", "gpt_neo", "gptj"):
        keys += ["transformer.wte.weight", "transformer.ln_f.weight", "transformer.ln_f.bias", "lm_head.weight"]
        if family != "gptj":
            keys.append("transformer.wpe.weight")
        else:
            keys.append("lm_head.bias")
    elif family == "gpt_neox":
        keys += ["gpt_neox.embed_in.weight", "gpt_neox.final_layer_norm.weight", "gpt_neox.final_layer_norm.bias",
                 "embed_out.weight"]
    else:
        raise ValueError(f"unsupported export family: {family}")
    for i in range(cfg.n_layer):
        if family == "gpt2":
            h = f"transformer.h.{i}"
            keys += [f"{h}.{m}.{w}" for m in ("ln_1", "ln_2", "attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")
                     for w in ("weight", "bias")]
        elif family == "gptj":
            h = f"transformer.h.{i}"
            keys += [f"{h}.ln_1.weight", f"{h}.ln_1.bias"]
            keys += [f"{h}.attn.{p}.weight" for p in ("q_proj", "k_proj", "v_proj", "out_proj")]
            keys += [f"{h}.mlp.{m}.{w}" for m in ("fc_in", "fc_out") for w in ("weight", "bias")]
        elif family == "gpt_neo":
            h = f"transformer.h.{i}"
            keys += [f"{h}.{m}.{w}" for m in ("ln_1", "ln_2", "mlp.c_fc", "mlp.c_proj") for w in ("weight", "bias")]
            keys += [f"{h}.attn.attention.{p}.weight" for p in ("q_proj", "k_proj", "v_proj", "out_proj")]
            keys.append(f"{h}.attn.attention.out_proj.bias")
        else:
            h = f"gpt_neox.layers.{i}"
            keys += [f"{h}.{m}.{w}" for m in ("input_layernorm", "post_attention_layernorm",
                                              "attention.query_key_value", "attention.dense", "mlp.dense_h_to_4h",
                                              "mlp.dense_4h_to_h") for w in ("weight", "bias")]
    return set(keys)


def tied_head_key(family: str, cfg: LMConfig) -> Optional[str]:
    """The head key ``save_pretrained`` leaves out because it is the
    embedding (tied models), else None."""
    if not cfg.tie_word_embeddings:
        return None
    return "embed_out.weight" if family == "gpt_neox" else "lm_head.weight"


def build_hf_config(cfg: LMConfig, family: Optional[str] = None) -> Dict:
    """LMConfig → the ``config.json`` dict the family's transformers config
    class would write: every field of the class (its defaults,
    ``hf_import.HF_CONFIG_DEFAULTS``) with this architecture's values, the
    architecture's class name, ``model_type`` and dtype float32."""
    family = family or infer_family(cfg)
    validate_exportable(cfg, family)
    # n_inner: only set when it differs from the 4*d default (None keeps
    # canonical configs identical to the published ones).
    n_inner = cfg.d_ff if (cfg.d_ff and cfg.d_ff != 4 * cfg.d_model) else None
    common = dict(vocab_size=cfg.vocab_size, tie_word_embeddings=cfg.tie_word_embeddings)
    if family in ("gpt2", "gptj"):
        v = dict(common, n_positions=cfg.max_position, n_embd=cfg.d_model, n_layer=cfg.n_layer, n_head=cfg.n_head,
                 n_inner=n_inner, activation_function=cfg.activation, layer_norm_epsilon=cfg.ln_eps)
        if family == "gptj":
            v["rotary_dim"] = cfg.rotary_dim or cfg.head_dim
    elif family == "gpt_neo":
        layers = list(cfg.attention_layers) or ["global"] * cfg.n_layer
        v = dict(common, max_position_embeddings=cfg.max_position, hidden_size=cfg.d_model, num_layers=cfg.n_layer,
                 num_heads=cfg.n_head, intermediate_size=cfg.ff_dim, window_size=cfg.window_size or 256,
                 attention_types=[[layers, 1]], attention_layers=layers, activation_function=cfg.activation,
                 layer_norm_epsilon=cfg.ln_eps)
    elif family == "gpt_neox":
        pct = (cfg.rotary_dim or cfg.head_dim) / cfg.head_dim
        v = dict(common, max_position_embeddings=cfg.max_position, hidden_size=cfg.d_model,
                 num_hidden_layers=cfg.n_layer, num_attention_heads=cfg.n_head, intermediate_size=cfg.ff_dim,
                 rotary_pct=pct, partial_rotary_factor=pct, use_parallel_residual=cfg.parallel_residual,
                 hidden_act=cfg.activation, layer_norm_eps=cfg.ln_eps)
    else:
        raise ValueError(f"unsupported export family: {family}")
    out = {**HF_CONFIG_DEFAULTS[family], **v, "architectures": [HF_ARCHITECTURES[family]], "model_type": family,
           "dtype": "float32"}
    return dict(sorted(out.items()))


def export_hf(
    params: Mapping,
    cfg: LMConfig,
    out_dir: str,
    family: Optional[str] = None,
    head_params: Optional[Mapping] = None,
    max_shard_bytes: int = DEFAULT_MAX_SHARD_BYTES,
) -> str:
    """Write an HF checkpoint directory from trained parameters.

    ``params`` maps names to tensors: a model's named parameters (the trunk
    under ``transformer.``) or a bare trunk. ``head_params`` (e.g. the value
    head's, named ``v_head.layers_0.kernel``) go beside it in
    ``trlx_tpu_heads.npz`` under ``/``-joined names, as HF has no slot for
    RL heads. The export's keys must be exactly the family's
    (``hf_state_keys``); the tied head is left out of the files, as
    ``save_pretrained`` leaves it out. Returns ``out_dir``."""
    family = family or infer_family(cfg)
    hf_config = build_hf_config(cfg, family)
    spec = export_spec(params, cfg, family)
    want = hf_state_keys(family, cfg)
    missing, unexpected = sorted(want - set(spec)), sorted(set(spec) - want)
    if unexpected:
        raise ValueError(f"export produced unexpected keys: {unexpected[:5]}")
    if missing:
        raise ValueError(f"export left keys uninitialized: {missing[:5]}")
    tied = tied_head_key(family, cfg)
    if tied is not None:
        del spec[tied]

    # A tuned soft prompt has no HF representation — carry it in the heads
    # sidecar instead of silently dropping the training's entire effect.
    trunk = _trunk(params)
    if "soft_prompt" in trunk:
        head_params = dict(head_params or {})
        head_params["soft_prompt"] = trunk["soft_prompt"]

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2, sort_keys=True)
        f.write("\n")
    write_safetensors(out_dir, spec, max_shard_bytes=max_shard_bytes)
    if head_params:
        flat = {k.replace(".", "/"): torch.as_tensor(v).detach().float().cpu().numpy() for k, v in head_params.items()}
        np.savez(os.path.join(out_dir, HEADS_FILE), **flat)
    return out_dir
