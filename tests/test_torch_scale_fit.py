"""Scale-fit audit of the port (the twin of ``tests/test_scale_fit.py``): the
GPT-J-6B and GPT-NeoX-20B recipes, sharded over their own meshes by
``parallel/sharding.py``'s rules, fit an H100's 80 GB a rank. The port's
``LMWithValueHead`` is built on the ``meta`` device at full size with the
recipe's fsdp and tp (``LMConfig.with_mesh``), so each parameter's
``Placement`` and local piece are the ones a rank would hold; nothing is
allocated, so this runs on the CPU.

What a rank holds between steps, by the port's code:
- the f32 masters of its pieces (``param_dtype: float32``);
- the two Adam moments of its trainable pieces (``ClippedAdamW``: the top
  ``num_layers_unfrozen`` blocks, the embeddings, ln_f, the LM head and the
  value head) and, during a step, their f32 gradients;
- the hydra branch (``extract_branch_params``: the top blocks, ln_f and the
  LM head, f32 clones of the pieces);
- the bf16 compute copies held once per weight version (``models/lm.py``
  ``fsdp_weight``: each kernel gathered over fsdp, this rank's tp piece;
  ``full_weight``: the LM head whole, since the fused head reads the whole
  vocabulary), of the policy and the branch;
- for ``ppo_neox20b_rm``, the reward model: a second NeoX-20B trunk with its
  value head, f32 pieces and the bf16 copies of what its scoring reads (no LM
  head).

The headroom left for activations, the KV cache and the allocator is stated
per recipe below.
"""

import os

import numpy as np
import pytest

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.heads import LMWithValueHead, trainable_mask
from trlx_tpu_torch.models.lm import LMConfig, placement_of
from trlx_tpu_torch.parallel.mesh import resolve_mesh_shape

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100_BYTES = 80e9

# EleutherAI/gpt-j-6B and EleutherAI/gpt-neox-20b at full width and depth.
GPTJ_6B = LMConfig(vocab_size=50400, n_layer=28, n_head=16, d_model=4096, max_position=2048, pos_type="rotary",
                   rotary_dim=64, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                   tie_word_embeddings=False, extra={"lm_head_bias": True})
NEOX_20B = LMConfig(vocab_size=50432, n_layer=44, n_head=64, d_model=6144, d_ff=24576, max_position=2048,
                    pos_type="rotary", rotary_dim=24, parallel_residual=True, use_parallel_ln=True, fused_qkv=True,
                    extra={"neox_rotary": True}, tie_word_embeddings=False)

# recipe → (model, cards, what a rank may hold at most: 80 GB less the
# headroom kept for activations, the KV cache and the allocator).
RECIPES = {
    "ppo_gptj": (GPTJ_6B, 8, 0.5 * H100_BYTES),
    "ppo_neox20b_rm": (NEOX_20B, 32, 0.5 * H100_BYTES),
}


def _recipe(name):
    return TRLConfig.load_yaml(os.path.join(ROOT, "trlx_tpu_torch", "configs", f"{name}_config.yml"))


def _sharded(cfg, mesh, k):
    """The model as a rank of ``mesh`` builds it, on the meta device, its
    hydra branch at the top ``k`` blocks."""
    _, fsdp, tp, _ = mesh
    return LMWithValueHead(cfg.with_mesh(tp=tp, fsdp=fsdp), branch_layer=cfg.n_layer - k, device="meta")


def _copy_numel(model, name, p):
    """Elements of the bf16 compute copy a rank holds for parameter
    ``name``: the whole LM head (``full_weight``), else the piece gathered
    over fsdp (``fsdp_weight``; the tp piece stays)."""
    pl = placement_of(model, name)
    if pl is None:
        return p.numel()
    if name.endswith("lm_head.kernel") or name.endswith("lm_head.bias"):
        return int(np.prod(pl.full_shape))
    return p.numel() * (pl.fsdp if pl.fsdp_dim is not None else 1)


def rank_bytes(name):
    """{part: bytes} a rank of the recipe's own mesh holds."""
    cfg, cards, _ = RECIPES[name]
    config = _recipe(name)
    mesh = resolve_mesh_shape(config.train.mesh, cards)
    k = config.model.num_layers_unfrozen
    model = _sharded(cfg, mesh, k)
    params = dict(model.named_parameters())
    train = trainable_mask(model, cfg, k)
    branch = [n for n in params if n.startswith(tuple(
        [f"transformer.h_{i}." for i in range(cfg.n_layer - k, cfg.n_layer)]
        + ["transformer.ln_f.", "transformer.lm_head."]))]
    out = {
        "masters": 4 * sum(p.numel() for p in params.values()),
        "moments": 8 * sum(params[n].numel() for n in train),
        "grads": 4 * sum(params[n].numel() for n in train),
        "branch": 4 * sum(params[n].numel() for n in branch),
        "copies": 2 * sum(_copy_numel(model, n, params[n]) for n in list(params) + branch),
    }
    if config.model.reward_model_path:  # the same architecture, placed by the same rules
        out["rm_masters"] = out["masters"]
        out["rm_copies"] = 2 * sum(_copy_numel(model, n, p) for n, p in params.items() if ".lm_head." not in n)
    return mesh, out


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_fits_an_h100_a_rank(name):
    """The recipe's mesh as written, on its cards: what a rank holds stays
    under half an H100 (40 GB), the other half the headroom for the
    activations of remat'd steps, the rollout's KV cache and the allocator;
    and the model is the published one (its f32 masters, whole)."""
    cfg, cards, limit = RECIPES[name]
    mesh, parts = rank_bytes(name)
    assert int(np.prod(mesh)) == cards
    model = _sharded(cfg, mesh, 2)
    whole = 4 * sum(int(np.prod(placement_of(model, n).full_shape)) for n, _ in model.named_parameters())
    assert whole > (22e9 if cfg is GPTJ_6B else 80e9)  # ~6.05 B / ~20.6 B f32
    total = sum(parts.values())
    assert total < limit, f"{name} on {mesh}: {total / 1e9:.2f} GB a rank {parts}"


def test_neox_20b_reward_recipe_parts():
    """ppo_neox20b_rm on [1, 8, 4, 1] (32 ranks): the parts a rank holds,
    reckoned from the shapes. The held bf16 copies, gathered over fsdp and
    split only over tp, outweigh every f32 part together: about a quarter
    of two NeoX-20B trunks in bf16 (2 x 41.2 GB / 4)."""
    mesh, parts = rank_bytes("ppo_neox20b_rm")
    assert mesh == (1, 8, 4, 1)
    gb = {k: v / 1e9 for k, v in parts.items()}
    assert 2.5 < gb["masters"] < 2.7 and 2.5 < gb["rm_masters"] < 2.7  # 20.6 B x 4 B / 32
    assert gb["copies"] + gb["rm_copies"] > sum(gb[k] for k in ("masters", "moments", "grads", "branch",
                                                                "rm_masters"))
    assert 20.0 < gb["copies"] + gb["rm_copies"] < 24.0


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_every_large_param_is_sharded(name):
    """No tensor of at least d_model² elements falls through the rules to
    full replication on the recipe's mesh: each is split over fsdp or tp."""
    cfg, cards, _ = RECIPES[name]
    mesh = resolve_mesh_shape(_recipe(name).train.mesh, cards)
    model = _sharded(cfg, mesh, 2)
    offenders = []
    for n, p in model.named_parameters():
        pl = placement_of(model, n)
        full = int(np.prod(pl.full_shape)) if pl is not None else p.numel()
        if full >= cfg.d_model ** 2 and (pl is None or (pl.fsdp_dim is None and pl.tp_dim is None)):
            offenders.append(n)
    assert not offenders, f"large replicated params: {offenders}"
