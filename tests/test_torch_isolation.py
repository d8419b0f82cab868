"""The port stands alone: ``trlx_tpu_torch``, ``chip_smoke.py``,
``profile_torch_decode.py`` and the ``probe_*.py`` scripts import nothing of JAX,
Flax, Optax or the JAX package, and the port's entry points refuse a CUDA device where there is
none instead of dropping to the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "trlx_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "trlx_tpu")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[: -len(".py")]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_module_imports_without_jax():
    """A fresh interpreter with jax/flax/optax poisoned and a finder that
    refuses the JAX package imports every module of the port."""
    code = f"""
import importlib, importlib.abc, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "trlx_tpu" or name.startswith("trlx_tpu."):
            raise ImportError("the port imported " + name)
        return None
sys.meta_path.insert(0, Refuse())
for mod in {_port_modules()!r}:
    importlib.import_module(mod)
leaked = [m for m in sys.modules if m == "trlx_tpu" or m.startswith("trlx_tpu.")]
assert not leaked, leaked
print("ok", len({_port_modules()!r}))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_ast_scan_finds_no_forbidden_import():
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py", "profile_torch_decode.py", "probe_f32_head.py",
                                             "probe_w8a16.py", "probe_randomwalks.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f) if _forbidden(m)]
    assert not bad, bad


def test_no_transformers_or_safetensors_outside_the_tokenizer():
    """The port reads and writes HF checkpoints itself: no module imports
    ``safetensors``, and ``transformers`` is imported only inside
    ``_build_tokenizer`` (a tokenizer path given), never at import time nor
    on the load or export path. The examples' reward and metric functions
    run an HF sentiment classifier (the user's reward, not the port's load
    path): they import ``transformers`` inside a function, never at import
    time."""
    found = []
    for dirpath, _, names in os.walk(PKG):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)

            def visit(node, fn):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = node.name
                names_ = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                    [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
                found.extend((os.path.relpath(path, ROOT), fn, m) for m in names_
                             if m.split(".")[0] in ("transformers", "safetensors", "huggingface_hub"))
                for child in ast.iter_child_nodes(node):
                    visit(child, fn)

            visit(ast.parse(open(path).read(), filename=path), None)
    examples = [f for f in found if f[0].startswith(os.path.join("trlx_tpu_torch", "examples") + os.sep)]
    lib = [f for f in found if f not in examples]
    assert lib and all(f[1] == "_build_tokenizer" and f[2] == "transformers" for f in lib), lib
    assert examples and all(f[1] is not None and f[2] == "transformers" for f in examples), examples


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here; the refusal path cannot be exercised")
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.device import resolve_device
    from trlx_tpu_torch.models.heads import LMWithValueHead
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    cfg = TRLConfig.from_dict({
        "model": dict(model_path="", model_arch=dict(vocab_size=11, n_layer=1, n_head=2, d_model=8)),
        "train": dict(total_steps=1, seq_length=8, epochs=1, batch_size=2, lr_ramp_steps=1, lr_decay_steps=1,
                      weight_decay=0.0, learning_rate_init=1e-4, learning_rate_target=1e-4),
        "method": dict(name="ppoconfig", gen_kwargs=dict(prompt_length=4, max_length=8)),
    })
    with pytest.raises(RuntimeError, match="CUDA"):
        PPOTrainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        trlx_tpu_torch.train(reward_fn=lambda s: [0.0] * len(s), prompts=[[1, 2]], config=cfg)
    trainer = PPOTrainer(cfg, device="cpu")
    assert trainer.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        LMWithValueHead(trainer.model.cfg)
