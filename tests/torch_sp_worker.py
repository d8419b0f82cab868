"""The port's side of the sequence-parallel tests, run in this process over a
``LocalSpGroup`` mesh or as one rank of a gloo group (imports torch and the
port only, so a rank starts in seconds):

    python tests/torch_sp_worker.py MODE RANK WORLD INIT_FILE IN OUT

MODE ``ring`` runs ``ring_cases`` on the data in IN (``torch.save`` of a
dict of numpy arrays and settings) and ``torch.save``s its results to OUT;
MODE ``train`` runs ``train_case``; MODE ``dist`` runs the case of
``tests/torch_dist_case.py`` that ``data["case"]`` names. The group joins
through a ``file://`` store (INIT_FILE), never a TCP port; torchrun's
``LOCAL_WORLD_SIZE`` and ``GROUP_RANK`` may come from the caller's
environment (several nodes simulated on one machine).
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from trlx_tpu_torch.models.lm import LMConfig, TransformerLM, ring_eligible  # noqa: E402
from trlx_tpu_torch.parallel import ring_attention as ring_mod  # noqa: E402
from trlx_tpu_torch.parallel.mesh import set_mesh  # noqa: E402


def _t(x, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.requires_grad_() if grad else t


def _op(mesh, d, **kw):
    """(output, grads of sum(sin(out) * qvalid)) of ``ring_attention_sharded``."""
    q, k, v = (_t(d[n], grad=True) for n in ("q", "k", "v"))
    mask = _t(d["mask"])
    qvalid = _t(d["qvalid"])
    out = ring_mod.ring_attention_sharded(q, k, v, mask, scale=float(d["scale"]), mesh=mesh, **kw)
    grads = torch.autograd.grad((torch.sin(out) * qvalid).sum(), (q, k, v))
    return {"out": out.detach().numpy(), "grads": [g.numpy() for g in grads]}


def _model(mesh, d, base, ids, mask, remat=False, sp=None):
    """(logits, grads of sum(tanh(logits) * fmask) by parameter name) of the
    ring model built for the mesh's sp size (or for ``sp``: 0 is local)."""
    set_mesh(mesh)
    cfg = LMConfig(**base, sp_size=mesh.shape["sp"] if sp is None else sp, remat=remat)
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict({n: _t(p) for n, p in d["params"].items()}, strict=True)
    ids_t, mask_t = _t(ids), _t(mask)
    fmask = mask_t[:, :, None].float()
    logits = model(ids_t, mask_t)["logits"]
    loss = (torch.tanh(logits) * fmask).sum()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return {"logits": logits.detach().numpy(), "grads": {n: g.numpy() for n, g in zip(names, grads)}}


def ring_cases(mesh, data):
    """Every case of ``tests/test_torch_ring_attention.py`` on ``mesh``."""
    n = mesh.shape["sp"]
    out = {}
    out["op"] = _op(mesh, data["op"])
    out["flash"] = _op(mesh, data["flash"], use_flash=True)
    out["zigzag"] = _op(mesh, data["layouts"], layout="zigzag")
    out["contiguous"] = _op(mesh, data["layouts"], layout="contiguous")
    out["noncausal"] = _op(mesh, data["layouts"], layout="contiguous", causal=False)
    out["window"] = _op(mesh, data["window"], window=int(data["window"]["window"]), layout="zigzag")
    m = data["model"]
    out["model"] = _model(mesh, m, m["base"], m["ids"], m["mask"])
    out["model_local"] = _model(mesh, m, m["base"], m["ids"], m["mask"], sp=0)
    # remat re-runs each block's ring (its collectives too) in the backward;
    # T = 60 takes the contiguous layout on 4 ranks, whose dead chunks keep
    # their rotations in the graph.
    out["model_remat"] = _model(mesh, m, m["base"], m["ids"], m["mask"], remat=True)
    out["model_60"] = _model(mesh, m, m["base"], m["ids"][:, :60], m["mask"][:, :60])
    out["model_60_remat"] = _model(mesh, m, m["base"], m["ids"][:, :60], m["mask"][:, :60], remat=True)
    cfg = LMConfig(sp_size=n)
    out["eligible"] = [ring_eligible(cfg, 64, has_cache=False), ring_eligible(cfg, 64, has_cache=True),
                       ring_eligible(cfg, 63, has_cache=False), ring_eligible(LMConfig(sp_size=0), 64, False)]
    # The zig-zag body's live half-pair attends, by the rank that made them.
    live = [0] * n
    rule = ring_mod.half_pair_live

    def counting(cq, ck, c, window=0):
        ok = rule(cq, ck, c, window)
        live[min(cq, 2 * n - 1 - cq)] += int(ok)
        return ok

    ring_mod.half_pair_live = counting
    try:
        _op(mesh, data["layouts"], layout="zigzag")
    finally:
        ring_mod.half_pair_live = rule
    out["live_pairs"] = live
    return out


def _init(rank: int, world: int, init_file: str):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)


def main():
    mode, rank, world, init_file, in_path, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    _init(rank, world, init_file)
    data = torch.load(in_path, weights_only=False)
    if mode == "ring":
        from trlx_tpu_torch.parallel.mesh import make_mesh

        result = ring_cases(make_mesh((1, 1, 1, world)), data)
    elif mode == "train":
        from torch_sp_train_case import train_case

        result = train_case(data)
    elif mode == "dist":
        from torch_dist_case import dist_case

        result = dist_case(data)
    else:
        raise ValueError(mode)
    torch.save(result, out_path)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def launch(mode: str, world: int, data, tmp_dir: str, timeout: float, env_by_rank=None, tag: str = "",
           first: int = None):
    """Run ``world`` ranks of MODE on ``data``, rank r with the extra
    environment ``env_by_rank[r]`` (all killed once ``timeout`` seconds
    have passed; with ``first``, the others killed as soon as rank
    ``first`` has ended). Returns, by rank, (exit code or None when killed,
    its output, its result or None)."""
    import subprocess
    import time

    os.makedirs(tmp_dir, exist_ok=True)
    name = f"{mode}{tag}{world}"
    in_path = os.path.join(tmp_dir, f"{name}.in")
    torch.save(data, in_path)
    init_file = os.path.join(tmp_dir, f"{name}.store")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.path.dirname(os.path.abspath(__file__)),
               OMP_NUM_THREADS="1")
    env.pop("TRLX_TPU_FAULTS", None)
    procs = []
    for r in range(world):
        log = open(os.path.join(tmp_dir, f"{name}.rank{r}.log"), "w")
        cmd = [sys.executable, os.path.abspath(__file__), mode, str(r), str(world), init_file, in_path,
               os.path.join(tmp_dir, f"{name}.rank{r}.out")]
        procs.append((subprocess.Popen(cmd, env=dict(env, **((env_by_rank or {}).get(r, {}))), stdout=log,
                                       stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    if first is not None:
        try:
            procs[first][0].wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        deadline = time.monotonic()
    codes = []
    for p, log in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
            codes.append(p.returncode)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(None)
        log.close()
    out = []
    for r, code in enumerate(codes):
        with open(os.path.join(tmp_dir, f"{name}.rank{r}.log")) as f:
            text = f.read()
        res = os.path.join(tmp_dir, f"{name}.rank{r}.out")
        out.append((code, text, torch.load(res, weights_only=False) if code == 0 and os.path.exists(res) else None))
    return out


def spawn(mode: str, world: int, data, tmp_dir: str, timeout: float, env_by_rank=None, tag: str = ""):
    """Run ``world`` ranks of MODE on ``data`` (all killed once ``timeout``
    seconds have passed); returns their results by rank. A rank that fails or hangs
    fails the caller with its output."""
    runs = launch(mode, world, data, tmp_dir, timeout, env_by_rank, tag)
    failed = [f"rank {r}: " + ("timed out" if code is None else f"exit {code}")
              for r, (code, _, _) in enumerate(runs) if code != 0]
    if failed:
        tails = [f"--- rank {r}\n" + text[-3000:] for r, (_, text, _) in enumerate(runs)]
        raise AssertionError("; ".join(failed) + "\n" + "\n".join(tails))
    return [res for _, _, res in runs]


if __name__ == "__main__":
    main()
