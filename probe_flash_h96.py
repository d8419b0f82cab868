#!/usr/bin/env python3
"""A/B probe of flash rows 1h-3h (``trlx_tpu_torch/csrc/flash_fwd.cu`` and
``flash_bwd.cu`` at head_dim 96, GPT-NeoX-20B's heads) on one NVIDIA GPU:
this checkout's package against the same package of other checkouts (for
example an earlier commit's, from ``git archive`` unpacked into a directory
that ``.gitignore`` lists), each built from its own sources and called
through its own wrappers. The inputs, tolerances, timers and bounds are
``chip_smoke.py``'s (``phase_flash`` and ``phase_flash_bwd`` at
[8, 1024, 64, 96], rows left-padded to seeded prompt lengths).

- every version's forward, dq and dk/dv against the plain versions within
  the smoke's tolerances, and two calls of each bit-equal;
- device ms by CUDA events in alternating turns (two versions: A B B A ...;
  more: in order, then reversed), six a version, of the forward, dq and
  dk/dv at [8, 1024, 64, 96] and, as the unchanged control, of rows 1-3 at
  GPT-J-6B's [8, 1024, 16, 256]; the median and every turn; beside them
  SDPA's forward and backward with the same boolean mask, and the bounds.

``--check`` times nothing: this version's ptxas lines of the flash kernels
and ``chip_smoke.phase_flash_h96_modes`` (rows 1h-3h in every mode at
ragged T, left padding and a wholly masked row).

    python3 probe_flash_h96.py OTHER_DIR [MORE_DIRS ...] [--out=PATH]
    python3 probe_flash_h96.py --check [--out=PATH]

Prints the card's name and power limit, one line per measurement, and last
one JSON object, also written to ``--out`` (by default
``probe_flash_h96.json``). Exits non-zero when no CUDA device is visible or
a check fails.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
TURNS = 6
SHAPES = ((8, 1024, 64, 96), (8, 1024, 16, 256))  # NeoX-20B's heads; GPT-J-6B's (the control)


def log(msg):
    print(msg, flush=True)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_other(root, tag):
    """The other checkout's ``ops/flash_attention.py``, calling its own
    kernel library: its ``ops/cuda_lib.py`` builds its own flash sources
    (and the headers) into a library of the flash entries alone."""
    ops = os.path.join(os.path.abspath(root), "trlx_tpu_torch", "ops")
    lib = load_module(os.path.join(ops, "cuda_lib.py"), f"{tag}_cuda_lib")
    every = lib._sources
    lib._sources = lambda: [p for p in every() if os.path.basename(p).startswith("flash_") or p.endswith(".cuh")]
    lib._SIGNATURES = {k: v for k, v in lib._SIGNATURES.items() if k.startswith("flash_")}
    fa = load_module(os.path.join(ops, "flash_attention.py"), f"{tag}_flash_attention")
    fa.cuda_lib = lib
    lib.lib()
    return fa


def turn_order(names, turns):
    """Alternating turns: A B B A A B ... for two versions; in order, then
    reversed, for more."""
    if len(names) == 2:
        return [names[(t // 2 + t % 2) % 2] for t in range(2 * turns)]
    return [n for r in range(turns) for n in (names if r % 2 == 0 else names[::-1])]


def inputs(smoke, shape, gen):
    """``phase_flash_bwd``'s inputs: q, k, v, the left-padded key mask, the
    cotangents on the valid rows, and delta from this checkout's forward."""
    from trlx_tpu_torch.ops.flash_attention import flash_fwd

    b, T, h, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    lens = torch.randint(smoke.MIN_PROMPT + 256, T + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(T, device="cuda")[None, :] >= (T - lens)[:, None]).float()
    rows = mask.bool()
    o, lse = flash_fwd(q, k, v, mask, scale=d ** -0.5)
    do = (torch.randn(shape, generator=gen, device="cuda") * rows[:, :, None, None]).to(torch.bfloat16)
    dlse = torch.randn((b, h, T), generator=gen, device="cuda") * rows[:, None, :]
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2) - dlse).contiguous()
    return dict(q=q, k=k, v=v, mask=mask, rows=rows, o=o, lse=lse, do=do, dlse=dlse, delta=delta)


def calls(mod, x, d):
    """The three kernels of a version as zero-argument calls."""
    scale = d ** -0.5
    args = (x["q"], x["k"], x["v"], x["mask"], x["do"], x["lse"], x["delta"])
    return {
        "fwd": lambda: mod.flash_fwd(x["q"], x["k"], x["v"], x["mask"], scale=scale),
        "dq": lambda: mod.flash_bwd_dq(*args, scale=scale, window=0),
        "dkv": lambda: mod.flash_bwd_dkv(*args, scale=scale, window=0),
    }


def check_version(smoke, name, mod, x, ref, d):
    """A version's three kernels against the plain versions, each called
    twice; returns the errors."""
    got = {k: fn() for k, fn in calls(mod, x, d).items()}
    again = {k: fn() for k, fn in calls(mod, x, d).items()}
    for key in got:
        a, b = (got[key] if isinstance(got[key], tuple) else (got[key],)), (
            again[key] if isinstance(again[key], tuple) else (again[key],))
        if not all(torch.equal(u, w) for u, w in zip(a, b)):
            raise AssertionError(f"{name} {key} d={d}: a second call differs from the first")
    rows = x["rows"]
    errs = {"o": smoke.check(f"{name} o d={d}", got["fwd"][0][rows], ref["o"][rows], 2e-2)}
    errs["dq"] = smoke.check_rel(f"{name} dq d={d}", got["dq"][rows], ref["dq"][rows], 2e-2)[0]
    errs["dk"] = smoke.check_rel(f"{name} dk d={d}", got["dkv"][0], ref["dk"], 2e-2)[0]
    errs["dv"] = smoke.check_rel(f"{name} dv d={d}", got["dkv"][1], ref["dv"], 2e-2)[0]
    return errs


def measure(smoke, shape, versions, gen):
    """One shape: every version checked, then timed in alternating turns."""
    from trlx_tpu_torch.ops.flash_attention import flash_attention_bwd_plain, flash_attention_plain

    b, T, h, d = shape
    x = inputs(smoke, shape, gen)
    scale = d ** -0.5
    ref = {"o": flash_attention_plain(x["q"], x["k"], x["v"], x["mask"], scale=scale)}
    ref["dq"], ref["dk"], ref["dv"] = flash_attention_bwd_plain(x["q"], x["k"], x["v"], x["mask"], x["o"], x["lse"],
                                                                x["do"], x["dlse"], scale=scale)
    rec = {"shape": list(shape)}
    for name, mod in versions.items():
        rec[f"{name}_max_abs_err"] = check_version(smoke, name, mod, x, ref, d)
    del ref
    torch.cuda.empty_cache()
    times = {name: {k: [] for k in ("fwd", "dq", "dkv")} for name in versions}
    for name in turn_order(list(versions), TURNS):
        for key, fn in calls(versions[name], x, d).items():
            times[name][key].append(smoke.time_ms(fn))
        log(f"[time] {shape} {name}: " + ", ".join(f"{k} {t[-1]:.4f} ms" for k, t in times[name].items()))
    for name, t in times.items():
        for key, turns in t.items():
            rec[f"{name}_{key}_ms"] = statistics.median(turns)
            rec[f"{name}_{key}_ms_turns"] = turns
    qt, kt, vt = (x[n].transpose(1, 2).detach().requires_grad_() for n in ("q", "k", "v"))
    amask = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()[None, None] & x["rows"][:, None, None, :]
    rec["sdpa_fwd_ms"] = smoke.time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, scale=scale))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, scale=scale)
    dot = x["do"].transpose(1, 2)
    rec["sdpa_bwd_ms"] = smoke.time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
    pairs = b * h * T * (T + 1) / 2
    one = b * T * h * d * 2
    rowvec = b * h * T * 4
    rec["fwd_bound"] = smoke.bound(4 * one + rowvec + b * T * 4, 4 * d * pairs)
    rec["dq_bound"] = smoke.bound(5 * one + 2 * rowvec + b * T * 4, 6 * d * pairs)
    rec["dkv_bound"] = smoke.bound(6 * one + 2 * rowvec + b * T * 4, 8 * d * pairs)
    log(f"[shape] {json.dumps(rec)}")
    del x, out
    torch.cuda.empty_cache()
    return rec


def main(argv):
    if not torch.cuda.is_available():
        print("probe_flash_h96.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from trlx_tpu_torch.ops import cuda_lib
    from trlx_tpu_torch.ops import flash_attention as this

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    cuda_lib.lib()
    build = cuda_lib.build_log()
    for ln in build.split("== flash_bwd.cu", 1)[-1].split("\n== ")[0].splitlines() + \
            build.split("== flash_fwd.cu", 1)[-1].split("\n== ")[0].splitlines():
        if any(w in ln for w in ("Compiling entry function", "registers", "spill", "Performance Loss", "error")):
            log(f"[build] {ln.strip()}")
    out = {"device": torch.cuda.get_device_name(0), "smi": smi,
           "ptxas": [smoke.ptxas_report(build, k) for k in smoke.H96_KERNELS.values()]}
    log(f"[ptxas] {json.dumps(out['ptxas'])}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--check" in argv:
        out["modes"] = smoke.phase_flash_h96_modes(gen)
        log(f"[modes] {json.dumps(out['modes'])}")
    else:
        others = [a for a in argv if not a.startswith("--")]
        if not others:
            print("probe_flash_h96.py: name another checkout to compare with, or --check", file=sys.stderr)
            return 2
        versions = {os.path.basename(os.path.normpath(root)): load_other(root, f"v{i}") for i, root in enumerate(others)}
        versions["this"] = this
        out["versions"] = {name: os.path.abspath(root) for name, root in zip(versions, others + [ROOT])}
        out["shapes"] = [measure(smoke, shape, versions, gen) for shape in SHAPES]
    path = next((a.split("=", 1)[1] for a in argv if a.startswith("--out=")), "probe_flash_h96.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
