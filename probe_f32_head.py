#!/usr/bin/env python3
"""Probe of the fused head's f32 mode on one NVIDIA GPU: rebuilds the two
fused-logprob sources (``trlx_tpu_torch/csrc/fused_logprob.cu`` and
``fused_logprob_bwd.cu``) with constants of the 3xTF32 mainloop
(``csrc/logprob_gemm_tf32.cuh``) or of the backward set as given, and for
each build measures, at the Q heads' shape (N = 4092, D = 8192, V = 50400,
untied, with bias):

- the forward's (logprob, lse, entropy) against ``naive_logprob`` (f32,
  TF32 off), max |d| / max(1, |ref|);
- the backward's dx, dW and db against the plain backward, max |d| / max |ref|;
- the device ms (CUDA events) of the forward, of the ds + dx chunk calls
  and of the dW/db call of one backward (x transposed into its scratch, the
  dW kernel, the db merge), in alternating turns (first build to last, then
  back), beside ``torch.matmul`` f32 of xᵀ·ds (TF32 off), dW's yardstick.

    python3 probe_f32_head.py "" TG_GROUP=256 DW_GROUP_M=64 "drop:transpose_f32_kernel<<<"

Each argument is one build, of space-separated settings (none: the sources
as they are): NAME=VALUE sets one ``constexpr int`` constant of the header
or of ``fused_logprob_bwd.cu``; ``drop:TEXT`` deletes every line of those
two files that contains TEXT, to time the kernels without one piece of their
work (their results are then wrong, and only the times mean anything).
TG_GROUP = 256 sums each tile's whole D = 8192 reduction (256 chunks) in one
tensor-core accumulator: no promotion. DW_GROUP_M = 64 walks dW's tiles as
the bf16 dW kernel does (every x panel fastest, the ds panel slowest). Builds
go to ``trlx_tpu_torch/csrc/_build/probe/`` (gitignored). Prints the card's
name and power limit, one line per build and turn, and last one JSON object
of the results. Exits non-zero when no CUDA device is visible.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N, D, V = 4 * 1023, 8192, 50400
SEED = 17


def build(settings: str, out: str):
    """The two sources with ``settings`` applied, compiled for sm_90a into
    ``out``/lib.so; returns (ctypes handle, ptxas lines of the f32 kernels)."""
    from trlx_tpu_torch.ops import cuda_lib

    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_lib._CSRC, out, ignore=shutil.ignore_patterns("_build"))
    paths = [os.path.join(out, f) for f in ("logprob_gemm_tf32.cuh", "fused_logprob_bwd.cu")]
    srcs = {path: open(path).read() for path in paths}
    for item in settings.split():
        hits = 0
        for path, src in srcs.items():
            if item.startswith("drop:"):
                kept = [ln for ln in src.splitlines(keepends=True) if item[5:] not in ln]
                hits += len(src.splitlines()) - len(kept)
                srcs[path] = "".join(kept)
            else:
                name, value = item.split("=")
                srcs[path], n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};",
                                        src)
                hits += n
        if hits == 0:
            raise ValueError(f"{item!r} matches nothing in logprob_gemm_tf32.cuh or fused_logprob_bwd.cu")
    for path, src in srcs.items():
        open(path, "w").write(src)
    nvcc = cuda_lib._nvcc()
    procs = [subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, "-I", out, "-c", os.path.join(out, f), "-o",
                               os.path.join(out, f + ".o")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for f in ("fused_logprob.cu", "fused_logprob_bwd.cu")]
    log = ""
    for p in procs:
        log += p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError(log)
    so = os.path.join(out, "lib.so")
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                    os.path.join(out, "fused_logprob.cu.o"), os.path.join(out, "fused_logprob_bwd.cu.o"), "-o", so],
                   check=True)
    handle = ctypes.CDLL(so)
    for name, argtypes in cuda_lib._SIGNATURES.items():
        if name.startswith("fused_logprob"):
            getattr(handle, name).argtypes = argtypes
            getattr(handle, name).restype = ctypes.c_int
    lines, keep = log.splitlines(), []
    for i, ln in enumerate(lines):
        name = re.search(r"((?:logprob|transpose)_\w*?f32_kernelI?L?b?\d?)", ln)
        if "Compiling entry function" in ln and name:
            keep.append(name.group(1) + ": " + " ".join(x.strip() for x in lines[i + 1:i + 3]))
        if "Performance Loss" in ln:
            keep.append(ln.strip())
    return handle, keep


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_f32_head: torch.cuda.is_available() is False; this probe needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from trlx_tpu_torch.ops import cuda_lib
    from trlx_tpu_torch.ops import fused_logprob as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    builds = sys.argv[1:] or [""]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = {}
    for i, settings in enumerate(builds):
        libs[settings], ptxas = build(settings, os.path.join(cuda_lib._BUILD_ROOT, "probe", str(i)))
        for ln in ptxas:
            print(f"[build {settings or 'as is'}] {ln}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.relu(torch.randn((N, D), generator=gen, device="cuda"))
    w = torch.randn((D, V), generator=gen, device="cuda") * (3.5 * D ** -0.5)
    b = torch.randn((V,), generator=gen, device="cuda") * 0.1
    y = torch.randint(0, V, (N,), generator=gen, device="cuda", dtype=torch.int32)
    cts = [torch.randn((N,), generator=gen, device="cuda") * 0.1 for _ in range(3)]
    ref = fl.naive_logprob(x, w, y, b)
    ref_b = fl.fused_logprob_bwd_plain(x, w, b, y, ref[1], ref[2], *cts)
    results = {}
    for settings in builds:
        cuda_lib._state["lib"] = libs[settings]
        got = fl.fused_logprob_fwd_f32(x, w, y, b)
        grads = fl.fused_logprob_bwd(x, w, b, y, ref[1], ref[2], *cts)
        torch.cuda.synchronize()
        fwd = {n: float(((g - r).abs() / r.abs().clamp(min=1.0)).max()) for n, g, r in zip(("lp", "lse", "ent"), got, ref)}
        bwd = {n: float((g - r).abs().max() / r.abs().max()) for n, g, r in zip(("dx", "dw", "db"), grads, ref_b)}
        results[settings or "as is"] = {"fwd_scaled_err": fwd, "bwd_rel_err": bwd, "fwd_ms": [], "ds_dx_ms": [],
                                        "dw_ms": []}
        print(f"[{settings or 'as is'}] forward scaled errors {fwd}; backward errors / max |ref| {bwd}", flush=True)
        del got, grads
    del ref_b
    torch.cuda.empty_cache()

    ldv = -(-V // fl._DS_LD) * fl._DS_LD
    ds = torch.empty((-(-N // 128) * 128, ldv), device="cuda")
    dx = torch.empty((N, D), device="cuda")
    dbpart = torch.empty((-(-N // 128), V), device="cuda")
    dw, db = torch.empty((D, V), device="cuda"), torch.empty((V,), device="cuda")
    vecs = [ref[1], ref[2], *cts]

    def ds_dx():
        for c0 in range(0, N, fl.BWD_CHUNK_ROWS):
            fl.fused_logprob_bwd_dx_f32(x[c0:], w, b, y[c0:], [v[c0:] for v in vecs], ds[c0:], dbpart[c0 // 128:],
                                        dx[c0:], rows=min(fl.BWD_CHUNK_ROWS, N - c0), C=fl.BWD_CHUNK_ROWS, ldv=ldv,
                                        tied=False)

    def dw_db():
        fl.fused_logprob_bwd_dw_f32(x, ds, dw, rows=N, V=V, ldv=ldv, tied=False, dbpart=dbpart, db=db)

    flops = 2 * N * D * V
    matmul_ms = []
    for turn, order in enumerate((builds, builds[::-1])):
        for settings in order:
            cuda_lib._state["lib"] = libs[settings]
            f_ms = time_ms(lambda: fl.fused_logprob_fwd_f32(x, w, y, b), iters=3)
            b_ms = time_ms(ds_dx, iters=3)
            w_ms = time_ms(dw_db, iters=3)
            r = results[settings or "as is"]
            r["fwd_ms"].append(f_ms)
            r["ds_dx_ms"].append(b_ms)
            r["dw_ms"].append(w_ms)
            print(f"[{settings or 'as is'}] turn {turn}: forward {f_ms:.3f} ms ({flops / f_ms / 1e9:.1f} TFLOP/s), "
                  f"ds + dx {b_ms:.3f} ms ({2 * flops / b_ms / 1e9:.1f} TFLOP/s), dW/db {w_ms:.3f} ms "
                  f"({flops / w_ms / 1e9:.1f} TFLOP/s)", flush=True)
        matmul_ms.append(time_ms(lambda: torch.matmul(x.t(), ds[:N, :V]), iters=3))
        print(f"[torch.matmul] turn {turn}: f32 x^T . ds {matmul_ms[-1]:.3f} ms", flush=True)
    print(json.dumps({"device": smi, "shape": [N, D, V], "builds": results, "dw_matmul_ms": matmul_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
