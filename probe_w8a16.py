#!/usr/bin/env python3
"""A/B probe of the W8A16 product (row W8, ``trlx_tpu_torch/csrc/w8a16_gemm.cu``
through ``ops.w8a16.w8a16_matmul``) on one NVIDIA GPU: this checkout's package
against the same package of other checkouts (for example an earlier commit's,
from ``git archive`` unpacked into a directory that ``.gitignore`` lists), each
built from its own sources and called through its own wrapper. The inputs,
tolerance, timers and bound are ``chip_smoke.py``'s.

At GPT-J-6B's decode products (M = 8, the (K, N) of ``chip_smoke.W8_SHAPES``)
and its prefill products (M = 6144: 8 prompts of 768):

- every version's result against ``w8a16_plain`` within
  ``chip_smoke.w8_tolerance``, and two calls bit-equal;
- device ms in alternating turns (two versions: A B B A A B ...; more: in
  order, then reversed, ...), six a version: decode shapes as replays of a
  CUDA graph of 50 calls (``chip_smoke.graph_ms``) with the weight L2-warm
  (one weight) and cold (the calls rotate through
  ``chip_smoke.w8_cold_copies`` weights, so the 50 MB L2 holds none of the
  next call's), prefill shapes by CUDA events (``chip_smoke.time_ms``); the
  median of the turns and every turn; beside them ``torch.matmul`` of x and
  the weight in bf16 (warm and cold) and ``chip_smoke.bound``.

``--check`` times nothing: it holds this version against the plain one at
the edges of every tiling (x tiles of 8 to 256 rows, both tile widths, K
split or not, ragged M, N and K), two graph replays of each decode shape
bit-equal to the eager call, and 20 calls of each prefill shape bit-equal.

    python3 probe_w8a16.py OTHER_DIR [MORE_DIRS ...] [--out=PATH]
    python3 probe_w8a16.py --check [--out=PATH]

Prints the card's name and power limit, ptxas's lines of the W8 kernels, the
cluster counts ``plan`` reads, one line per measurement, and last one JSON
object, also written to ``--out`` (by default ``probe_w8a16.json``). Exits
non-zero when no CUDA device is visible or a check fails.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PREFILL_M = 6144
PREFILL_KN = ((4096, 16384), (4096, 4096), (16384, 4096))
TURNS = 6
CHECK_M = (1, 8, 13, 32, 33, 40, 64, 65, 200, 255, 256, 1000, 1669)
CHECK_KN = ((64, 16), (200, 400), (4096, 1040), (200, 8208), (4096, 4096), (256, 16384))
PREFILL_REPEATS = 20


def log(msg):
    print(msg, flush=True)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_other(root, tag):
    """The other checkout's ``ops/w8a16.py``, calling its own kernel
    library: its ``ops/cuda_lib.py`` builds its own ``csrc/w8a16_gemm.cu``
    (and the headers) into a library of the W8 entries alone."""
    ops = os.path.join(os.path.abspath(root), "trlx_tpu_torch", "ops")
    lib = load_module(os.path.join(ops, "cuda_lib.py"), f"{tag}_cuda_lib")
    every = lib._sources
    lib._sources = lambda: [p for p in every() if os.path.basename(p).startswith("w8a16") or p.endswith(".cuh")]
    lib._SIGNATURES = {k: v for k, v in lib._SIGNATURES.items() if k.startswith("w8a16")}
    w8 = load_module(os.path.join(ops, "w8a16.py"), f"{tag}_w8a16")
    w8.cuda_lib = lib
    lib.lib()
    return w8


def launch_of(mod, M, K, N):
    """The launch a version's wrapper makes (its ``launch_plan``, or the
    parent's ``plan`` of the card's SMs)."""
    if hasattr(mod, "launch_plan"):
        return list(mod.launch_plan(M, N, K, torch.device("cuda")))
    return list(mod.plan(M, N, K, torch.cuda.get_device_properties(0).multi_processor_count))


def check_one(smoke, name, matmul, x, kq, scale, bias, calls=2):
    """max |y - plain| and its tolerance; raises when outside it or when one
    of ``calls`` calls differs from the first."""
    from trlx_tpu_torch.ops.w8a16 import w8a16_plain

    y = matmul(x, kq, scale, bias)
    torch.cuda.synchronize()
    ref = w8a16_plain(x, kq, scale, bias)
    tol = smoke.w8_tolerance(ref)
    err = smoke.check(name, y, ref, tol)
    for i in range(1, calls):
        if not torch.equal(y, matmul(x, kq, scale, bias)):
            raise AssertionError(f"{name}: call {i + 1} differs from the first")
    return err, tol


def graph_replays_equal(matmul, x, kq, scale, bias):
    """Two replays of a graph of one call give the eager call's bits."""
    eager = matmul(x, kq, scale, bias)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        matmul(x, kq, scale, bias)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = matmul(x, kq, scale, bias)
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(first, out) and torch.equal(first, eager)


def check_edges(smoke, w8a16, decode):
    """This version at the edges of every tiling, the decode shapes' graph
    replays and the prefill shapes' repeated calls; the names that failed."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    failed = []
    prefill = [(PREFILL_M, k, n) for k, n in PREFILL_KN]
    cases = [(M, K, N, 2) for M in CHECK_M for K, N in CHECK_KN] + [(65, 200, 33808, 2)]
    cases += [(M, K, N, PREFILL_REPEATS) for M, K, N in prefill]
    for M, K, N, calls in cases:
        x, [(kq, scale)], bias = smoke.w8_inputs(M, K, N, gen)
        for b in (bias, None):
            name = f"M={M} K={K} N={N} bias={b is not None} plan={launch_of(w8a16, M, K, N)}"
            try:
                err, tol = check_one(smoke, name, w8a16.w8a16_matmul, x, kq, scale, b, calls)
                log(f"[check] {name}: ok {err:.3g} <= {tol:.3g}, {calls} calls bit-equal")
            except Exception as e:  # noqa: BLE001 - report every failing shape, then fail
                failed.append(name)
                log(f"[check] {name}: FAILED {e}")
    for M, K, N in decode + [(40, 4096, 4096), (13, 200, 400)]:
        x, [(kq, scale)], bias = smoke.w8_inputs(M, K, N, gen)
        ok = graph_replays_equal(w8a16.w8a16_matmul, x, kq, scale, bias)
        log(f"[check] graph M={M} K={K} N={N} plan={launch_of(w8a16, M, K, N)}: two replays and the eager call "
            f"bit-equal: {ok}")
        if not ok:
            failed.append(f"graph M={M} K={K} N={N}")
    return failed


def turn_order(names, turns):
    """Alternating turns: A B B A A B ... for two versions; in order, then
    reversed, for more."""
    if len(names) == 2:
        return [names[(t // 2 + t % 2) % 2] for t in range(2 * turns)]
    return [n for r in range(turns) for n in (names if r % 2 == 0 else names[::-1])]


def measure(smoke, M, K, N, versions, gen):
    """One shape: every version checked, then timed in alternating turns."""
    decode = M <= 32
    copies = smoke.w8_cold_copies(K, N) if decode else 1
    x, weights, bias = smoke.w8_inputs(M, K, N, gen, copies)
    kq, scale = weights[0]
    b_ms, by = smoke.bound(M * K * 2 + K * N + 8 * N + M * N * 2, 2 * M * K * N)
    rec = {"M": M, "K": K, "N": N, "timed": "graph" if decode else "events", "cold_copies": copies if decode else None,
           "bound_ms": b_ms, "bound_by": by}
    for name, mod in versions.items():
        rec[f"{name}_plan"] = launch_of(mod, M, K, N)
        rec[f"{name}_max_abs_err"], rec["tol"] = check_one(smoke, f"{name} M={M} K={K} N={N}", mod.w8a16_matmul,
                                                           x, kq, scale, bias)
    timer = smoke.graph_ms if decode else smoke.time_ms
    times = {name: {"warm": [], "cold": []} for name in versions}
    for name in turn_order(list(versions), TURNS):
        fn = versions[name].w8a16_matmul
        warm = timer(lambda: fn(x, kq, scale, bias))
        times[name]["warm"].append(warm)
        line = f"[time] M={M} K={K} N={N} {name}: warm {warm:.5f} ms"
        if decode:
            cold = timer(smoke.rotating(fn, [(x, w, s, bias) for w, s in weights]))
            times[name]["cold"].append(cold)
            line += f", cold {cold:.5f} ms"
        log(line)
    for name, t in times.items():
        rec[f"{name}_ms"] = statistics.median(t["warm"])
        rec[f"{name}_ms_turns"] = t["warm"]
        if decode:
            rec[f"{name}_cold_ms"] = statistics.median(t["cold"])
            rec[f"{name}_cold_ms_turns"] = t["cold"]
    wb = [w.to(torch.bfloat16) for w, _ in weights]
    rec["matmul_ms"] = timer(lambda: torch.matmul(x, wb[0]))
    if decode:
        rec["matmul_cold_ms"] = timer(smoke.rotating(torch.matmul, [(x, w) for w in wb]))
    log(f"[shape] {json.dumps(rec)}")
    del x, weights, wb
    torch.cuda.empty_cache()
    return rec


def main(argv):
    if not torch.cuda.is_available():
        print("probe_w8a16.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from trlx_tpu_torch.ops import cuda_lib, w8a16

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    cuda_lib.lib()
    for ln in cuda_lib.build_log().split("== w8a16_gemm.cu", 1)[-1].split("\n== ")[0].splitlines():
        if any(w in ln for w in ("Compiling entry function", "registers", "spill", "Performance Loss", "error")):
            log(f"[build] {ln.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    decode = [(smoke.CHUNK, k, n) for k, n in smoke.W8_SHAPES]
    clusters = {bx: {f"{c}x{s}": n for (c, s), n in w8a16.max_clusters(torch.device("cuda"), bx).items()}
                for bx in w8a16.BX_SIZES}
    out = {"device": torch.cuda.get_device_name(0), "smi": smi, "max_clusters": clusters}
    log(f"[clusters] of s CTAs at once, by x rows a tile and (weight columns a tile)x(s): {json.dumps(clusters)}")
    if "--check" in argv:
        failed = check_edges(smoke, w8a16, decode)
        out["check_failed"] = failed
    else:
        others = [a for a in argv if not a.startswith("--")]
        if not others:
            print("probe_w8a16.py: name another checkout to compare with, or --check", file=sys.stderr)
            return 2
        versions = {os.path.basename(os.path.normpath(root)): load_other(root, f"v{i}") for i, root in enumerate(others)}
        versions["this"] = w8a16
        out["versions"] = {name: os.path.abspath(root) for name, root in zip(versions, others + [ROOT])}
        gen = torch.Generator(device="cuda").manual_seed(0)
        out["shapes"] = [measure(smoke, M, K, N, versions, gen)
                         for M, K, N in decode + [(PREFILL_M, k, n) for k, n in PREFILL_KN]]
        failed = []
    path = next((a.split("=", 1)[1] for a in argv if a.startswith("--out=")), "probe_w8a16.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
