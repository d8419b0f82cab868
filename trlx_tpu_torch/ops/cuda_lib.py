"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library with
a plain C interface and loaded through ``ctypes``. The build runs at first
use, into ``csrc/_build/<hash of the sources>/`` (listed in ``.gitignore``),
so a fresh checkout builds its own kernels and a changed source rebuilds.
Nothing here runs at import time: the CPU-only test machines import every
module of the package.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from trlx_tpu_torch.observability import devicemon

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_ROOT = os.path.join(_CSRC, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_state = {"lib": None, "log": ""}

# Held while a wrapper adds to its launch count and across a graph capture
# (``ops.cuda_graph.StepGraph``), which takes back what the capture added:
# another thread's launches during a capture wait for it, so they are
# neither taken back nor replayed.
launch_lock = threading.RLock()


def count_launch(fn, n: int = 1, cost=None):
    """Add ``n`` launches to ``fn.launches`` (thread-safe). ``cost()``, given
    and called only while device telemetry counts a dispatch
    (``observability.devicemon``), returns the launch's (FLOPs, bytes)."""
    with launch_lock:
        fn.launches += n
    if cost is not None and devicemon.counting():
        devicemon.add_kernel_cost(*cost())

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name → argtypes. Every entry returns cudaGetLastError().
_SIGNATURES = {
    "flash_fwd_bf16": [_P, _P, _P, _P, _P, _P,  # q k v kmask o lse
                       _I, _I, _I, _I,  # b T h d
                       _I, _I, _I,  # q strides (b, t, h) in elements
                       _I, _I, _I,  # k strides
                       _I, _I, _I,  # v strides
                       _F, _I, _I, _I, _P],  # scale window causal offset stream
    "decode_attn_bf16": [_P, _P, _P, _P, _P,  # q k v bias o
                         _P, _I,  # split partials scratch, splits
                         _I, _I, _I, _I,  # B T h d
                         _I, _I, _I,  # k strides (b, t, h)
                         _I, _I, _I,  # v strides (b, t, h)
                         _F, _P],  # scale stream
    "decode_attn_int8": [_P, _P, _P, _P, _P, _P, _P,  # q k v ks vs bias o
                         _P, _I,  # split partials scratch, splits
                         _I, _I, _I, _I,  # B T h d
                         _I, _I, _I, _I, _I, _I,  # k v strides (b, t, h)
                         _I, _I, _I, _I, _I, _I,  # ks vs strides (b, t, h)
                         _F, _P],  # scale stream
    "paged_decode_attn_bf16": [_P, _P, _P, _P, _P, _P,  # q k v tables bias o
                               _P, _I,  # split partials scratch, splits
                               _I, _I, _I, _I, _I,  # S bs bps h d
                               _I, _I, _I, _I, _I, _I,  # k v pool strides (block, offset, h)
                               _F, _P],  # scale stream
    "paged_decode_attn_int8": [_P, _P, _P, _P, _P, _P, _P, _P,  # q k v ks vs tables bias o
                               _P, _I,  # split partials scratch, splits
                               _I, _I, _I, _I, _I,  # S bs bps h d
                               _I, _I, _I, _I, _I, _I,  # k v pool strides (block, offset, h)
                               _I, _I, _I, _I, _I, _I,  # ks vs pool strides (block, offset, h)
                               _F, _P],  # scale stream
    "fused_logprob_fwd": [_P, _P, _P, _P,  # x w(bf16) bias labels
                          _P, _P, _P,  # lp lse ent
                          _P,  # partials scratch [4, splits, N]
                          _I, _I, _I,  # N D V
                          _I, _I, _I,  # ldw (w's row stride), tied, splits
                          _P],  # stream
    "flash_bwd_dq_bf16": [_P, _P, _P, _P, _P, _P, _P, _P,  # q k v dout kmask lse delta dq
                          _I, _I, _I, _I,  # b T h d
                          _I, _I, _I, _I, _I, _I, _I, _I, _I,  # q k v strides (b, t, h)
                          _F, _I, _I, _I, _P],  # scale window causal offset stream
    "flash_bwd_dkv_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P,  # q k v dout kmask lse delta dk dv
                           _I, _I, _I, _I,  # b T h d
                           _I, _I, _I, _I, _I, _I, _I, _I, _I,  # q k v strides (b, t, h)
                           _F, _I, _I, _I, _P],  # scale window causal offset stream
    "fused_logprob_bwd_ds_dx": [_P, _P, _P, _P,  # x w(bf16) bias labels (chunk)
                                _P, _P, _P, _P, _P,  # lse ent dlp dlse dent (chunk)
                                _P, _P, _P,  # ds scratch, db partials, dx (chunk)
                                _I, _I, _I, _I, _I,  # rows D V ldv C
                                _I, _I, _I, _P],  # ldw (w's row stride), tied, splits, stream
    "fused_logprob_bwd_dw": [_P, _P, _P,  # x ds dw
                             _I, _I, _I, _I,  # rows D V ldv
                             _I,  # tied
                             _P, _P, _I,  # db partials, db (or null), row tiles
                             _I, _P],  # SMs (the persistent grid), stream
    # The f32-activation mode of the fused head (x, w, ds, dx, dW all f32).
    "fused_logprob_fwd_f32": [_P, _P, _P, _P,  # x w bias labels
                              _P, _P, _P,  # lp lse ent
                              _P,  # partials scratch [4, splits, N]
                              _I, _I, _I,  # N D V
                              _I, _I, _I,  # ldw (w's row stride), tied, splits
                              _P],  # stream
    "fused_logprob_bwd_ds_dx_f32": [_P, _P, _P, _P,  # x w bias labels (chunk)
                                    _P, _P, _P, _P, _P,  # lse ent dlp dlse dent (chunk)
                                    _P, _P, _P,  # ds scratch, db partials, dx (chunk)
                                    _I, _I, _I, _I, _I,  # rows D V ldv C
                                    _I, _I, _I, _P],  # ldw, tied, splits, stream
    "fused_logprob_bwd_dw_f32": [_P, _P, _P, _P,  # x ds, x^T scratch, dw
                                 _I, _I, _I, _I, _I,  # rows D V ldv ldr (the scratch's row stride)
                                 _I,  # tied
                                 _P, _P, _I,  # db partials, db (or null), row tiles
                                 _I, _P],  # SMs (the persistent grid), stream
    "w8a16_gemm": [_P, _P, _P, _P, _P,  # x kq scale bias(or null) y
                   _I, _I, _I,  # M N K
                   _I, _I, _I, _I, _I, _P],  # bx cols wgs splits grid, stream
    "w8a16_max_clusters": [_I, _I, _I],  # bx cols splits
}


def _sources():
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh"))
    )


def _digest() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def build() -> str:
    """Compile the kernels (if this source hash has no library yet) and
    return the shared library's path."""
    out_dir = os.path.join(_BUILD_ROOT, _digest())
    so_path = os.path.join(out_dir, "libtrlx_kernels.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_ROOT, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_ROOT) as tmp:
        procs = []
        for src in _sources():
            if not src.endswith(".cu"):
                continue
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs, objs, failed = [], [], []
        for src, obj, p in procs:
            out = p.communicate()[0].decode(errors="replace")
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode != 0:
                failed.append(src)
            objs.append(obj)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {[os.path.basename(s) for s in failed]}:\n{log}")
        tmp_so = os.path.join(tmp, "libtrlx_kernels.so")
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", *objs, "-o", tmp_so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(log)
        os.replace(tmp_so, so_path)  # atomic against a concurrent builder
    _state["log"] = log
    return so_path


def lib():
    """The loaded kernel library (built on first call)."""
    with _lock:
        if _state["lib"] is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _state["lib"] = handle
        return _state["lib"]


def build_log() -> str:
    """nvcc's output (ptxas register/spill lines) for the last build."""
    if _state["log"]:
        return _state["log"]
    path = os.path.join(_BUILD_ROOT, _digest(), "build.log")
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return ""


def check(err: int, name: str):
    """Raise if a C entry reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
