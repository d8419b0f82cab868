"""W8A16 decode weights: the int8-weight product (``csrc/w8a16_gemm.cu``),
its plain PyTorch version, and the per-output-channel quantizer.

Counterpart of ``trlx_tpu.models.lm`` ``QDense`` with the ``qw`` collection
and ``quantize_weights``. On the TPU, XLA fuses the int8 -> bf16 convert
into the dot's operand load, so the JAX package has no Pallas kernel here;
eager PyTorch would write a bf16 copy of the weight on every call, so the
port's product is a kernel of its own that reads the int8 bytes once.

- ``w8a16_matmul(x, kq, scale, bias)``: ``round(x . kq) * scale (+ bias)``
  in x's dtype. A CPU tensor takes ``w8a16_plain``; a CUDA tensor launches
  the kernel (bf16 x, K % 8 == 0, N % 16 == 0) or raises.
- ``quantize_weights(module)``: an int8 copy of every Dense kernel named in
  ``QUANT_KERNEL_NAMES`` (the trunk's products and an untied ``lm_head``),
  kept on the Dense (``Dense.w8``) and re-quantized in place when its master
  changes, so a captured decode graph reads the new codes.
"""

import torch

from trlx_tpu_torch.ops import cuda_lib

QUANT_KERNEL_NAMES = ("c_qkv", "q_proj", "k_proj", "v_proj", "c_proj", "c_fc", "lm_head")
# The kernel's tilings (csrc/w8a16_gemm.cu): rows a CTA for decode and for
# larger M, columns and K a CTA step. Decode splits K until SPLIT_TARGET CTAs
# per SM stream the weight.
BM_DECODE, BM_LARGE, BN, BK = 16, 128, 128, 64
DECODE_MAX_M = 32
SPLIT_TARGET = 2

_SMS = {}


def quantize_channels(w: torch.Tensor):
    """(int8 codes, f32 scales [out]) of a kernel [in, out]: symmetric per
    output channel, scale = max(max|w| / 127, 1e-8), codes rounded half to
    even (the JAX package's ``quantize_weights``, bit for bit)."""
    wf = w.detach().float()
    scale = torch.clamp(wf.abs().amax(dim=0) / 127.0, min=1e-8)
    return torch.round(wf / scale).to(torch.int8), scale


def quantize_weights(module: torch.nn.Module) -> int:
    """Give every Dense of ``module`` named in ``QUANT_KERNEL_NAMES`` its
    int8 copy ``w8 = [key, codes, scales]``, or bring a stale one up to date
    IN PLACE (the buffers keep their addresses). A copy is stale when the
    master kernel's (``_version``, address) is not the one it was made
    from. Returns the number of kernels (re)quantized."""
    n = 0
    for name, mod in module.named_modules():
        if name.rpartition(".")[2] not in QUANT_KERNEL_NAMES or not hasattr(mod, "kernel"):
            continue
        w = mod.kernel
        key = (w._version, w.data_ptr())
        held = getattr(mod, "w8", None)
        if held is not None and held[0] == key:
            continue
        kq, scale = quantize_channels(w)
        if held is None:
            mod.w8 = [key, kq, scale]
        else:
            held[1].copy_(kq)
            held[2].copy_(scale)
            held[0] = key
        n += 1
    return n


def quantized_weights(module: torch.nn.Module) -> dict:
    """{Dense name: (codes, scales)} of the int8 copies ``module`` holds."""
    return {name: (mod.w8[1], mod.w8[2]) for name, mod in module.named_modules()
            if getattr(mod, "w8", None) is not None}


def w8a16_plain(x, kq, scale, bias=None):
    """QDense's arithmetic: the product in f32, rounded to x's dtype, times
    the scale in x's dtype, plus the bias in x's dtype."""
    dt = x.dtype
    y = (x.float() @ kq.float()).to(dt) * scale.to(dt)
    if bias is not None:
        y = y + bias.to(dt)
    return y


def plan(M: int, N: int, K: int, sms: int):
    """(bm, splits, per) of one launch: the tiling by M, and for decode
    (M <= DECODE_MAX_M) K split so that at least SPLIT_TARGET CTAs per SM
    stream the weight where K has the chunks; each split takes ``per`` BK
    chunks of K."""
    kchunks = -(-K // BK)
    bm = BM_DECODE if M <= DECODE_MAX_M else BM_LARGE
    tiles = -(-N // BN) * -(-M // bm)
    per = kchunks
    if bm == BM_DECODE:
        per = max(1, kchunks // -(-SPLIT_TARGET * sms // tiles))
    return bm, -(-kchunks // per), per


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def w8a16_matmul(x, kq, scale, bias=None):
    """``round(x . kq) * scale (+ bias)`` for x [..., K], kq int8 [K, N],
    scale f32 [N], bias [N] or None; [..., N] in x's dtype. CPU tensors take
    ``w8a16_plain``; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return w8a16_plain(x, kq, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_matmul: unsupported device {x.device}")
    K, N = kq.shape
    if x.dtype != torch.bfloat16 or kq.dtype != torch.int8:
        raise TypeError(f"w8a16 kernel takes bfloat16 x and int8 kq, got {x.dtype} and {kq.dtype}")
    if x.shape[-1] != K or tuple(scale.shape) != (N,) or (bias is not None and tuple(bias.shape) != (N,)):
        raise ValueError(f"w8a16_matmul: x {tuple(x.shape)}, kq {tuple(kq.shape)}, scale {tuple(scale.shape)}")
    if K % 8 or N % 16:
        raise ValueError(f"w8a16 kernel takes K % 8 == 0 and N % 16 == 0, got K={K}, N={N}")
    if not kq.is_contiguous() or kq.data_ptr() % 16:
        raise ValueError("w8a16_matmul: kq must be contiguous with a 16-byte aligned start")
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:  # rows are read 16 bytes a lane
        x2 = x2.clone()
    M = x2.shape[0]
    sc = scale.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    bm, splits, per = plan(M, N, K, _sm_count(x.device))
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    err = cuda_lib.lib().w8a16_gemm(
        x2.data_ptr(), kq.data_ptr(), sc.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, bm, splits, per, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, "w8a16_gemm")
    w8a16_matmul.launches += 1
    return y.reshape(tuple(x.shape[:-1]) + (N,))


w8a16_matmul.launches = 0
