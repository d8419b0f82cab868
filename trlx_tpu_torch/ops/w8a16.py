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

On a sharded mesh (``parallel.sharding``) a Dense's master is this rank's
piece, and its int8 copy has the shape the decode product reads: the
tp-local kernel whole over fsdp (the LM head: the whole kernel, as its bf16
copy is). The scale is per output column over the whole K, so the column
absmax of the rows this rank holds is first all-reduced (max) over each
axis that splits K (tp for the row-parallel attention output and MLP
output, fsdp for the column-parallel products); the codes of the piece are
then gathered over fsdp (and, for the head, over tp), with the scales of an
axis that splits the columns. Each rank's codes and scales are the slice of
the whole master's quantization, bit for bit. Every rank quantizes the same
kernels in module order, so the collectives line up.
"""

import torch

from trlx_tpu_torch.ops import cuda_lib

QUANT_KERNEL_NAMES = ("c_qkv", "q_proj", "k_proj", "v_proj", "c_proj", "c_fc", "lm_head")
# The kernel's tilings (csrc/w8a16_gemm.cu): K a chunk, weight columns a
# tile (128, or 64: a narrow swap tile, at x tiles of at most 64 rows), the
# x rows a tile takes, and the CTAs a K split may use (one cluster: at most
# the portable 8).
BK, WG_COLS, NARROW_COLS = 64, 128, 64
BX_SIZES = (8, 32, 64, 128)
WIDE_BX = 256  # x rows a tile of the wide kernel (two warpgroups of 64 columns)
SPLITS = tuple(range(1, 9))

_CLUSTERS = {}
_SMS = {}


def quantize_channels(w: torch.Tensor):
    """(int8 codes, f32 scales [out]) of a kernel [in, out]: symmetric per
    output channel, scale = max(max|w| / 127, 1e-8), codes rounded half to
    even (the JAX package's ``quantize_weights``, bit for bit)."""
    wf = w.detach().float()
    scale = torch.clamp(wf.abs().amax(dim=0) / 127.0, min=1e-8)
    return torch.round(wf / scale).to(torch.int8), scale


def quantize_dense(name: str, mod: torch.nn.Module):
    """(int8 codes, f32 scales) of the Dense ``mod`` (``name`` its module
    path): ``quantize_channels`` of its kernel, or on a sharded mesh the
    slice of the whole master's quantization its decode product reads (the
    module docstring). Collective where the kernel is split."""
    w = mod.kernel
    pl = getattr(mod, "placement", {}).get("kernel")
    if pl is None or (pl.fsdp_dim is None and pl.tp_dim is None):
        return quantize_channels(w)
    from trlx_tpu_torch.parallel import collectives as coll
    from trlx_tpu_torch.parallel.mesh import AXIS_FSDP, AXIS_TP, get_mesh

    mesh = get_mesh()
    fsdp, tp = mesh.group(AXIS_FSDP), mesh.group(AXIS_TP)
    wf = w.detach().float()
    amax = wf.abs().amax(dim=0)
    # The column max over the whole K: over the axes that split K.
    if pl.fsdp_dim == 0:
        amax = coll.all_reduce(amax, fsdp, op="max")
    if pl.tp_dim == 0:
        amax = coll.all_reduce(amax, tp, op="max")
    scale = torch.clamp(amax / 127.0, min=1e-8)
    codes = torch.round(wf / scale).to(torch.int8)
    if pl.fsdp_dim is not None:
        codes = coll.all_gather(codes, fsdp, pl.fsdp_dim)
        if pl.fsdp_dim == 1:
            scale = coll.all_gather(scale, fsdp, 0)
    if name.rpartition(".")[2] == "lm_head" and pl.tp_dim is not None:
        # The head decodes from its whole, on every tp rank.
        codes = pl.join_tp(coll.all_gather(codes, tp, pl.tp_dim).chunk(tp.size, dim=pl.tp_dim))
        if pl.tp_dim == 1:
            scale = torch.cat(coll.all_gather(scale, tp, 0).chunk(tp.size, dim=0))
    return codes.contiguous(), scale.contiguous()


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
        kq, scale = quantize_dense(name, mod)
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


def tile_rows(M: int) -> int:
    """x rows a tile of the kernel takes: the least of ``BX_SIZES`` that
    holds M, else the largest."""
    return next((b for b in BX_SIZES if M <= b), BX_SIZES[-1])


def tile_cols(bx: int):
    """Weight columns a swap tile of ``bx`` x rows may take."""
    return (WG_COLS, NARROW_COLS) if bx <= 64 else (WG_COLS,)


def plan(M: int, N: int, K: int, sms: int, clusters: dict):
    """(bx, cols, wgs, splits, grid) of one launch: x rows a tile, weight
    columns a tile, warpgroups a tile's 128 weight columns (2: the wide
    kernel), CTAs splitting K (one cluster a tile) and CTAs along the tiles.
    M > 64 with a tile of WIDE_BX rows for every SM: the wide kernel on a
    persistent grid of one CTA an SM. Otherwise the swap kernel, at the tile
    width and split that give the busiest SM the fewest weight bytes: one CTA
    an SM, ``clusters[cols, s]`` clusters of s CTAs at once (the device's
    count for the tiling, ``max_clusters``), split s of a tile taking K
    chunks [s kc / S, (s + 1) kc / S); ties go to the wider tile, then the
    smaller split. Unsplit, the grid walks the tiles persistently."""
    kchunks = -(-K // BK)
    bx = tile_rows(M)
    if bx == BX_SIZES[-1] and -(-M // WIDE_BX) * -(-N // WG_COLS) >= sms:
        return WIDE_BX, WG_COLS, 2, 1, sms
    row_tiles = -(-M // bx)

    def cost(cols_s):
        cols, s = cols_s
        at_once = sms if s == 1 else clusters.get((cols, s), 0)
        tiles = row_tiles * -(-N // cols)
        busiest = -(-tiles // at_once) * -(-kchunks // s) * cols if at_once > 0 else float("inf")
        return busiest, -cols, s

    cols, splits = min(((c, s) for c in tile_cols(bx) for s in SPLITS if s <= kchunks), key=cost)
    tiles = row_tiles * -(-N // cols)
    return bx, cols, 1, splits, tiles if splits > 1 else min(tiles, sms)


def max_clusters(device, bx: int) -> dict:
    """{(cols, s): clusters of s CTAs of the swap kernel's tiling with x
    tiles of ``bx`` rows and tiles of ``cols`` weight columns that the card
    runs at once} for s = 2 .. 8 (a card's GPCs hold whole clusters, so fewer
    than sms // s may fit), asked of the device once."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if (idx, bx) not in _CLUSTERS:
        lib = cuda_lib.lib()
        _CLUSTERS[idx, bx] = {(c, s): lib.w8a16_max_clusters(bx, c, s) for c in tile_cols(bx) for s in SPLITS[1:]}
    return _CLUSTERS[idx, bx]


def launch_plan(M: int, N: int, K: int, device):
    """``plan`` of a launch on ``device``: its SMs and cluster counts."""
    return plan(M, N, K, _sm_count(device), max_clusters(device, tile_rows(M)))


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
    if x2.data_ptr() % 16:  # TMA reads from a 16-byte aligned start
        x2 = x2.clone()
    M = x2.shape[0]
    sc = scale.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    bx, cols, wgs, splits, grid = launch_plan(M, N, K, x.device)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = cuda_lib.lib().w8a16_gemm(
        x2.data_ptr(), kq.data_ptr(), sc.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        M, N, K, bx, cols, wgs, splits, grid, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, "w8a16_gemm")
    cuda_lib.count_launch(w8a16_matmul, cost=lambda: (2 * M * N * K, M * K * 2 + K * N + 8 * N + M * N * 2))
    return y.reshape(tuple(x.shape[:-1]) + (N,))


w8a16_matmul.launches = 0
