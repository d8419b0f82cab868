"""Single-token flash-decode attention over the KV cache: the CUDA kernels
(``csrc/decode_attn.cu``), their plain PyTorch versions, and the routing
rules.

Counterpart of ``trlx_tpu.ops.decode_attention``. One wrapper per Pallas
kernel, each with its own ``launches`` counter:

- ``decode_attention``: bf16 cache [B, T, h, d] (``_kernel_plain``);
- ``decode_attention_int8``: int8 cache with f32 per-key scales [B, T, h]
  (``_kernel_quant``);
- ``paged_decode_attention``: one shared bf16 pool [n_blocks, bs, h, d] read
  through per-slot block tables [S, bps] (``_paged_kernel_plain``);
- ``paged_decode_attention_int8``: the int8 pool with scales
  [n_blocks, bs, h] (``_paged_kernel_quant``).

``decode_attention`` and ``paged_decode_attention`` take optional ``ks`` /
``vs`` and hand an int8 cache to the int8 wrapper. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

import torch

from trlx_tpu_torch.ops import cuda_lib

KERNEL_HEAD_DIMS = (64, 128, 256)
# Keys per split of the kernels' split-T walk (csrc/decode_attn.cu: KS).
SPLIT_KEYS = 128


def decode_attn_eligible(n_head: int, head_dim: int) -> bool:
    """The JAX package's shape rule for the decode kernels (the caller adds
    the device condition)."""
    return head_dim % 128 == 0 and n_head % 8 == 0


def paged_decode_eligible(n_head: int, head_dim: int, block_size: int, blocks_per_slot: int, quant: bool) -> bool:
    """The JAX package's shape rule for the block-table kernels: the decode
    head layout, and a 128-divisible block size unless a slot is one block.
    ``quant`` stays in the signature as part of the routing key (the caller
    adds the device condition)."""
    del quant
    if not decode_attn_eligible(n_head, head_dim):
        return False
    return block_size % 128 == 0 or blocks_per_slot == 1


def decode_attention_plain(q, k_cache, v_cache, bias_row, *, scale: float, ks=None, vs=None):
    """The Pallas kernel's math in f32 over the whole cache: scores
    q . K^T * scale (* ks) + bias, p = exp(scores - max), l = sum p,
    out = sum (p (* vs)) . V / l. q: [B, h, d]; k/v: [B, T, h, d], int8 when
    the per-key scales ks/vs [B, T, h] are given; bias_row: [B, T] (0 valid /
    -1e9 masked). Returns [B, 1, h, d] in q's dtype."""
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), k_cache.float()) * scale
    if ks is not None:
        scores = scores * ks.float().transpose(1, 2)
    scores = scores + bias_row.float()[:, None, :]
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if vs is not None:
        p = p * vs.float().transpose(1, 2)
    out = torch.einsum("bhk,bkhd->bhd", p, v_cache.float()) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)[:, None]


def gather_pool(pool, block_tables):
    """The virtual view of a paged pool: [n_blocks, bs, ...] through tables
    [S, bps] → [S, bps * bs, ...]."""
    S, bps = block_tables.shape
    return pool[block_tables.long()].reshape((S, bps * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, bias_row, *, scale: float, ks=None, vs=None):
    """``decode_attention_plain`` over the slots' virtual caches gathered
    through their block tables (``pool[tbl]``)."""
    def g(x):
        return None if x is None else gather_pool(x, block_tables)

    return decode_attention_plain(q, g(k_pool), g(v_pool), bias_row, scale=scale, ks=g(ks), vs=g(vs))


def _check_rows(name, x):
    """K/V rows are read 16 bytes per lane: unit last stride, strides in
    multiples of 16 bytes, a 16-byte aligned start."""
    if x.stride(-1) != 1 or any(s * x.element_size() % 16 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit last stride, strides that are multiples of 16 bytes and a 16-byte "
                         f"aligned start (got {tuple(x.stride())})")


def _partials(B, h, d, T, device):
    """Scratch for the split partials [B, h, splits, d + 2] f32 (acc, m and
    l of each split of SPLIT_KEYS keys), which the merge kernel reads."""
    return torch.empty((B, h, -(-T // SPLIT_KEYS), d + 2), dtype=torch.float32, device=device)


def _query(q, fn):
    B, h, d = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{fn} kernel takes a bfloat16 query")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{fn} kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    qc = q.contiguous()
    if qc.data_ptr() % 16:
        raise ValueError(f"{fn}: the query needs a 16-byte aligned start")
    return qc


def _scales(ks, vs, shape, fn):
    if ks is None or vs is None:
        raise ValueError(f"{fn} takes both ks and vs")
    if ks.shape != shape or vs.shape != shape:
        raise ValueError(f"{fn}: scale shapes {tuple(ks.shape)}/{tuple(vs.shape)}, expected {shape}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError(f"{fn} takes float32 scales")
    return (*ks.stride(), *vs.stride())


def decode_attention(q, k_cache, v_cache, bias_row, *, scale: float, ks=None, vs=None):
    """Single-token attention of q [B, h, d] over the cache [B, T, h, d]
    with one additive f32 bias row [B, T]. Returns [B, 1, h, d] in q's
    dtype. With per-key scales ks/vs [B, T, h] the cache is int8 and
    ``decode_attention_int8`` runs. CPU tensors take the plain version;
    CUDA tensors launch the bf16 kernel (head_dim 64/128/256, any T) or
    raise."""
    if ks is not None or vs is not None:
        return decode_attention_int8(q, k_cache, v_cache, ks, vs, bias_row, scale=scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, bias_row, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, h, d = q.shape
    T = k_cache.shape[1]
    if k_cache.shape != (B, T, h, d) or v_cache.shape != (B, T, h, d):
        raise ValueError(f"decode_attention: cache shapes {k_cache.shape}/{v_cache.shape} do not match q {q.shape}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16):
        raise TypeError("decode_attention kernel takes a bfloat16 query and cache")
    qc = _query(q, "decode_attention")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check_rows(f"decode_attention: {name}", x)
    bias = bias_row.to(dtype=torch.float32).contiguous()
    out = torch.empty((B, h, d), dtype=q.dtype, device=q.device)
    part = _partials(B, h, d, T, q.device)
    ks_, vs_ = k_cache.stride(), v_cache.stride()
    err = cuda_lib.lib().decode_attn_bf16(
        qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), bias.data_ptr(), out.data_ptr(), part.data_ptr(),
        part.shape[2], B, T, h, d, ks_[0], ks_[1], ks_[2], vs_[0], vs_[1], vs_[2], float(scale),
        cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "decode_attn_bf16")
    cuda_lib.count_launch(decode_attention)
    return out[:, None]


def decode_attention_int8(q, k_cache, v_cache, ks, vs, bias_row, *, scale: float):
    """``decode_attention`` over an int8 cache [B, T, h, d] with f32 per-key
    scales ks/vs [B, T, h] (any strides), the dequantisation folded into the
    attention algebra. CPU tensors take the plain version; CUDA tensors
    launch the int8 kernel or raise."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, bias_row, scale=scale, ks=ks, vs=vs)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8: unsupported device {q.device}")
    B, h, d = q.shape
    T = k_cache.shape[1]
    if k_cache.shape != (B, T, h, d) or v_cache.shape != (B, T, h, d):
        raise ValueError(f"decode_attention_int8: cache shapes {k_cache.shape}/{v_cache.shape} do not match "
                         f"q {q.shape}")
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise TypeError("decode_attention_int8 kernel takes an int8 cache")
    qc = _query(q, "decode_attention_int8")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check_rows(f"decode_attention_int8: {name}", x)
    sstrides = _scales(ks, vs, (B, T, h), "decode_attention_int8")
    bias = bias_row.to(dtype=torch.float32).contiguous()
    out = torch.empty((B, h, d), dtype=q.dtype, device=q.device)
    part = _partials(B, h, d, T, q.device)
    err = cuda_lib.lib().decode_attn_int8(
        qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ks.data_ptr(), vs.data_ptr(), bias.data_ptr(),
        out.data_ptr(), part.data_ptr(), part.shape[2], B, T, h, d, *k_cache.stride()[:3], *v_cache.stride()[:3],
        *sstrides, float(scale), cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "decode_attn_int8")
    cuda_lib.count_launch(decode_attention_int8)
    return out[:, None]


def _paged_operands(q, k_pool, v_pool, block_tables, bias_row, fn, dtype):
    S, h, d = q.shape
    n_blocks, bs = k_pool.shape[:2]
    bps = block_tables.shape[1]
    if k_pool.shape != (n_blocks, bs, h, d) or v_pool.shape != (n_blocks, bs, h, d):
        raise ValueError(f"{fn}: pool shapes {k_pool.shape}/{v_pool.shape} do not match q {q.shape}")
    if block_tables.shape != (S, bps) or bias_row.shape != (S, bps * bs):
        raise ValueError(f"{fn}: tables {tuple(block_tables.shape)} / bias {tuple(bias_row.shape)} do not match "
                         f"{S} slots of {bps} blocks of {bs}")
    if bs % SPLIT_KEYS and bps != 1:
        raise ValueError(f"{fn} kernel reads each split of {SPLIT_KEYS} keys from one pool block: it takes a block "
                         f"size divisible by {SPLIT_KEYS} or one block a slot (got {bps} blocks of {bs})")
    if k_pool.dtype != dtype or v_pool.dtype != dtype:
        raise TypeError(f"{fn} kernel takes a {dtype} pool")
    qc = _query(q, fn)
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool)):
        _check_rows(f"{fn}: {name}", x)
    tables = block_tables.to(dtype=torch.int32).contiguous()
    bias = bias_row.to(dtype=torch.float32).contiguous()
    out = torch.empty((S, h, d), dtype=q.dtype, device=q.device)
    part = _partials(S, h, d, bps * bs, q.device)
    return qc, tables, bias, out, part, (S, bs, bps, h, d)


def paged_decode_attention(q, k_pool, v_pool, block_tables, bias_row, *, scale: float, ks=None, vs=None):
    """Single-token attention through per-slot block tables. q: [S, h, d];
    k_pool/v_pool: [n_blocks, bs, h, d], the one shared pool; block_tables:
    [S, bps] int, slot s's virtual key t at pool[tbl[s, t // bs], t % bs];
    bias_row: [S, bps * bs] over the virtual cache. Returns [S, 1, h, d] in
    q's dtype. With scales ks/vs [n_blocks, bs, h] the pool is int8 and
    ``paged_decode_attention_int8`` runs. CPU tensors take the plain
    version; CUDA tensors launch the bf16 kernel or raise: the kernel takes
    the block sizes of ``paged_decode_eligible`` (divisible by 128, or one
    block a slot). The tables must hold block ids below n_blocks (the
    engine's allocator guarantees it)."""
    if ks is not None or vs is not None:
        return paged_decode_attention_int8(q, k_pool, v_pool, ks, vs, block_tables, bias_row, scale=scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables, bias_row, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    qc, tables, bias, out, part, dims = _paged_operands(q, k_pool, v_pool, block_tables, bias_row,
                                                        "paged_decode_attention", torch.bfloat16)
    err = cuda_lib.lib().paged_decode_attn_bf16(
        qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(), bias.data_ptr(), out.data_ptr(),
        part.data_ptr(), part.shape[2], *dims, *k_pool.stride()[:3], *v_pool.stride()[:3], float(scale),
        cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "paged_decode_attn_bf16")
    cuda_lib.count_launch(paged_decode_attention)
    return out[:, None]


def paged_decode_attention_int8(q, k_pool, v_pool, ks_pool, vs_pool, block_tables, bias_row, *, scale: float):
    """``paged_decode_attention`` over an int8 pool with f32 per-token
    scales [n_blocks, bs, h] (any strides). CPU tensors take the plain
    version; CUDA tensors launch the int8 kernel or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables, bias_row, scale=scale, ks=ks_pool,
                                            vs=vs_pool)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_int8: unsupported device {q.device}")
    qc, tables, bias, out, part, dims = _paged_operands(q, k_pool, v_pool, block_tables, bias_row,
                                                        "paged_decode_attention_int8", torch.int8)
    sstrides = _scales(ks_pool, vs_pool, tuple(k_pool.shape[:3]), "paged_decode_attention_int8")
    err = cuda_lib.lib().paged_decode_attn_int8(
        qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks_pool.data_ptr(), vs_pool.data_ptr(),
        tables.data_ptr(), bias.data_ptr(), out.data_ptr(), part.data_ptr(), part.shape[2], *dims,
        *k_pool.stride()[:3], *v_pool.stride()[:3], *sstrides, float(scale), cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "paged_decode_attn_int8")
    cuda_lib.count_launch(paged_decode_attention_int8)
    return out[:, None]


def _mask_bias(slot_mask):
    return torch.where(slot_mask.bool(), 0.0, -1e9).to(torch.float32)


def slot_decode_attention(q, k_cache, v_cache, slot_mask, *, scale: float, ks=None, vs=None):
    """The engine's entry: the per-slot cache-validity mask [S, T] (1 = a
    valid key) becomes the additive bias row of ``decode_attention``."""
    return decode_attention(q, k_cache, v_cache, _mask_bias(slot_mask), scale=scale, ks=ks, vs=vs)


def paged_slot_decode_attention(q, k_pool, v_pool, block_tables, slot_mask, *, scale: float, ks=None, vs=None):
    """The engine's paged entry: the virtual-cache validity mask
    [S, bps * bs] becomes the bias row of ``paged_decode_attention``."""
    return paged_decode_attention(q, k_pool, v_pool, block_tables, _mask_bias(slot_mask), scale=scale, ks=ks,
                                  vs=vs)


decode_attention.launches = 0
decode_attention_int8.launches = 0
paged_decode_attention.launches = 0
paged_decode_attention_int8.launches = 0
