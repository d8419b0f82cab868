"""Flash attention, forward and backward: the CUDA kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), their plain PyTorch
versions, the autograd Function that joins them, and the routing rule.

Counterpart of ``trlx_tpu.ops.flash_attention`` (its ``_flash_lse`` custom
VJP). The wrappers take the plain versions for tensors on the CPU and launch
the kernels for CUDA tensors — they never fall back from one to the other.
"""

import torch

from trlx_tpu_torch.ops import cuda_lib

MASK_VAL = -1e9
KERNEL_HEAD_DIMS = (64, 128, 256)


def auto_flash_ok(q_len: int) -> bool:
    """The auto-routing shape rule of the JAX package: a long 128-aligned
    sequence (the caller adds the device condition)."""
    return q_len >= 256 and q_len % 128 == 0


def _reachable(T: int, window: int, device) -> torch.Tensor:
    """[T, T] bool: key j is reachable from query i by position alone."""
    qi = torch.arange(T, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    reach = kj <= qi
    if window > 0:
        reach = reach & (kj > qi - window)
    return reach


def _masked_scores(q, k, kv_mask, scale: float, window: int):
    """f32 [b, h, T, T] scores with masked entries REPLACED by -1e9 (the
    kernels' rule, shared by the forward and the backward)."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = _reachable(T, window, q.device)[None, None] & (kv_mask.float() > 0.5)[:, None, None, :]
    return torch.where(valid, s, torch.full_like(s, MASK_VAL))


def flash_attention_plain(q, k, v, kv_mask, *, scale: float, window: int = 0, return_lse: bool = False):
    """The kernel's function with a materialized [b, h, T, T] score matrix:
    f32 scores, masked scores REPLACED by -1e9, softmax, probabilities in the
    value dtype.

    Rows whose keys are all masked by ``kv_mask`` (left padding) get uniform
    weights here over all T keys, while the kernel spreads them over the key
    tiles it visits: the two agree on every row with at least one valid key,
    which is every row whose own mask is 1."""
    s = _masked_scores(q, k, kv_mask, scale, window)
    lse = torch.logsumexp(s, dim=-1)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)
    return (o, lse) if return_lse else o


def flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, dlse, *, scale: float, window: int = 0):
    """The backward kernels' function: P recomputed from ``lse`` with the
    forward's masking, ``delta = rowsum(dO·O) − dlse``, then
    dq = (P⊙(dP − δ))·K·scale, dk = (P⊙(dP − δ))ᵀ·Q·scale, dv = Pᵀ·dO, with
    P and dS rounded to the operand dtype before their products, as the
    TPU kernels round them. Returns (dq, dk, dv) in q/k/v's dtypes.

    Padded query rows (every key masked) have P = 1 on every key here and on
    the key tiles the kernels visit: the two agree where such rows carry no
    cotangent (dO = dlse = 0), which is the case in the model, where no
    later position reads them."""
    p = torch.exp(_masked_scores(q, k, kv_mask, scale, window) - lse.float()[..., None])
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * o.float()).sum(-1).transpose(1, 2) - dlse.float()  # [b, h, T]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_strided(name: str, x: torch.Tensor):
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {name} needs a unit last stride, strides that are multiples of 8 "
            f"and a 16-byte aligned start (got strides {tuple(x.stride())})"
        )


def _check_kernel_inputs(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes bfloat16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_strided(name, x)


def _strides(q, k, v):
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])


def flash_fwd(q, k, v, kv_mask, *, scale: float, window: int = 0):
    """The forward kernel on CUDA tensors: (o [b, T, h, d] bf16, lse
    [b, h, T] f32). Raises on what the kernel does not take."""
    _check_kernel_inputs(q, k, v)
    b, T, h, d = q.shape
    kmask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    o = torch.empty((b, T, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, T), dtype=torch.float32, device=q.device)
    err = cuda_lib.lib().flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kmask.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, T, h, d, *_strides(q, k, v), float(scale), int(window), cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_fwd_bf16")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, kmask, do, lse, delta, *, scale: float, window: int):
    """The dq kernel: dq [b, T, h, d] bf16 from contiguous dO and the f32
    [b, h, T] lse and delta."""
    b, T, h, d = q.shape
    dq = torch.empty((b, T, h, d), dtype=q.dtype, device=q.device)
    err = cuda_lib.lib().flash_bwd_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), kmask.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, T, h, d, *_strides(q, k, v), float(scale), int(window),
        cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_bwd_dq_bf16")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, kmask, do, lse, delta, *, scale: float, window: int):
    """The dk/dv kernel: (dk, dv) [b, T, h, d] bf16."""
    b, T, h, d = q.shape
    dk = torch.empty((b, T, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, T, h, d), dtype=v.dtype, device=q.device)
    err = cuda_lib.lib().flash_bwd_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), kmask.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, T, h, d, *_strides(q, k, v), float(scale),
        int(window), cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_bwd_dkv_bf16")
    flash_bwd_dkv.launches += 1
    return dk, dv


for _fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _fn.launches = 0


def flash_attention_bwd(q, k, v, kv_mask, o, lse, do, dlse, *, scale: float, window: int = 0):
    """(dq, dk, dv) of the fused attention. CPU tensors take
    ``flash_attention_bwd_plain``; CUDA tensors form ``delta`` with torch
    ops (as the JAX package forms it outside Pallas) and launch the dq and
    dk/dv kernels, or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, dlse, scale=scale, window=window)
    _check_kernel_inputs(q, k, v)
    do = do.to(q.dtype).contiguous()
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2) - dlse.float()).contiguous()
    kmask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    lse = lse.float().contiguous()
    dq = flash_bwd_dq(q, k, v, kmask, do, lse, delta, scale=scale, window=window)
    dk, dv = flash_bwd_dkv(q, k, v, kmask, do, lse, delta, scale=scale, window=window)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """(o, lse) with the flash backward: saves q, k, v, kv_mask, o and lse;
    the backward takes the cotangents of both outputs. On the CPU the same
    Function runs the plain forward and the plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, window):
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, kv_mask, scale=scale, window=window, return_lse=True)
        else:
            o, lse = flash_fwd(q, k, v, kv_mask, scale=scale, window=window)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.scale, ctx.window = scale, window
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do
        dlse = torch.zeros_like(lse) if dlse is None else dlse
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, o, lse, do, dlse, scale=ctx.scale, window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, kv_mask, *, scale: float, window: int = 0, return_lse: bool = False):
    """Fused causal attention over [b, T, n_head, head_dim] inputs.

    kv_mask: [b, T] key-slot validity (0 at left padding). ``window > 0``
    restricts keys to the trailing window. The JAX kernel's key ``offset``
    (ring attention) is not ported yet. Returns o [b, T, h, d] in
    q's dtype, and with ``return_lse`` also the f32 log-sum-exp [b, h, T].

    Differentiable through ``FlashAttentionFn`` whenever grad is enabled and
    q, k or v requires it. CPU tensors take the plain versions; CUDA tensors
    launch the kernels (bf16, head_dim 64/128/256, any T) or raise."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = FlashAttentionFn.apply(q, k, v, kv_mask, float(scale), int(window))
    elif q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, scale=scale, window=window, return_lse=return_lse)
    else:
        o, lse = flash_fwd(q, k, v, kv_mask, scale=scale, window=window)
    return (o, lse) if return_lse else o
