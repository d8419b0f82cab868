"""Flash attention, forward and backward: the CUDA kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), their plain PyTorch
versions, the autograd Function that joins them, and the routing rule.

Counterpart of ``trlx_tpu.ops.flash_attention`` (its ``_flash_lse`` custom
VJP). The wrappers take the plain versions for tensors on the CPU and launch
the kernels for CUDA tensors — they never fall back from one to the other.

Every function takes the JAX kernel's modes: ``causal`` (False: every key
position is reachable, subject to the window) and ``offset``, a host int
that puts key k at position k + offset of the query frame (ring attention
passes the visiting chunk's displacement). A query row that reaches no key
by position gets o = 0 and lse = ``M_INIT`` (the JAX kernel's finalisation
where a row's every key block was skipped), so a log-sum-exp combine gives
it weight 0, and the backward gives it p = 0.
"""

import numpy as np
import torch

from trlx_tpu_torch.ops import cuda_lib

MASK_VAL = -1e9
M_INIT = -1e30
DEAD_LSE = -1e29  # below this, a row's lse is M_INIT: its forward reached no key
KERNEL_HEAD_DIMS = (64, 128, 256)


def auto_flash_ok(q_len: int) -> bool:
    """The auto-routing shape rule of the JAX package: a long 128-aligned
    sequence (the caller adds the device condition)."""
    return q_len >= 256 and q_len % 128 == 0


def reachable(Tq: int, Tk: int, device, *, causal: bool = True, window: int = 0, offset: int = 0) -> torch.Tensor:
    """[Tq, Tk] bool: key j (at position j + offset of the query frame) is
    reachable from query i by position alone."""
    qi = torch.arange(Tq, device=device)[:, None]
    kp = torch.arange(Tk, device=device)[None, :] + int(offset)
    reach = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        reach = reach & (kp <= qi)
    if window > 0:
        reach = reach & (kp > qi - window)
    return reach


def _masked_scores(q, k, kv_mask, scale: float, window: int, causal: bool, offset: int):
    """(f32 [b, h, Tq, Tk] scores with masked entries REPLACED by -1e9, the
    kernels' rule shared by the forward and the backward; [Tq] bool: the
    query rows that reach a key by position)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    reach = reachable(q.shape[1], k.shape[1], q.device, causal=causal, window=window, offset=offset)
    valid = reach[None, None] & (kv_mask.float() > 0.5)[:, None, None, :]
    return torch.where(valid, s, torch.full_like(s, MASK_VAL)), reach.any(-1)


def flash_attention_plain(q, k, v, kv_mask, *, scale: float, causal: bool = True, window: int = 0, offset: int = 0,
                          return_lse: bool = False):
    """The kernel's function with a materialized [b, h, Tq, Tk] score
    matrix: f32 scores, masked scores REPLACED by -1e9, softmax,
    probabilities in the value dtype; a row that reaches no key by position
    gets o = 0 and lse = ``M_INIT``.

    Rows that reach keys but whose keys are all masked by ``kv_mask`` (left
    padding) get uniform weights here over all Tk keys, while the kernel
    spreads them over the key tiles it visits: the two agree on every row
    with at least one valid reachable key, which is every row whose own
    mask is 1 at offset 0."""
    s, live = _masked_scores(q, k, kv_mask, scale, window, causal, offset)
    lse = torch.logsumexp(s, dim=-1)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)
    if not bool(live.all()):
        o = o * live[None, :, None, None].to(o.dtype)
        lse = torch.where(live, lse, torch.full_like(lse, M_INIT))
    return (o, lse) if return_lse else o


def flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, dlse, *, scale: float, causal: bool = True,
                              window: int = 0, offset: int = 0):
    """The backward kernels' function: P recomputed from ``lse`` with the
    forward's masking, ``delta = rowsum(dO·O) − dlse``, then
    dq = (P⊙(dP − δ))·K·scale, dk = (P⊙(dP − δ))ᵀ·Q·scale, dv = Pᵀ·dO, with
    P and dS rounded to the operand dtype before their products, as the
    TPU kernels round them. A row whose lse is ``M_INIT`` (its forward
    reached no key) has P = 0. Returns (dq, dk, dv) in q/k/v's dtypes.

    Padded query rows (every reachable key masked) have P = 1 on every key
    here and on the key tiles the kernels visit: the two agree where such
    rows carry no cotangent (dO = dlse = 0), which is the case in the
    model, where no later position reads them."""
    s, _ = _masked_scores(q, k, kv_mask, scale, window, causal, offset)
    lse = lse.float()
    dead = lse <= DEAD_LSE
    p = torch.exp(s - torch.where(dead, torch.zeros_like(lse), lse)[..., None])
    p = torch.where(dead[..., None], torch.zeros_like(p), p)
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


def flash_fwd(q, k, v, kv_mask, *, scale: float, causal: bool = True, window: int = 0, offset: int = 0):
    """The forward kernel on CUDA tensors: (o [b, T, h, d] bf16, lse
    [b, h, T] f32). Raises on what the kernel does not take."""
    _check_kernel_inputs(q, k, v)
    b, T, h, d = q.shape
    kmask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    o = torch.empty((b, T, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, T), dtype=torch.float32, device=q.device)
    err = cuda_lib.lib().flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kmask.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, T, h, d, *_strides(q, k, v), float(scale), int(window), int(bool(causal)), int(offset),
        cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_fwd_bf16")
    _count(flash_fwd, causal, offset, q, window, (q, k, v, kmask, o, lse))
    return o, lse


def flash_bwd_dq(q, k, v, kmask, do, lse, delta, *, scale: float, window: int, causal: bool = True, offset: int = 0):
    """The dq kernel: dq [b, T, h, d] bf16 from contiguous dO and the f32
    [b, h, T] lse and delta."""
    b, T, h, d = q.shape
    dq = torch.empty((b, T, h, d), dtype=q.dtype, device=q.device)
    err = cuda_lib.lib().flash_bwd_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), kmask.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, T, h, d, *_strides(q, k, v), float(scale), int(window),
        int(bool(causal)), int(offset), cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_bwd_dq_bf16")
    _count(flash_bwd_dq, causal, offset, q, window, (q, k, v, do, kmask, lse, delta, dq))
    return dq


def flash_bwd_dkv(q, k, v, kmask, do, lse, delta, *, scale: float, window: int, causal: bool = True, offset: int = 0):
    """The dk/dv kernel: (dk, dv) [b, T, h, d] bf16."""
    b, T, h, d = q.shape
    dk = torch.empty((b, T, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, T, h, d), dtype=v.dtype, device=q.device)
    err = cuda_lib.lib().flash_bwd_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), kmask.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, T, h, d, *_strides(q, k, v), float(scale),
        int(window), int(bool(causal)), int(offset), cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_bwd_dkv_bf16")
    _count(flash_bwd_dkv, causal, offset, q, window, (q, k, v, do, kmask, lse, delta, dk, dv))
    return dk, dv


def reachable_pairs(Tq: int, Tk: int, *, causal: bool = True, window: int = 0, offset: int = 0) -> int:
    """The (query, key) pairs ``reachable`` leaves, counted on the host:
    query i reaches keys j in (i - window - offset, i - offset] (causal
    bound, window bound) within [0, Tk)."""
    i = np.arange(Tq)
    hi = np.minimum(Tk - 1, i - int(offset)) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(0, i - int(window) - int(offset) + 1) if window > 0 else np.zeros(Tq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


# FLOPs per reachable (query, key) pair and head dim of each kernel: the
# forward's QK^T and PV; dq's recomputed S, dP and dS K; dk/dv's S, dP, dS^T Q
# and P^T dO (PERF.md's bounds).
_PAIR_FLOPS = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


def _count(fn, causal: bool, offset: int, q=None, window: int = 0, tensors=()):
    """One launch of ``fn``'s kernel, also counted by mode: "causal" (offset
    0, the model's own attention and the ring's diagonal chunks), "offset"
    (a ring chunk's displacement) or "noncausal"; its cost (``cuda_lib
    .count_launch``) from q's shape and the reachable pairs."""
    with cuda_lib.launch_lock:
        fn.launches_by_mode["noncausal" if not causal else "offset" if offset else "causal"] += 1

    def cost():
        b, T, h, d = q.shape
        pairs = b * h * reachable_pairs(T, T, causal=causal, window=window, offset=offset)
        return _PAIR_FLOPS[fn.__name__] * d * pairs, sum(t.numel() * t.element_size() for t in tensors)

    cuda_lib.count_launch(fn, cost=cost if q is not None else None)


def reset_launches():
    """Zero the three wrappers' counts, the per-mode ones too."""
    for fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
        fn.launches = 0
        fn.launches_by_mode = dict.fromkeys(("causal", "offset", "noncausal"), 0)


reset_launches()


def flash_attention_bwd(q, k, v, kv_mask, o, lse, do, dlse, *, scale: float, causal: bool = True, window: int = 0,
                        offset: int = 0):
    """(dq, dk, dv) of the fused attention. CPU tensors take
    ``flash_attention_bwd_plain``; CUDA tensors form ``delta`` with torch
    ops (as the JAX package forms it outside Pallas) and launch the dq and
    dk/dv kernels, or raise."""
    modes = dict(scale=scale, causal=causal, window=window, offset=offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, dlse, **modes)
    _check_kernel_inputs(q, k, v)
    do = do.to(q.dtype).contiguous()
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2) - dlse.float()).contiguous()
    kmask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    lse = lse.float().contiguous()
    dq = flash_bwd_dq(q, k, v, kmask, do, lse, delta, **modes)
    dk, dv = flash_bwd_dkv(q, k, v, kmask, do, lse, delta, **modes)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """(o, lse) with the flash backward: saves q, k, v, kv_mask, o and lse;
    the backward takes the cotangents of both outputs. On the CPU the same
    Function runs the plain forward and the plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, causal, window, offset):
        modes = dict(scale=scale, causal=causal, window=window, offset=offset)
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, kv_mask, return_lse=True, **modes)
        else:
            o, lse = flash_fwd(q, k, v, kv_mask, **modes)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.modes = modes
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do
        dlse = torch.zeros_like(lse) if dlse is None else dlse
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, o, lse, do, dlse, **ctx.modes)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, kv_mask, *, scale: float, causal: bool = True, window: int = 0, offset: int = 0,
                    return_lse: bool = False):
    """Fused attention over [b, T, n_head, head_dim] inputs, causal by
    default (the JAX signature's order and defaults, without its block
    sizes and interpret flag).

    kv_mask: [b, T] key-slot validity (0 at left padding). ``window > 0``
    restricts keys to the trailing window. ``offset`` (a host int) puts key
    k at position k + offset of the query frame: ring attention passes the
    visiting chunk's displacement. Returns o [b, T, h, d] in q's dtype, and
    with ``return_lse`` also the f32 log-sum-exp [b, h, T], ``M_INIT`` on a
    row that reaches no key.

    Differentiable through ``FlashAttentionFn`` whenever grad is enabled and
    q, k or v requires it. CPU tensors take the plain versions; CUDA tensors
    launch the kernels (bf16, head_dim 64/128/256, any T) or raise."""
    modes = dict(scale=float(scale), causal=bool(causal), window=int(window), offset=int(offset))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = FlashAttentionFn.apply(q, k, v, kv_mask, *modes.values())
    elif q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, return_lse=return_lse, **modes)
    else:
        o, lse = flash_fwd(q, k, v, kv_mask, **modes)
    return (o, lse) if return_lse else o
