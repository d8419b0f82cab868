"""Fused head projection + per-token (logprob, logsumexp, entropy), forward
and backward: the CUDA kernels (``csrc/fused_logprob.cu``,
``csrc/fused_logprob_bwd.cu``), their plain versions (``naive_logprob``,
``fused_logprob_bwd_plain``), the autograd Function that joins them, and the
routing rule.

Counterpart of ``trlx_tpu.ops.fused_logprob`` (its ``_fused_core`` custom
VJP). A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

import math

import torch

from trlx_tpu_torch.ops import cuda_lib

BLOCK_V = 512  # the JAX package's forward vocab tile, kept for the shape rule
_KERNEL_BM = 128  # rows per CTA in the CUDA kernels
_KERNEL_BN = 128  # vocabulary columns per tile in the CUDA kernels
_KERNEL_BK = 64  # forward reduction chunk: D must divide by it
_BWD_D_MULTIPLE = 128  # the backward's dx tiles: D must divide by it
BWD_CHUNK_ROWS = 1024  # rows per backward chunk: a bf16 [C, V] ds buffer


def fused_logprob_eligible(d_model: int, vocab_size: int) -> bool:
    """The JAX package's shape rule for the fused head (the caller adds the
    device condition)."""
    return d_model % 128 == 0 and vocab_size >= BLOCK_V


def naive_logprob(x, w, labels, bias=None, *, tied: bool = False, mask=None):
    """The materializing path: head matmul in the activation dtype (the
    weight cast to x's dtype, the logits rounded to it) → f32 log_softmax →
    label gather + entropy. With ``mask``, masked rows are skipped (logits
    zeroed before the softmax, outputs zeroed after)."""
    wc = w.to(x.dtype)
    logits = x @ (wc.t() if tied else wc)
    if bias is not None:
        logits = logits + bias.to(x.dtype)
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask.bool()[..., None], logits, torch.zeros((), device=logits.device))
    logp = torch.log_softmax(logits, dim=-1)
    lp = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    lse = torch.logsumexp(logits, dim=-1)
    ent = -(logp.exp() * logp).sum(-1)
    if mask is not None:
        m = mask.float()
        lp, lse, ent = lp * m, lse * m, ent * m
    return lp, lse, ent


def fused_logprob_bwd_plain(x, w, bias, labels, lse, ent, dlp, dlse, dent, *, tied: bool = False):
    """The backward kernels' function with a materialized [N, V] score
    matrix: s = x·W (the weight cast to x's dtype, f32 accumulation) + bias,
    p = exp(s − lse), E = lse − ent, and
    ds = dlp·(1[k=y] − p) + dlse·p − dent·p·(s − E), rounded to x's dtype
    before the products. Returns (dx in x's dtype, dW in w's dtype, db in
    the bias dtype or None)."""
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    wc = w.to(x.dtype).float()
    s = x2.float() @ (wc.t() if tied else wc)
    if bias is not None:
        s = s + bias.float()

    def col(t):
        return t.reshape(-1, 1).float()

    p = torch.exp(s - col(lse))
    hit = torch.nn.functional.one_hot(labels.reshape(-1).long(), s.shape[-1]).float()
    ds = col(dlp) * (hit - p) + col(dlse) * p - col(dent) * p * (s - (col(lse) - col(ent)))
    dsc = ds.to(x.dtype).float()
    dx = (dsc @ (wc if tied else wc.t())).to(x.dtype).reshape(x.shape)
    dw = (dsc.t() @ x2.float()) if tied else (x2.float().t() @ dsc)
    db = None if bias is None else ds.sum(0).to(bias.dtype)
    return dx, dw.to(w.dtype), db


def _splits(n_rows: int, V: int, device) -> int:
    """V splits per row tile: about two CTAs per SM in all."""
    n_rt = -(-n_rows // _KERNEL_BM)
    n_vt = -(-V // _KERNEL_BN)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    s0 = max(1, min(n_vt, -(-2 * sms // n_rt)))
    tps = -(-n_vt // s0)
    return -(-n_vt // tps)


def _check_kernel_inputs(x, w, tied: bool, d_multiple: int):
    if x.device.type != "cuda":
        raise ValueError(f"fused_logprob: unsupported device {x.device}")
    D = x.shape[-1]
    V = w.shape[0] if tied else w.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_logprob kernel takes bfloat16 activations, got {x.dtype}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_logprob kernel takes a float32 or bfloat16 weight, got {w.dtype}")
    if D % d_multiple:
        raise ValueError(f"fused_logprob kernel needs d_model % {d_multiple} == 0, got {D}")
    if tuple(w.shape) != ((V, D) if tied else (D, V)):
        raise ValueError(f"fused_logprob: weight shape {tuple(w.shape)} does not match d_model {D}")
    return D, V


def fused_logprob_fwd(x, w, labels, bias=None, *, tied: bool = False):
    """The forward kernel pair on CUDA tensors: f32 (logprob, lse, entropy)
    shaped like labels. Raises on what the kernel does not take."""
    D, V = _check_kernel_inputs(x, w, tied, _KERNEL_BK)
    lead = labels.shape
    N = math.prod(lead) if len(lead) else 1
    x2 = x.reshape(N, D).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("fused_logprob: the activations need a 16-byte aligned start")
    wc = w.contiguous()
    y = labels.reshape(N).to(torch.int32).contiguous()
    b = None if bias is None else bias.reshape(V).to(torch.float32).contiguous()
    S = _splits(N, V, x.device)
    part = torch.empty((4, S, N), dtype=torch.float32, device=x.device)
    lp = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(lp)
    ent = torch.empty_like(lp)
    err = cuda_lib.lib().fused_logprob_fwd(
        x2.data_ptr(), wc.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        lp.data_ptr(), lse.data_ptr(), ent.data_ptr(), part.data_ptr(),
        N, D, V, int(bool(tied)), int(wc.dtype == torch.bfloat16), S, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, "fused_logprob_fwd")
    fused_logprob_fwd.launches += 1
    return lp.reshape(lead), lse.reshape(lead), ent.reshape(lead)


def fused_logprob_bwd_dx(x2, wc, b, y, rows_f32, ds, dbpart, dx, *, rows: int, C: int, ldv: int, tied: bool):
    """One chunk of rows: the ds kernel (ds into the bf16 [C, ldv] scratch,
    db column partials) and the dx kernel. ``rows_f32`` holds the chunk's
    (lse, ent, dlp, dlse, dent) vectors."""
    D, V = x2.shape[1], (wc.shape[0] if tied else wc.shape[1])
    err = cuda_lib.lib().fused_logprob_bwd_ds_dx(
        x2.data_ptr(), wc.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        *(t.data_ptr() for t in rows_f32), ds.data_ptr(), None if dbpart is None else dbpart.data_ptr(),
        dx.data_ptr(), rows, D, V, ldv, C, int(bool(tied)), int(wc.dtype == torch.bfloat16),
        cuda_lib.stream_ptr(x2.device),
    )
    cuda_lib.check(err, "fused_logprob_bwd_ds_dx")
    fused_logprob_bwd_dx.launches += 1


def fused_logprob_bwd_dw(x2, ds, dw, *, rows: int, V: int, ldv: int, tied: bool, accumulate: bool,
                         dbpart=None, db=None):
    """One chunk of rows: the dW kernel (f32 dW stored on the first chunk,
    accumulated after), and with ``db`` the db merge of all row tiles."""
    D = x2.shape[1]
    n_tiles = 0 if dbpart is None else dbpart.shape[0]
    err = cuda_lib.lib().fused_logprob_bwd_dw(
        x2.data_ptr(), ds.data_ptr(), dw.data_ptr(), rows, D, V, ldv, int(bool(tied)), int(accumulate),
        None if dbpart is None else dbpart.data_ptr(), None if db is None else db.data_ptr(), n_tiles,
        cuda_lib.stream_ptr(x2.device),
    )
    cuda_lib.check(err, "fused_logprob_bwd_dw")
    fused_logprob_bwd_dw.launches += 1


for _fn in (fused_logprob_fwd, fused_logprob_bwd_dx, fused_logprob_bwd_dw):
    _fn.launches = 0


def fused_logprob_bwd(x, w, bias, labels, lse, ent, dlp, dlse, dent, *, tied: bool = False):
    """(dx, dW, db) of the fused head. CPU tensors take
    ``fused_logprob_bwd_plain``; CUDA tensors walk the rows in chunks of
    ``BWD_CHUNK_ROWS`` (ds + dx, then dW/db per chunk), so no [N, V] buffer
    exists, or raise. dW accumulates in f32 and comes back in w's dtype."""
    if x.device.type == "cpu":
        return fused_logprob_bwd_plain(x, w, bias, labels, lse, ent, dlp, dlse, dent, tied=tied)
    D, V = _check_kernel_inputs(x, w, tied, _BWD_D_MULTIPLE)
    N = labels.numel()
    dev = x.device
    x2 = x.reshape(N, D).contiguous()
    wc = w.contiguous()
    y = labels.reshape(N).to(torch.int32).contiguous()
    b = None if bias is None else bias.reshape(V).to(torch.float32).contiguous()
    vecs = [t.reshape(N).to(torch.float32).contiguous() for t in (lse, ent, dlp, dlse, dent)]
    ldv = -(-V // _KERNEL_BN) * _KERNEL_BN
    C = min(BWD_CHUNK_ROWS, -(-N // _KERNEL_BM) * _KERNEL_BM)
    ds = torch.empty((C, ldv), dtype=torch.bfloat16, device=dev)
    n_tiles = -(-N // _KERNEL_BM)
    dbpart = None if b is None else torch.empty((n_tiles, V), dtype=torch.float32, device=dev)
    dx = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
    dw = torch.empty(tuple(w.shape), dtype=torch.float32, device=dev)
    db = None if b is None else torch.empty((V,), dtype=torch.float32, device=dev)
    for c0 in range(0, N, C):
        rows = min(C, N - c0)
        part = None if dbpart is None else dbpart[c0 // _KERNEL_BM:]
        fused_logprob_bwd_dx(x2[c0:], wc, b, y[c0:], [v[c0:] for v in vecs], ds, part, dx[c0:],
                             rows=rows, C=C, ldv=ldv, tied=tied)
        last = c0 + C >= N
        fused_logprob_bwd_dw(x2[c0:], ds, dw, rows=rows, V=V, ldv=ldv, tied=tied, accumulate=c0 > 0,
                             dbpart=dbpart if last else None, db=db if last else None)
    return dx.reshape(x.shape), dw.to(w.dtype), None if db is None else db.to(bias.dtype)


class FusedLogprobFn(torch.autograd.Function):
    """(logprob, lse, entropy) with the fused backward over (x, w, bias);
    the labels are not differentiable. Saves x, w, bias, labels and the row
    residuals (lse, entropy). On the CPU the same Function runs the plain
    forward and the plain backward."""

    @staticmethod
    def forward(ctx, x, w, bias, labels, tied):
        if x.device.type == "cpu":
            lp, lse, ent = naive_logprob(x, w, labels, bias, tied=tied)
        else:
            lp, lse, ent = fused_logprob_fwd(x, w, labels, bias, tied=tied)
        ctx.save_for_backward(x, w, bias, labels, lse, ent)
        ctx.tied = tied
        return lp, lse, ent

    @staticmethod
    def backward(ctx, dlp, dlse, dent):
        x, w, bias, labels, lse, ent = ctx.saved_tensors
        dlp, dlse, dent = (torch.zeros_like(lse) if g is None else g for g in (dlp, dlse, dent))
        dx, dw, db = fused_logprob_bwd(x, w, bias, labels, lse, ent, dlp, dlse, dent, tied=ctx.tied)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None, db if need[2] else None, None, None)


def fused_logprob(x, w, labels, bias=None, *, tied: bool = False):
    """Per-token f32 (logprob, lse, entropy) of ``labels`` under the head
    x [..., D] · w ([D, V], or the tied embedding [V, D]) + bias [V], each
    shaped like labels; the [..., V] logits are never formed. Differentiable
    in x, w and bias through ``FusedLogprobFn`` whenever grad is enabled and
    one of them requires it. CPU tensors take the plain versions; CUDA
    tensors launch the kernels (x bf16, w f32 or bf16, D a multiple of 64,
    of 128 for the backward) or raise."""
    needs = [t is not None and t.requires_grad for t in (x, w, bias)]
    if torch.is_grad_enabled() and any(needs):
        return FusedLogprobFn.apply(x, w, bias, labels, bool(tied))
    if x.device.type == "cpu":
        return naive_logprob(x, w, labels, bias, tied=tied)
    return fused_logprob_fwd(x, w, labels, bias, tied=tied)


def routed_logprob(x, w, labels, bias=None, *, tied: bool = False, mode: str = "auto", mask=None):
    """The model layer's entry: the fused head when ``mode`` is "force", or
    "auto" on a CUDA device with bf16 activations and an eligible shape;
    else the materializing ``naive_logprob``. ``mask`` zeros masked rows on
    both paths."""
    if mode not in ("auto", "force", "off"):
        raise ValueError(f"fused_logprob mode must be auto|force|off, got {mode!r}")
    use_kernel = mode == "force" or (
        mode == "auto"
        and x.device.type == "cuda"
        and x.dtype == torch.bfloat16
        and fused_logprob_eligible(x.shape[-1], w.shape[0] if tied else w.shape[1])
    )
    if use_kernel:
        lp, lse, ent = fused_logprob(x, w, labels, bias, tied=tied)
        if mask is not None:
            m = mask.float()
            lp, lse, ent = lp * m, lse * m, ent * m
        return lp, lse, ent
    return naive_logprob(x, w, labels, bias, tied=tied, mask=mask)
