"""Fused head projection + per-token (logprob, logsumexp, entropy), forward
and backward: the CUDA kernels (``csrc/fused_logprob.cu``,
``csrc/fused_logprob_bwd.cu``), their plain versions (``naive_logprob``,
``fused_logprob_bwd_plain``), the autograd Function that joins them, and the
routing rule.

Counterpart of ``trlx_tpu.ops.fused_logprob`` (its ``_fused_core`` custom
VJP). A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. The kernels compute in the activation's dtype, as the TPU kernels
do: bf16 activations go to the bf16 tensor-core kernels (the weight read in
bf16), f32 activations (ILQL's Q heads) to the f32 kernels (f32-accurate
products as three TF32 tensor-core passes), which read the f32 weight
through TMA; any other dtype raises.
"""

import math

import torch

from trlx_tpu_torch.ops import cuda_lib

BLOCK_V = 512  # the JAX package's forward vocab tile, kept for the shape rule
_KERNEL_BM = 128  # rows per CTA of the forward and ds kernels (GEMM_BM in csrc/logprob_gemm.cuh)
_KERNEL_BN = 256  # vocabulary columns per tile (GEMM_BN)
_KERNEL_BK = 64  # forward reduction chunk: D must divide by it
_BWD_D_MULTIPLE = 128  # the backward's shape rule: D must divide by it
_DS_LD = 128  # the ds scratch's rows are padded to a multiple of this (ldv)
BWD_CHUNK_ROWS = 1024  # rows per chunk of the ds and dx kernels
_F32_BM = 128  # the f32 forward and ds kernels' output tile (TG_BM x TG_BN in csrc/logprob_gemm_tf32.cuh)
_F32_BN = 128
_F32_CTAS_PER_SM = 1  # a CTA of the 3xTF32 kernels holds 200 KB of shared memory: one an SM


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


def fused_logprob_bwd_plain(x, w, bias, labels, lse, ent, dlp, dlse, dent, *, tied: bool = False, dw_dtype=None):
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
    return dx, dw.to(dw_dtype or w.dtype), db


def split_count(n_rows: int, V: int, sms: int, bm: int = _KERNEL_BM, bn: int = _KERNEL_BN) -> int:
    """V splits per row tile of the forward and ds grids (row tiles of
    ``bm``, vocabulary tiles of ``bn``) for ``sms`` CTAs in flight: about
    one CTA per slot in all (a bf16 CTA holds 210 KB of shared memory, so one
    an SM), every split non-empty."""
    n_rt = -(-n_rows // bm)
    n_vt = -(-V // bn)
    s0 = max(1, min(n_vt, sms // n_rt))
    tps = -(-n_vt // s0)
    return -(-n_vt // tps)


def _f32_splits(n_rows: int, V: int, device) -> int:
    return split_count(n_rows, V, _F32_CTAS_PER_SM * _sm_count(device), _F32_BM, _F32_BN)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tma_ready(w, dtype=torch.bfloat16) -> bool:
    """``dtype``, unit stride along the last dimension, every row starting
    on a 16-byte boundary: what the kernels' TMA maps take."""
    per16 = 16 // dtype.itemsize
    return w.dtype == dtype and w.stride(-1) == 1 and w.stride(0) % per16 == 0 and w.data_ptr() % 16 == 0


def kernel_weight(w, dtype=torch.bfloat16):
    """The head weight as the kernels read it (``_tma_ready`` in ``dtype``:
    bf16 for the bf16 kernels, f32 for the f32 ones). A weight that already
    is so is returned as it is; any other (an f32 master for the bf16
    kernels, a V that is not a multiple of 16 bytes) is copied, cast as
    ``w.to(dtype)`` rounds, into a fresh buffer whose rows are padded to a
    multiple of 16 bytes, and a view of its first columns is returned;
    ``kernel_weight.copies`` counts those copies."""
    if _tma_ready(w, dtype):
        return w
    rows, cols = w.shape
    per16 = 16 // dtype.itemsize
    buf = torch.empty((rows, -(-cols // per16) * per16), dtype=dtype, device=w.device)
    view = buf[:, :cols]
    view.copy_(w)
    kernel_weight.copies += 1
    return view


kernel_weight.copies = 0


def _check_kernel_inputs(x, w, tied: bool, d_multiple: int):
    if x.device.type != "cuda":
        raise ValueError(f"fused_logprob: unsupported device {x.device}")
    D = x.shape[-1]
    V = w.shape[0] if tied else w.shape[1]
    if x.dtype == torch.bfloat16:
        if w.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"fused_logprob kernel takes a float32 or bfloat16 weight, got {w.dtype}")
    elif x.dtype == torch.float32:
        if w.dtype != torch.float32:
            raise TypeError(f"the float32 fused_logprob kernels take a float32 weight, got {w.dtype}")
    else:
        raise TypeError(f"fused_logprob kernels take bfloat16 or float32 activations, got {x.dtype}")
    if D % d_multiple:
        raise ValueError(f"fused_logprob kernel needs d_model % {d_multiple} == 0, got {D}")
    if tuple(w.shape) != ((V, D) if tied else (D, V)):
        raise ValueError(f"fused_logprob: weight shape {tuple(w.shape)} does not match d_model {D}")
    return D, V


def _fwd_operands(x, labels, bias, D: int, V: int):
    """(N, x as [N, D] contiguous, int32 labels [N], f32 bias [V] or None,
    and the f32 lp / lse / ent outputs [N]) of a forward call."""
    N = math.prod(labels.shape) if labels.dim() else 1
    x2 = x.reshape(N, D).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("fused_logprob: the activations need a 16-byte aligned start")
    y = labels.reshape(N).to(torch.int32).contiguous()
    b = None if bias is None else bias.reshape(V).to(torch.float32).contiguous()
    out = [torch.empty(N, dtype=torch.float32, device=x.device) for _ in range(3)]
    return N, x2, y, b, out


def _head_cost(products: int, rows: int, D: int, V: int, *tensors):
    """(FLOPs, bytes) of a head kernel launch: ``products`` FLOPs per (row,
    d, v) (2: the forward's or dW's one product; 4: ds's recomputed logits
    and dx), and the bytes of its operands, each read or written once."""
    return products * rows * D * V, sum(t.numel() * t.element_size() for t in tensors)


def fused_logprob_fwd(x, w, labels, bias=None, *, tied: bool = False):
    """The forward kernel pair on CUDA tensors: f32 (logprob, lse, entropy)
    shaped like labels. bf16 x: the weight goes through ``kernel_weight``
    (one bf16 cast of an f32 master). f32 x: ``fused_logprob_fwd_f32``.
    Raises on what the kernels do not take."""
    if x.dtype == torch.float32:
        return fused_logprob_fwd_f32(x, w, labels, bias, tied=tied)
    D, V = _check_kernel_inputs(x, w, tied, _KERNEL_BK)
    N, x2, y, b, (lp, lse, ent) = _fwd_operands(x, labels, bias, D, V)
    wk = kernel_weight(w)
    S = split_count(N, V, _sm_count(x.device))
    part = torch.empty((4, S, N), dtype=torch.float32, device=x.device)
    err = cuda_lib.lib().fused_logprob_fwd(
        x2.data_ptr(), wk.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        lp.data_ptr(), lse.data_ptr(), ent.data_ptr(), part.data_ptr(),
        N, D, V, wk.stride(0), int(bool(tied)), S, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, "fused_logprob_fwd")
    cuda_lib.count_launch(fused_logprob_fwd, cost=lambda: _head_cost(2, N, D, V, x2, wk))
    lead = labels.shape
    return lp.reshape(lead), lse.reshape(lead), ent.reshape(lead)


def fused_logprob_fwd_f32(x, w, labels, bias=None, *, tied: bool = False):
    """The f32 forward kernel pair (x and w f32, f32-accurate products as
    three TF32 passes, f32 sums): f32 (logprob, lse, entropy) shaped like
    labels. The weight goes through ``kernel_weight`` in f32 (a padded copy
    only when its rows do not start on 16-byte boundaries). Raises on what
    the kernel does not take."""
    if x.dtype != torch.float32:
        raise TypeError(f"fused_logprob_fwd_f32 takes float32 activations, got {x.dtype}")
    D, V = _check_kernel_inputs(x, w, tied, _KERNEL_BK)
    N, x2, y, b, (lp, lse, ent) = _fwd_operands(x, labels, bias, D, V)
    wk = kernel_weight(w, torch.float32)
    S = _f32_splits(N, V, x.device)
    part = torch.empty((4, S, N), dtype=torch.float32, device=x.device)
    err = cuda_lib.lib().fused_logprob_fwd_f32(
        x2.data_ptr(), wk.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        lp.data_ptr(), lse.data_ptr(), ent.data_ptr(), part.data_ptr(),
        N, D, V, wk.stride(0), int(bool(tied)), S, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, "fused_logprob_fwd_f32")
    cuda_lib.count_launch(fused_logprob_fwd_f32, cost=lambda: _head_cost(2, N, D, V, x2, wk))
    lead = labels.shape
    return lp.reshape(lead), lse.reshape(lead), ent.reshape(lead)


def fused_logprob_bwd_dx(x2, wc, b, y, rows_f32, ds, dbpart, dx, *, rows: int, C: int, ldv: int, tied: bool):
    """One chunk of rows: the ds kernel (ds into the bf16 [C, ldv] scratch,
    db column partials) and the dx kernel. ``wc`` is the weight as
    ``kernel_weight`` gives it; ``rows_f32`` holds the chunk's (lse, ent,
    dlp, dlse, dent) vectors."""
    D, V = x2.shape[1], (wc.shape[0] if tied else wc.shape[1])
    if not _tma_ready(wc):
        raise TypeError("fused_logprob_bwd_dx takes the weight as kernel_weight gives it")
    err = cuda_lib.lib().fused_logprob_bwd_ds_dx(
        x2.data_ptr(), wc.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        *(t.data_ptr() for t in rows_f32), ds.data_ptr(), None if dbpart is None else dbpart.data_ptr(),
        dx.data_ptr(), rows, D, V, ldv, C, wc.stride(0), int(bool(tied)),
        split_count(rows, V, _sm_count(x2.device)), cuda_lib.stream_ptr(x2.device),
    )
    cuda_lib.check(err, "fused_logprob_bwd_ds_dx")
    cuda_lib.count_launch(fused_logprob_bwd_dx, cost=lambda: _head_cost(4, rows, D, V, x2, wc, ds, dx))


def fused_logprob_bwd_dw(x2, ds, dw, *, rows: int, V: int, ldv: int, tied: bool, dbpart=None, db=None):
    """The dW kernel over ``rows`` rows of x2 and of the bf16 ds [rows, ldv]:
    f32 dW, each element stored once; with ``db`` also the db merge of all
    row tiles."""
    D = x2.shape[1]
    n_tiles = 0 if dbpart is None else dbpart.shape[0]
    err = cuda_lib.lib().fused_logprob_bwd_dw(
        x2.data_ptr(), ds.data_ptr(), dw.data_ptr(), rows, D, V, ldv, int(bool(tied)),
        None if dbpart is None else dbpart.data_ptr(), None if db is None else db.data_ptr(), n_tiles,
        _sm_count(x2.device), cuda_lib.stream_ptr(x2.device),
    )
    cuda_lib.check(err, "fused_logprob_bwd_dw")
    cuda_lib.count_launch(fused_logprob_bwd_dw, cost=lambda: _head_cost(2, rows, D, V, x2, ds, dw))


def fused_logprob_bwd_dx_f32(x2, w, b, y, rows_f32, ds, dbpart, dx, *, rows: int, C: int, ldv: int, tied: bool):
    """The f32 mode of one chunk of rows: the ds kernel (f32 ds into the
    [C, ldv] scratch, db column partials) and the dx kernel (f32 dx); w is
    the f32 weight as ``kernel_weight`` gives it."""
    D, V = x2.shape[1], (w.shape[0] if tied else w.shape[1])
    if not _tma_ready(w, torch.float32):
        raise TypeError("fused_logprob_bwd_dx_f32 takes the weight as kernel_weight(w, torch.float32) gives it")
    err = cuda_lib.lib().fused_logprob_bwd_ds_dx_f32(
        x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        *(t.data_ptr() for t in rows_f32), ds.data_ptr(), None if dbpart is None else dbpart.data_ptr(),
        dx.data_ptr(), rows, D, V, ldv, C, w.stride(0), int(bool(tied)), _f32_splits(rows, V, x2.device),
        cuda_lib.stream_ptr(x2.device),
    )
    cuda_lib.check(err, "fused_logprob_bwd_ds_dx_f32")
    cuda_lib.count_launch(fused_logprob_bwd_dx_f32, cost=lambda: _head_cost(4, rows, D, V, x2, w, ds, dx))


def fused_logprob_bwd_dw_f32(x2, ds, dw, *, rows: int, V: int, ldv: int, tied: bool, dbpart=None, db=None):
    """The f32 mode's dW kernel over ``rows`` rows of x2 and of the f32 ds
    [rows, ldv]: f32 dW, each element stored once; with ``db`` also the db
    merge of all row tiles. x2's rows are first transposed into a scratch
    [D, rows rounded up to 4] (what the kernel's A operand reads: 134 MB at
    the Q heads' N = 4092, D = 8192), made here and freed after the call."""
    if x2.dtype != torch.float32 or ds.dtype != torch.float32 or not x2.is_contiguous():
        raise TypeError("fused_logprob_bwd_dw_f32 takes a contiguous f32 x2 and an f32 ds")
    D = x2.shape[1]
    n_tiles = 0 if dbpart is None else dbpart.shape[0]
    xt = torch.empty((D, -(-rows // 4) * 4), dtype=torch.float32, device=x2.device)
    err = cuda_lib.lib().fused_logprob_bwd_dw_f32(
        x2.data_ptr(), ds.data_ptr(), xt.data_ptr(), dw.data_ptr(), rows, D, V, ldv, xt.stride(0),
        int(bool(tied)), None if dbpart is None else dbpart.data_ptr(), None if db is None else db.data_ptr(),
        n_tiles, _sm_count(x2.device), cuda_lib.stream_ptr(x2.device),
    )
    cuda_lib.check(err, "fused_logprob_bwd_dw_f32")
    cuda_lib.count_launch(fused_logprob_bwd_dw_f32, cost=lambda: _head_cost(2, rows, D, V, x2, ds, dw))


for _fn in (fused_logprob_fwd, fused_logprob_bwd_dx, fused_logprob_bwd_dw, fused_logprob_fwd_f32,
            fused_logprob_bwd_dx_f32, fused_logprob_bwd_dw_f32):
    _fn.launches = 0


def fused_logprob_bwd(x, w, bias, labels, lse, ent, dlp, dlse, dent, *, tied: bool = False, wk=None,
                      need_dw: bool = True, dw_dtype=None):
    """(dx, dW, db) of the fused head. CPU tensors take
    ``fused_logprob_bwd_plain``; CUDA tensors walk the rows in chunks of
    ``BWD_CHUNK_ROWS`` (ds + dx per chunk, into a ds of every row), then
    launch dW/db once over all rows, so no f32 [N, V] score buffer exists and
    dW is written once; or raise. dW accumulates in f32 and comes back in w's
    dtype; dx comes back in x's dtype. With ``need_dw`` False (a frozen
    head: neither w nor bias takes a gradient) the dW/db kernel is not
    launched and dW and db come back None. ``dw_dtype`` overrides the dtype
    dW comes back in (f32 for a sharded head whose pieces are f32 masters).

    ``wk`` is w as ``kernel_weight`` gives it in x's dtype (the forward's
    copy), made here when not given; the ds and dx kernels read it, and ds is
    kept in x's dtype.

    The ds buffer grows with N: N rounded up to 128, times V rounded up to
    128, in x's dtype (bf16: 206.6 MB at N = 2048, V = 50400; f32: 826 MB at
    N = 4092), beside the f32 dW of D x V (826 MB at D = 4096)."""
    if x.device.type == "cpu":
        return fused_logprob_bwd_plain(x, w, bias, labels, lse, ent, dlp, dlse, dent, tied=tied, dw_dtype=dw_dtype)
    D, V = _check_kernel_inputs(x, w, tied, _BWD_D_MULTIPLE)
    f32 = x.dtype == torch.float32
    N = labels.numel()
    dev = x.device
    x2 = x.reshape(N, D).contiguous()
    wc = kernel_weight(w if wk is None else wk, x.dtype)
    y = labels.reshape(N).to(torch.int32).contiguous()
    b = None if bias is None else bias.reshape(V).to(torch.float32).contiguous()
    vecs = [t.reshape(N).to(torch.float32).contiguous() for t in (lse, ent, dlp, dlse, dent)]
    ldv = -(-V // _DS_LD) * _DS_LD
    n_tiles = -(-N // _KERNEL_BM)
    C = min(BWD_CHUNK_ROWS, n_tiles * _KERNEL_BM)
    # The ds kernels write whole 128-row tiles: every row tile of N.
    ds = torch.empty((n_tiles * _KERNEL_BM, ldv), dtype=x.dtype, device=dev)
    dbpart = None if b is None else torch.empty((n_tiles, V), dtype=torch.float32, device=dev)
    dx = torch.empty((N, D), dtype=x.dtype, device=dev)
    chunk_fn, dw_fn = (fused_logprob_bwd_dx_f32, fused_logprob_bwd_dw_f32) if f32 else (
        fused_logprob_bwd_dx, fused_logprob_bwd_dw)
    for c0 in range(0, N, C):
        rows = min(C, N - c0)
        part = None if dbpart is None else dbpart[c0 // _KERNEL_BM:]
        chunk_fn(x2[c0:], wc, b, y[c0:], [v[c0:] for v in vecs], ds[c0:], part, dx[c0:],
                 rows=rows, C=C, ldv=ldv, tied=tied)
    if not need_dw:
        return dx.reshape(x.shape), None, None
    dw = torch.empty(tuple(w.shape), dtype=torch.float32, device=dev)
    db = None if b is None else torch.empty((V,), dtype=torch.float32, device=dev)
    dw_fn(x2, ds, dw, rows=N, V=V, ldv=ldv, tied=tied, dbpart=dbpart, db=db)
    return dx.reshape(x.shape), dw.to(dw_dtype or w.dtype), None if db is None else db.to(bias.dtype)


class FusedLogprobFn(torch.autograd.Function):
    """(logprob, lse, entropy) with the fused backward over (x, w, bias);
    the labels are not differentiable. Saves x, w, bias, labels, the row
    residuals (lse, entropy) and, on CUDA, the weight as the forward kernel
    read it (``kernel_weight`` in x's dtype: a bf16 copy of an f32 master;
    for f32 x, w itself unless its rows needed a padded copy), so the
    backward does not make it again. On the CPU the same Function runs the
    plain forward and the plain backward."""

    @staticmethod
    def forward(ctx, x, w, bias, labels, tied):
        wk = None
        if x.device.type == "cpu":
            lp, lse, ent = naive_logprob(x, w, labels, bias, tied=tied)
        else:
            _check_kernel_inputs(x, w, tied, _KERNEL_BK)
            wk = kernel_weight(w, x.dtype)
            lp, lse, ent = fused_logprob_fwd(x, wk, labels, bias, tied=tied)
        ctx.save_for_backward(x, w, bias, labels, lse, ent, wk)
        ctx.tied = tied
        return lp, lse, ent

    @staticmethod
    def backward(ctx, dlp, dlse, dent):
        x, w, bias, labels, lse, ent, wk = ctx.saved_tensors
        dlp, dlse, dent = (torch.zeros_like(lse) if g is None else g for g in (dlp, dlse, dent))
        need = ctx.needs_input_grad
        # A frozen head (the soft-prompt path) launches no dW/db kernel.
        dx, dw, db = fused_logprob_bwd(x, w, bias, labels, lse, ent, dlp, dlse, dent, tied=ctx.tied, wk=wk,
                                       need_dw=need[1] or need[2])
        return (dx if need[0] else None, dw if need[1] else None, db if need[2] else None, None, None)


class WholeHeadLogprobFn(torch.autograd.Function):
    """The fused head over a head split across ranks (a sharded mesh):
    ``w`` and ``bias`` are this rank's pieces, ``full_w`` / ``full_b`` their
    wholes (``models.lm.FullParam``: the copy gathered over fsdp and tp once
    per weight version). The unchanged kernels (or, on the CPU, their plain
    versions) run over the whole vocabulary on every rank (each tp rank
    repeats the head's work, as XLA hands the Pallas call replicated
    operands under pjit); the backward's f32 dW and db over the whole
    vocabulary are reduced to this rank's pieces."""

    @staticmethod
    def forward(ctx, x, w, bias, labels, tied, full_w, full_b):
        wk = full_w.copy(x.dtype)
        b = None if full_b is None else full_b.copy(torch.float32)
        if x.device.type == "cpu":
            lp, lse, ent = naive_logprob(x, wk, labels, b, tied=tied)
        else:
            _check_kernel_inputs(x, wk, tied, _KERNEL_BK)
            wk = kernel_weight(wk, x.dtype)
            lp, lse, ent = fused_logprob_fwd(x, wk, labels, b, tied=tied)
        ctx.save_for_backward(x, labels, lse, ent)
        ctx.tied, ctx.wk, ctx.b, ctx.full_w, ctx.full_b = tied, wk, b, full_w, full_b
        return lp, lse, ent

    @staticmethod
    def backward(ctx, dlp, dlse, dent):
        x, labels, lse, ent = ctx.saved_tensors
        dlp, dlse, dent = (torch.zeros_like(lse) if g is None else g for g in (dlp, dlse, dent))
        need = ctx.needs_input_grad
        dx, dw, db = fused_logprob_bwd(x, ctx.wk, ctx.b, labels, lse, ent, dlp, dlse, dent, tied=ctx.tied, wk=ctx.wk,
                                       need_dw=need[1] or need[2], dw_dtype=torch.float32)
        dw = ctx.full_w.piece(dw) if need[1] else None
        db = ctx.full_b.piece(db) if need[2] else None
        return dx if need[0] else None, dw, db, None, None, None, None


def fused_logprob(x, w, labels, bias=None, *, tied: bool = False):
    """Per-token f32 (logprob, lse, entropy) of ``labels`` under the head
    x [..., D] · w ([D, V], or the tied embedding [V, D]) + bias [V], each
    shaped like labels; the [..., V] logits are never formed. Differentiable
    in x, w and bias through ``FusedLogprobFn`` whenever grad is enabled and
    one of them requires it. CPU tensors take the plain versions; CUDA
    tensors launch the kernels (x bf16 with w f32 or bf16, or x and w f32;
    D a multiple of 64, of 128 for the backward) or raise."""
    needs = [t is not None and t.requires_grad for t in (x, w, bias)]
    if torch.is_grad_enabled() and any(needs):
        return FusedLogprobFn.apply(x, w, bias, labels, bool(tied))
    if x.device.type == "cpu":
        return naive_logprob(x, w, labels, bias, tied=tied)
    return fused_logprob_fwd(x, w, labels, bias, tied=tied)


def routed_logprob(x, w, labels, bias=None, *, tied: bool = False, mode: str = "auto", mask=None,
                   whole=(None, None)):
    """The model layer's entry: the fused head when ``mode`` is "force", or
    "auto" on a CUDA device with bf16 or f32 activations (the dtypes the
    kernels take) and an eligible shape; else the materializing
    ``naive_logprob``. ``mask`` zeros masked rows on both paths. On a
    sharded mesh ``w`` and ``bias`` are this rank's pieces and ``whole``
    their ``FullParam`` wholes: both paths compute over the whole
    vocabulary (``WholeHeadLogprobFn``; the naive path over the gathered
    copy), and the gradient reaches each piece."""
    if mode not in ("auto", "force", "off"):
        raise ValueError(f"fused_logprob mode must be auto|force|off, got {mode!r}")
    full_w, full_b = whole
    shape = full_w.shape if full_w is not None else w.shape
    use_kernel = mode == "force" or (
        mode == "auto"
        and x.device.type == "cuda"
        and x.dtype in (torch.bfloat16, torch.float32)
        and fused_logprob_eligible(x.shape[-1], shape[0] if tied else shape[1])
    )
    if full_w is not None:
        if use_kernel:
            needs = [t is not None and t.requires_grad for t in (x, w, bias)]
            if torch.is_grad_enabled() and any(needs):
                lp, lse, ent = WholeHeadLogprobFn.apply(x, w, bias, labels, bool(tied), full_w, full_b)
            else:
                wk = full_w.copy(x.dtype)
                b = None if full_b is None else full_b.copy(torch.float32)
                lp, lse, ent = (naive_logprob(x, wk, labels, b, tied=tied) if x.device.type == "cpu" else
                                fused_logprob_fwd(x, kernel_weight(wk, x.dtype), labels, b, tied=tied))
            if mask is not None:
                m = mask.float()
                lp, lse, ent = lp * m, lse * m, ent * m
            return lp, lse, ent
        return naive_logprob(x, full_w.whole(x.dtype), labels, None if full_b is None else full_b.whole(x.dtype),
                             tied=tied, mask=mask)
    if use_kernel:
        lp, lse, ent = fused_logprob(x, w, labels, bias, tied=tied)
        if mask is not None:
            m = mask.float()
            lp, lse, ent = lp * m, lse * m, ent * m
        return lp, lse, ent
    return naive_logprob(x, w, labels, bias, tied=tied, mask=mask)
