"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. Every test here needs a CUDA device and skips without one;
on a machine with a card run them with

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: inputs and outputs are bf16 (one ulp is 2^-8 relative); the
kernels and the plain versions sum in another order, and the fused-logprob
plain version rounds its logits to bf16 where the kernel keeps f32. The
fused head's f32 mode (f32 activations and weight, as ILQL's Q heads call
it) multiplies in f32 on both sides: 1e-4 relative.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    """The card machine's Python may have wandb installed; a trainer here
    records to metrics.jsonl only and never reaches for a wandb login."""
    import trlx_tpu_torch.utils.logging as tracker_module

    monkeypatch.setattr(tracker_module, "_HAS_WANDB", False)


def _cuda():
    """Decided inside each test, never at import: every worker must collect
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("T,window,pads", [(128, 0, (0, 37)), (200, 0, (5, 0)), (256, 64, (0, 90)), (200, 8, (0, 37))])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_kernel_matches_plain(T, window, pads, d):
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain, flash_fwd

    g = torch.Generator(device=dev).manual_seed(0)
    b, h = 2, 4
    q, k, v = (torch.randn((b, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    before = flash_fwd.launches
    o, lse = flash_attention(q, k, v, mask, scale=d ** -0.5, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    ro, rlse = flash_attention_plain(q, k, v, mask, scale=d ** -0.5, window=window, return_lse=True)
    rows = mask.bool()
    torch.testing.assert_close(o[rows].float(), ro[rows].float(), rtol=0, atol=2e-2)
    lrows = rows[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[lrows], rlse[lrows], rtol=0, atol=1e-2)


@pytest.mark.parametrize("window", [0, 48], ids=["causal", "window48"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("T", [1, 64, 127, 128, 200, 768, 1024])
def test_flash_fwd_tiles_match_plain(T, d, window):
    """The TMA + wgmma forward at the edges of its 128-query and 64-key
    tiles (T = 1, 64, 127, 128, 200) and at the rollout lengths, with one
    left-padded row and, at T > 1, a fully masked one; o and lse on every
    row with a valid key."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(12)
    b, h = 3, 2
    q, k, v = (torch.randn((b, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    mask[1, : T // 3] = 0
    if T > 1:
        mask[2] = 0
    o, lse = flash_attention(q, k, v, mask, scale=d ** -0.5, window=window, return_lse=True)
    torch.cuda.synchronize()
    ro, rlse = flash_attention_plain(q, k, v, mask, scale=d ** -0.5, window=window, return_lse=True)
    rows = mask.bool()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o[rows].float(), ro[rows].float(), rtol=0, atol=2e-2)
    lrows = rows[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[lrows], rlse[lrows], rtol=0, atol=1e-2)


@pytest.mark.parametrize("window", [48, 100])
@pytest.mark.parametrize("d", [64, 256])
def test_flash_fwd_window_ring_is_stable(d, window):
    """With a window, the second consumer warpgroup skips the math of its
    query tile's first key tile (every tile from q0 = 128 on) and later
    reuses that ring stage: it must still wait on the skipped phase. Many
    key tiles and 16 repeats over a large grid; every repeat is bit-equal to
    the first, which matches the plain version on the valid rows."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(14)
    b, T, h = 4, 2048, 8
    q, k, v = (torch.randn((b, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    mask[1, :300] = 0
    o, lse = flash_attention(q, k, v, mask, scale=d ** -0.5, window=window, return_lse=True)
    for _ in range(16):
        o2, lse2 = flash_attention(q, k, v, mask, scale=d ** -0.5, window=window, return_lse=True)
        assert torch.equal(o2, o) and torch.equal(lse2, lse)
    ro, rlse = flash_attention_plain(q, k, v, mask, scale=d ** -0.5, window=window, return_lse=True)
    rows = mask.bool()
    torch.testing.assert_close(o[rows].float(), ro[rows].float(), rtol=0, atol=2e-2)
    lrows = rows[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[lrows], rlse[lrows], rtol=0, atol=1e-2)


def test_flash_fwd_then_bwd_kernels_match_plain():
    """The backward kernels (csrc/flash_bwd.cu) on the new forward's o and
    lse, through the autograd Function, against the plain forward and the
    plain backward at [2, 768, 4, 256], left-padded rows, a window-free
    causal walk of 12 key tiles."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd_plain, flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(13)
    b, T, h, d = 2, 768, 4, 256
    q, k, v = (torch.randn((b, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    mask[1, :100] = 0
    rows = mask.bool()
    do = (torch.randn((b, T, h, d), generator=g, device=dev) * rows[:, :, None, None]).to(torch.bfloat16)
    dlse = torch.randn((b, h, T), generator=g, device=dev) * rows[:, None, :]
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = flash_attention(tq, tk, tv, mask, scale=d ** -0.5, return_lse=True)
    dq, dk, dv = torch.autograd.grad((o, lse), (tq, tk, tv), (do, dlse))
    ro, rlse = flash_attention_plain(q, k, v, mask, scale=d ** -0.5, return_lse=True)
    rq, rk, rv = flash_attention_bwd_plain(q, k, v, mask, ro, rlse, do, dlse, scale=d ** -0.5)
    _close(o[rows], ro[rows], 2e-2)
    _close(dq[rows], rq[rows], 2e-2)
    _close(dk, rk, 2e-2)
    _close(dv, rv, 2e-2)


def test_flash_kernel_strided_inputs():
    """q/k/v as views of one fused [b, T, 3, h, d] projection (strided rows)."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((2, 256, 3, 4, 128), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    mask = torch.ones((2, 256), device=dev)
    o = flash_attention(q, k, v, mask, scale=0.1)
    ro = flash_attention_plain(q, k, v, mask, scale=0.1)
    torch.testing.assert_close(o.float(), ro.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("T", [1, 77, 128, 300, 1024])
@pytest.mark.parametrize("d", [128, 256])
def test_decode_kernel_matches_plain(T, d):
    dev = _cuda()
    from trlx_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain

    g = torch.Generator(device=dev).manual_seed(2)
    B, h = 3, 8
    q = torch.randn((B, h, d), generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((B, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    valid[0, : T // 3] = False
    valid[1, T - T // 4:] = False
    if T > 1:
        valid[2] = False  # every key masked: uniform weights
    bias = torch.where(valid, 0.0, -1e9).float()
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, bias, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_plain(q, kc, vc, bias, scale=d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)


def _int8_kv(shape, g, dev):
    """int8 codes and f32 per-key scales [..., h] as quantize_kv makes them."""
    from trlx_tpu_torch.models.lm import quantize_kv

    return quantize_kv(torch.randn(shape, generator=g, device=dev) * 2.0)


@pytest.mark.parametrize("T", [1, 77, 300, 1024])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_int8_decode_kernel_matches_plain(T, d):
    """Row 8: the int8 cache with per-key scales, ragged rows and a fully
    masked row; the scales are strided views of a [B, T, h, 2] buffer (the
    kernel reads them through strides, with no transpose)."""
    dev = _cuda()
    from trlx_tpu_torch.ops.decode_attention import decode_attention, decode_attention_int8, decode_attention_plain

    g = torch.Generator(device=dev).manual_seed(6)
    B, h = 3, 8
    q = torch.randn((B, h, d), generator=g, device=dev).to(torch.bfloat16)
    (kq, ks), (vq, vs) = _int8_kv((B, T, h, d), g, dev), _int8_kv((B, T, h, d), g, dev)
    both = torch.stack([ks, vs], dim=-1)
    ks, vs = both[..., 0], both[..., 1]
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    valid[0, : T // 3] = False
    valid[1, T - T // 4:] = False
    if T > 1:
        valid[2] = False
    bias = torch.where(valid, 0.0, -1e9).float()
    n8, n7 = decode_attention_int8.launches, decode_attention.launches
    out = decode_attention(q, kq, vq, bias, scale=d ** -0.5, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert (decode_attention_int8.launches, decode_attention.launches) == (n8 + 1, n7)
    ref = decode_attention_plain(q, kq, vq, bias, scale=d ** -0.5, ks=ks, vs=vs)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)


def _paged_case(g, dev, S, bs, bps, h, d, quant):
    """A pool with scrambled tables: slots 0 and 1 share their first
    min(2, bps) blocks (a prefix hit), slot S-1 is dead on the trash block 0,
    slot 2 is fully masked, the others ragged."""
    n_blocks = 1 + S * bps
    q = torch.randn((S, h, d), generator=g, device=dev).to(torch.bfloat16)
    shape = (n_blocks, bs, h, d)
    if quant:
        (kp, ks), (vp, vs) = _int8_kv(shape, g, dev), _int8_kv(shape, g, dev)
    else:
        kp, vp = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    perm = torch.randperm(n_blocks - 1, generator=g, device=dev) + 1
    tables = perm[: S * bps].reshape(S, bps).to(torch.int32)
    shared = min(2, bps)
    tables[1, :shared] = tables[0, :shared]
    tables[S - 1] = 0
    T = bps * bs
    valid = torch.ones((S, T), dtype=torch.bool, device=dev)
    valid[0, : bs // 2] = False
    valid[1, T - bs // 3:] = False
    valid[2] = False
    valid[S - 1, T // 2:] = False
    bias = torch.where(valid, 0.0, -1e9).float()
    return q, kp, vp, ks, vs, tables, bias


@pytest.mark.parametrize("bs,bps", [(128, 3), (128, 8), (48, 1)])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-pool", "int8-pool"])
def test_paged_decode_kernels_match_plain(quant, d, bs, bps):
    """Rows 9 and 10: the block-table kernels against the plain version over
    the gathered view pool[tbl]."""
    dev = _cuda()
    from trlx_tpu_torch.ops import decode_attention as dec

    g = torch.Generator(device=dev).manual_seed(7)
    q, kp, vp, ks, vs, tables, bias = _paged_case(g, dev, 5, bs, bps, 8, d, quant)
    counter = dec.paged_decode_attention_int8 if quant else dec.paged_decode_attention
    other = dec.paged_decode_attention if quant else dec.paged_decode_attention_int8
    n, n_other = counter.launches, other.launches
    out = dec.paged_decode_attention(q, kp, vp, tables, bias, scale=d ** -0.5, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert (counter.launches, other.launches) == (n + 1, n_other)
    ref = dec.paged_decode_attention_plain(q, kp, vp, tables, bias, scale=d ** -0.5, ks=ks, vs=vs)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)


def _split_bias(B, T, dev):
    """A bias row per slot that drives the split-T walk's skip rule (splits
    of 128 keys): row 0 a left pad and, past 256 keys, a whole split masked
    in the middle; row 1 no visible key (every split read, uniform); row 2
    one visible key; row 3 visible keys only in its first split, the rest
    masked to the end; row 4, a dead slot, visible in its first half."""
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    valid[0, : min(5, T - 1)] = False
    if T > 256:
        valid[0, 128:256] = False
    if B > 1:
        valid[1] = False
    if B > 2:
        valid[2] = False
        valid[2, T // 2] = True
    if B > 3:
        valid[3, min(T, 100):] = False
    if B > 4:
        valid[4, T // 2:] = False
    return torch.where(valid, 0.0, -1e9).float()


@pytest.mark.parametrize("T", [1, 127, 128, 129, 300, 1024])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_decode_split_walk_matches_plain(quant, B, d, T):
    """Rows 7 and 8 at the split edges (T = 127..129 around one split of
    128), with masked splits mid-row and at the end, a row with no visible
    key and one with a single visible key, for 1 row and for 5 rows of 8
    heads."""
    dev = _cuda()
    from trlx_tpu_torch.ops.decode_attention import decode_attention, decode_attention_int8, decode_attention_plain

    g = torch.Generator(device=dev).manual_seed(9)
    h = 8
    q = torch.randn((B, h, d), generator=g, device=dev).to(torch.bfloat16)
    if quant:
        (kc, ks), (vc, vs) = _int8_kv((B, T, h, d), g, dev), _int8_kv((B, T, h, d), g, dev)
    else:
        kc, vc = (torch.randn((B, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    bias = _split_bias(B, T, dev)
    counter = decode_attention_int8 if quant else decode_attention
    before = counter.launches
    out = decode_attention(q, kc, vc, bias, scale=d ** -0.5, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = decode_attention_plain(q, kc, vc, bias, scale=d ** -0.5, ks=ks, vs=vs)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)


@pytest.mark.parametrize("bs,bps", [(128, 1), (128, 8), (256, 3), (48, 1), (43, 1), (300, 1)])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-pool", "int8-pool"])
def test_paged_split_walk_matches_plain(quant, d, bs, bps):
    """Rows 9 and 10 under the split-T walk at the block sizes the kernel
    takes (``paged_decode_eligible``'s): blocks of 128 or 256 keys, and a
    slot of one block of any size (43, 48, 300), with the skip rule's rows
    over scrambled tables, a prefix shared by slots 0 and 1 and a dead slot
    on the trash block 0."""
    dev = _cuda()
    from trlx_tpu_torch.ops import decode_attention as dec

    g = torch.Generator(device=dev).manual_seed(10)
    S, h = 5, 8
    q, kp, vp, ks, vs, tables, _ = _paged_case(g, dev, S, bs, bps, h, d, quant)
    bias = _split_bias(S, bs * bps, dev)
    counter = dec.paged_decode_attention_int8 if quant else dec.paged_decode_attention
    n = counter.launches
    out = dec.paged_decode_attention(q, kp, vp, tables, bias, scale=d ** -0.5, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert counter.launches == n + 1
    ref = dec.paged_decode_attention_plain(q, kp, vp, tables, bias, scale=d ** -0.5, ks=ks, vs=vs)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)


@pytest.mark.parametrize("variant", ["bf16", "int8", "paged-bf16", "paged-int8"])
def test_decode_split_walk_at_the_smoke_width(variant):
    """All four variants at the smoke's width (8 rows of 16 heads of 256, T
    = 1024, 8 splits a row): left-padded prompts at decode step 128, one
    row with a masked split mid-row, one with no visible key."""
    dev = _cuda()
    from trlx_tpu_torch.ops import decode_attention as dec

    g = torch.Generator(device=dev).manual_seed(11)
    B, T, h, d, bs = 8, 1024, 16, 256, 128
    quant, paged = variant.endswith("int8"), variant.startswith("paged")
    if paged:
        q, kp, vp, ks, vs, tables, _ = _paged_case(g, dev, B, bs, T // bs, h, d, quant)
    else:
        q = torch.randn((B, h, d), generator=g, device=dev).to(torch.bfloat16)
        if quant:
            (kp, ks), (vp, vs) = _int8_kv((B, T, h, d), g, dev), _int8_kv((B, T, h, d), g, dev)
        else:
            kp, vp = (torch.randn((B, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
            ks = vs = None
    pos = torch.arange(T, device=dev)[None, :]
    lens = torch.randint(600, 769, (B,), generator=g, device=dev)
    valid = (pos >= (768 - lens)[:, None]) & (pos <= 768 + 128)
    valid[1, 384:640] = False
    valid[2] = False
    bias = torch.where(valid, 0.0, -1e9).float()
    if paged:
        out = dec.paged_decode_attention(q, kp, vp, tables, bias, scale=d ** -0.5, ks=ks, vs=vs)
        ref = dec.paged_decode_attention_plain(q, kp, vp, tables, bias, scale=d ** -0.5, ks=ks, vs=vs)
    else:
        out = dec.decode_attention(q, kp, vp, bias, scale=d ** -0.5, ks=ks, vs=vs)
        ref = dec.decode_attention_plain(q, kp, vp, bias, scale=d ** -0.5, ks=ks, vs=vs)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)


def test_decode_wrappers_raise_on_what_the_kernels_do_not_take():
    """Rows 8-10 on CUDA tensors: an int8 wrapper given a bf16 cache, a head
    dim with no kernel instance, tables or bias that do not match the pool,
    and a block size that puts a split across blocks all raise; nothing runs
    the plain version."""
    dev = _cuda()
    from trlx_tpu_torch.ops import decode_attention as dec

    g = torch.Generator(device=dev).manual_seed(8)
    q, kp, vp, ks, vs, tables, bias = _paged_case(g, dev, 4, 128, 2, 8, 128, True)
    counters = [f.launches for f in (dec.decode_attention_int8, dec.paged_decode_attention,
                                     dec.paged_decode_attention_int8)]
    with pytest.raises(TypeError):
        dec.paged_decode_attention(q, kp.to(torch.bfloat16), vp.to(torch.bfloat16), tables, bias, scale=1.0,
                                   ks=ks, vs=vs)
    with pytest.raises(ValueError):
        dec.paged_decode_attention(q, kp, vp, tables[:, :1], bias, scale=1.0, ks=ks, vs=vs)
    with pytest.raises(ValueError):
        dec.paged_decode_attention(q[..., :96], kp[..., :96], vp[..., :96], tables, bias, scale=1.0, ks=ks, vs=vs)
    for quant in (False, True):  # a split of 128 keys across blocks of 48
        q48, kp48, vp48, ks48, vs48, tables48, bias48 = _paged_case(g, dev, 4, 48, 3, 8, 128, quant)
        with pytest.raises(ValueError):
            dec.paged_decode_attention(q48, kp48, vp48, tables48, bias48, scale=1.0, ks=ks48, vs=vs48)
    kc, vc, kcs, vcs = (dec.gather_pool(x, tables) for x in (kp, vp, ks, vs))
    with pytest.raises(ValueError):
        dec.decode_attention(q, kc, vc, bias, scale=1.0, ks=kcs[:, :-1], vs=vcs[:, :-1])
    with pytest.raises(TypeError):
        dec.decode_attention(q, kc, vc, bias, scale=1.0, ks=kcs.double(), vs=vcs.double())
    assert [f.launches for f in (dec.decode_attention_int8, dec.paged_decode_attention,
                                 dec.paged_decode_attention_int8)] == counters


@pytest.mark.parametrize("paged,quant", [(True, True), (True, False), (False, True), (False, False)],
                         ids=["paged-int8", "paged-bf16", "fixed-int8", "fixed-bf16"])
def test_engine_on_the_card_matches_the_cpu_engine(paged, quant):
    """A 2-layer bf16 model at widths every decode kernel takes (8 heads of
    128): the engine on the card, whose decode steps run rows 7-10, gives
    the CPU engine's greedy tokens on the same weights and prompts, with
    refills and (paged) a prefix hit. The logits are spread as a trained
    head's, so a greedy choice is not a near tie that bf16 rounding flips."""
    dev = _cuda()
    import numpy as np

    from trlx_tpu_torch.engine import RolloutEngine
    from trlx_tpu_torch.models.heads import LMWithValueHead
    from trlx_tpu_torch.models.hf_import import init_params
    from trlx_tpu_torch.models.lm import LMConfig
    from trlx_tpu_torch.ops import decode_attention as dec
    from trlx_tpu_torch.ops.sampling import GenerateConfig

    cfg = LMConfig(vocab_size=16, n_layer=2, n_head=8, d_model=1024, max_position=512, pos_type="rotary",
                   rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                   tie_word_embeddings=False, extra={"lm_head_bias": True}, kv_cache_quant=quant)
    cpu = LMWithValueHead(cfg, device="cpu")
    init_params(cpu, torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.transformer.lm_head.kernel.mul_(30.0)
    cpu.requires_grad_(False)
    gpu = LMWithValueHead(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    gpu.requires_grad_(False)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, 16, size=(6, 200)).astype(np.int32)
    prompts[3] = prompts[0]  # a whole-prefix repeat: a hit on the paged engine
    mask = np.ones_like(prompts)
    mask[1, :70] = 0
    gcfg = GenerateConfig(max_new_tokens=8, do_sample=False, pad_token_id=0, eos_token_id=None)
    kw = dict(n_slots=2, prompt_width=200, prefill_batch=2, steps_per_sync=4, paged_kv=paged, kv_block_size=128)
    counter = {(True, True): dec.paged_decode_attention_int8, (True, False): dec.paged_decode_attention,
               (False, True): dec.decode_attention_int8, (False, False): dec.decode_attention}[(paged, quant)]
    runs = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        engine = RolloutEngine(model, gcfg, **kw)
        engine.update_weights(model, version=1)
        engine.submit(prompts, mask)
        before = counter.launches
        eps = []
        while not engine.idle:
            eps.extend(engine.step())
        calls = engine.stats(reset=False)["engine/decode_calls"]
        if name == "gpu":
            torch.cuda.synchronize()
            assert counter.launches - before == cfg.n_layer * kw["steps_per_sync"] * calls
        else:
            assert counter.launches == before
        if paged:
            assert engine.pool.hits_total >= 1
        runs[name] = {(tuple(e.prompt_ids.tolist()), tuple(e.prompt_mask.tolist())): e.response_ids for e in eps}
        engine.shutdown()
    assert len(runs["gpu"]) == len(runs["cpu"]) == 5
    for key, toks in runs["cpu"].items():
        np.testing.assert_array_equal(runs["gpu"][key], toks)


# (activation dtype, tied, bias, weight dtype): the bf16 mode with an f32 or
# bf16 weight, and the f32 mode (f32 activations and weight).
_HEAD_MODES = [(torch.bfloat16, False, True, torch.float32), (torch.bfloat16, False, False, torch.bfloat16),
               (torch.bfloat16, True, False, torch.float32), (torch.float32, False, True, torch.float32),
               (torch.float32, False, False, torch.float32), (torch.float32, True, False, torch.float32)]


def _head_counter(xdtype, name):
    from trlx_tpu_torch.ops import fused_logprob as fl

    return getattr(fl, name + ("_f32" if xdtype == torch.float32 else ""))


@pytest.mark.parametrize("xdtype,tied,bias,wdtype", _HEAD_MODES)
@pytest.mark.parametrize("N,V", [(50, 1000), (300, 4097), (300, 50257), (300, 50400)])
def test_fused_logprob_kernel_matches_plain(xdtype, tied, bias, wdtype, N, V):
    """The forward against ``naive_logprob``: bf16 mode within 5e-2 (the
    plain version rounds its logits to bf16), f32 mode within
    1e-4 * max(1, |ref|) with TF32 off; each launch counted under its
    mode's wrapper."""
    dev = _cuda()
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob, naive_logprob

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(3)
    D = 256
    x = torch.randn((N, D), generator=g, device=dev).to(xdtype)
    w = (torch.randn((V, D) if tied else (D, V), generator=g, device=dev) * D ** -0.5).to(wdtype)
    b = torch.randn((V,), generator=g, device=dev) * 0.1 if bias else None
    y = torch.randint(0, V, (N,), generator=g, device=dev)
    counter = _head_counter(xdtype, "fused_logprob_fwd")
    before = counter.launches
    got = fused_logprob(x, w, y, b, tied=tied)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = naive_logprob(x, w, y, b, tied=tied)
    for gv, rv in zip(got, ref):
        assert gv.dtype == torch.float32
        if xdtype == torch.float32:
            assert float(((gv - rv).abs() / rv.abs().clamp(min=1.0)).max()) <= 1e-4
        else:
            torch.testing.assert_close(gv, rv, rtol=0, atol=5e-2)


def _close(got, ref, rel):
    """Max |got - ref| within ``rel`` of max |ref| (bf16 outputs whose
    scale depends on the shape)."""
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    scale = float(ref.abs().max()) + 1e-6
    err = float((got - ref).abs().max())
    assert err <= rel * scale, (err, scale)


# (T, window, left pads per row): the first four cases as before; then the
# TMA + wgmma kernels at the edges of their tiles (dq: 128 queries, 32 or 64
# keys; dk/dv: 64 keys, 64 queries) and at the train lengths, with a
# left-padded row and, at T > 1, a fully masked one (pad = T).
_BWD_CASES = [(128, 0, (0, 37)), (200, 0, (5, 0)), (256, 64, (0, 90)), (77, 8, (0, 30))] + [
    (T, window, (0, T // 3, T) if T > 1 else (0, 0)) for T in (1, 64, 127, 128, 200, 768, 1024) for window in (0, 48)
]


def _bwd_case(dev, seed, b, T, h, d, pads):
    """Seeded q/k/v, a key mask with ``pads[i]`` left-padded slots in row i,
    and dO / dlse cotangents on the valid rows only (padded query rows carry
    none, as in the model: no later position reads them)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, T), device=dev)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    rows = mask.bool()
    do = (torch.randn((b, T, h, d), generator=g, device=dev) * rows[:, :, None, None]).to(torch.bfloat16)
    dlse = torch.randn((b, h, T), generator=g, device=dev) * rows[:, None, :]
    return q, k, v, mask, do, dlse


@pytest.mark.parametrize("T,window,pads", _BWD_CASES)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_kernels_match_plain(T, window, pads, d):
    """dq and dk/dv against the plain backward, with the lse cotangent on.
    Padded query rows carry no cotangent, as in the model (no later position
    reads them), so every row of dk/dv and every valid row of dq compare."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_bwd_dkv, flash_bwd_dq, flash_fwd,
    )

    b, h, scale = len(pads), 4, d ** -0.5
    q, k, v, mask, do, dlse = _bwd_case(dev, 4, b, T, h, d, pads)
    rows = mask.bool()
    o, lse = flash_fwd(q, k, v, mask, scale=scale, window=window)
    n_dq, n_dkv = flash_bwd_dq.launches, flash_bwd_dkv.launches
    dq, dk, dv = flash_attention_bwd(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (n_dq + 1, n_dkv + 1)
    rq, rk, rv = flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
    # bf16 outputs and bf16 P / dS in the products on both sides; the sums
    # run in another order (tiles vs one einsum).
    if rows.any():
        _close(dq[rows], rq[rows], 2e-2)
    _close(dk, rk, 2e-2)
    _close(dv, rv, 2e-2)


@pytest.mark.parametrize("window", [48, 100])
@pytest.mark.parametrize("d", [64, 256])
def test_flash_bwd_window_ring_is_stable(d, window):
    """The backward twin of ``test_flash_fwd_window_ring_is_stable``: with a
    window, a dq consumer warpgroup skips the math of the key tiles its 64
    rows cannot reach and later reuses their ring stage, and the dk/dv walks
    start and end at different query tiles per key tile. Many tiles and 16
    repeats over a large grid; every repeat is bit-equal to the first, which
    matches the plain backward."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_bwd_plain, flash_fwd

    b, T, h = 4, 2048, 8
    q, k, v, mask, do, dlse = _bwd_case(dev, 15, b, T, h, d, (0, 300))
    scale = d ** -0.5
    o, lse = flash_fwd(q, k, v, mask, scale=scale, window=window)
    first = flash_attention_bwd(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
    for _ in range(16):
        again = flash_attention_bwd(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
        assert all(torch.equal(x, y) for x, y in zip(again, first))
    ref = flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, scale=scale, window=window)
    rows = mask.bool()
    _close(first[0][rows], ref[0][rows], 2e-2)
    _close(first[1], ref[1], 2e-2)
    _close(first[2], ref[2], 2e-2)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_is_deterministic(d):
    """No atomics: two calls on the same inputs give bit-equal dq, dk, dv."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_fwd

    q, k, v, mask, do, dlse = _bwd_case(dev, 16, 2, 1024, 4, d, (0, 200))
    o, lse = flash_fwd(q, k, v, mask, scale=d ** -0.5)
    first = flash_attention_bwd(q, k, v, mask, o, lse, do, dlse, scale=d ** -0.5)
    second = flash_attention_bwd(q, k, v, mask, o, lse, do, dlse, scale=d ** -0.5)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("window", [0, 48], ids=["causal", "window48"])
def test_flash_bwd_strided_inputs(window):
    """q/k/v as views of one fused [b, T, 3, h, d] projection (strided rows,
    as the model passes them) through ``FlashAttentionFn``: the gradient of
    the fused tensor against the plain backward."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd_plain

    g = torch.Generator(device=dev).manual_seed(17)
    b, T, h, d = 2, 300, 4, 128
    qkv = torch.randn((b, T, 3, h, d), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    mask = torch.ones((b, T), device=dev)
    mask[1, :40] = 0
    rows = mask.bool()
    do = (torch.randn((b, T, h, d), generator=g, device=dev) * rows[:, :, None, None]).to(torch.bfloat16)
    dlse = torch.randn((b, h, T), generator=g, device=dev) * rows[:, None, :]
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention(q, k, v, mask, scale=d ** -0.5, window=window, return_lse=True)
    (dqkv,) = torch.autograd.grad((o, lse), (qkv,), (do, dlse))
    rq, rk, rv = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), mask, o.detach(), lse.detach(), do,
                                           dlse, scale=d ** -0.5, window=window)
    _close(dqkv[:, :, 0][rows], rq[rows], 2e-2)
    _close(dqkv[:, :, 1], rk, 2e-2)
    _close(dqkv[:, :, 2], rv, 2e-2)


@pytest.mark.parametrize("xdtype,tied,bias,wdtype", _HEAD_MODES + [(torch.bfloat16, True, True, torch.float32),
                                                                     (torch.float32, True, True, torch.float32)])
@pytest.mark.parametrize("N,V", [(50, 1000), (1300, 4097), (300, 50257), (300, 50400)])
def test_fused_logprob_bwd_kernels_match_plain(xdtype, tied, bias, wdtype, N, V):
    """dx, dW and db against the plain backward with all three cotangents:
    ragged N (1300 rows are two chunks of 1024), V not a multiple of the
    256-wide tile (nor of 8 at 4097 and 50257, nor of 4 in f32: the weight's
    rows then need the padded copy for TMA in either mode), logits spread as
    a trained head's (std ~3.5). dW and db are also held on the columns no label
    hits, where ds is only the small softmax terms. bf16 mode: ds is rounded
    to bf16 on both sides before the products, and a sum in another order
    can flip that rounding; dx comes back in bf16. f32 mode: everything in
    f32, 1e-4 of each output's max."""
    _check_head_bwd(xdtype, tied, bias, wdtype, N, V)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_fused_logprob_bwd_f32_zero_filled_last_chunk(tied):
    """The f32 mode at N = 97 rows, as the previous test holds it: not a
    multiple of 32 (nor of 4) and above one promotion group of 64 rows, so
    dW's reduction over the rows ends in a chunk that TMA fills with zeros
    past row 97, and the xᵀ scratch's rows are padded to 100."""
    _check_head_bwd(torch.float32, tied, True, torch.float32, 97, 1000)


def _check_head_bwd(xdtype, tied, bias, wdtype, N, V):
    dev = _cuda()
    from trlx_tpu_torch.ops.fused_logprob import BWD_CHUNK_ROWS, fused_logprob_bwd, fused_logprob_bwd_plain
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = xdtype == torch.float32
    g = torch.Generator(device=dev).manual_seed(5)
    D = 256
    x = torch.randn((N, D), generator=g, device=dev).to(xdtype)
    w = (torch.randn((V, D) if tied else (D, V), generator=g, device=dev) * (3.5 * D ** -0.5)).to(wdtype)
    b = torch.randn((V,), generator=g, device=dev) * 0.1 if bias else None
    y = torch.randint(0, V, (N,), generator=g, device=dev)
    _, lse, ent = fused_logprob_fwd(x, w, y, b, tied=tied)
    dlp, dlse, dent = (torch.randn((N,), generator=g, device=dev) for _ in range(3))
    c_dx, c_dw = _head_counter(xdtype, "fused_logprob_bwd_dx"), _head_counter(xdtype, "fused_logprob_bwd_dw")
    n_dx, n_dw = c_dx.launches, c_dw.launches
    dx, dw, db = fused_logprob_bwd(x, w, b, y, lse, ent, dlp, dlse, dent, tied=tied)
    torch.cuda.synchronize()
    chunks = -(-N // BWD_CHUNK_ROWS)
    assert (c_dx.launches, c_dw.launches) == (n_dx + chunks, n_dw + 1)
    assert dx.dtype == xdtype and dw.dtype == wdtype
    rdx, rdw, rdb = fused_logprob_bwd_plain(x, w, b, y, lse, ent, dlp, dlse, dent, tied=tied)
    rel_dx, rel_dw, rel_db = (1e-4, 1e-4, 1e-4) if f32 else (2e-2, 1e-2, 1e-3)
    _close(dx, rdx, rel_dx)
    _close(dw, rdw, rel_dw)
    if bias:
        assert db.dtype == torch.float32
        _close(db, rdb, rel_db)
    else:
        assert db is None
    unhit = torch.ones(V, dtype=torch.bool, device=dev)
    unhit[y] = False
    _close(dw[unhit] if tied else dw[:, unhit], rdw[unhit] if tied else rdw[:, unhit], rel_dw)
    if bias:
        _close(db[unhit], rdb[unhit], rel_db)


@pytest.mark.parametrize("V", [50400, 50257])
def test_fused_logprob_f32_at_the_q_head_width(V):
    """The f32 mode at the Q heads' width (D = 8192), untied with bias, over
    N = 1300 rows (two backward chunks, the second ragged): the forward
    within 1e-4 · max(1, |ref|) and dx, dW and db within 1e-4 of each one's
    max, against the plain versions with TF32 off. V = 50400 is read in
    place; V = 50257 rows do not start on 16-byte boundaries, so the forward
    and the backward each make the padded TMA-ready copy and then launch the
    3xTF32 kernels (never the plain version)."""
    dev = _cuda()
    from trlx_tpu_torch.ops import fused_logprob as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(13)
    N, D = 1300, 8192
    x = torch.relu(torch.randn((N, D), generator=g, device=dev))
    w = torch.randn((D, V), generator=g, device=dev) * (3.5 * D ** -0.5)
    b = torch.randn((V,), generator=g, device=dev) * 0.1
    y = torch.randint(0, V, (N,), generator=g, device=dev)
    copies = fl.kernel_weight.copies
    launches = (fl.fused_logprob_fwd_f32.launches, fl.fused_logprob_bwd_dx_f32.launches,
                fl.fused_logprob_bwd_dw_f32.launches)
    lp, lse, ent = fl.fused_logprob_fwd(x, w, y, b)
    dlp, dlse, dent = (torch.randn((N,), generator=g, device=dev) for _ in range(3))
    dx, dw, db = fl.fused_logprob_bwd(x, w, b, y, lse, ent, dlp, dlse, dent)
    torch.cuda.synchronize()
    padded = V % 4 != 0
    assert fl.kernel_weight.copies == copies + (2 if padded else 0)
    assert (fl.fused_logprob_fwd_f32.launches, fl.fused_logprob_bwd_dx_f32.launches,
            fl.fused_logprob_bwd_dw_f32.launches) == (launches[0] + 1, launches[1] + 2, launches[2] + 1)
    for got, ref in zip((lp, lse, ent), fl.naive_logprob(x, w, y, b)):
        assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= 1e-4
    rdx, rdw, rdb = fl.fused_logprob_bwd_plain(x, w, b, y, lse, ent, dlp, dlse, dent)
    for got, ref in ((dx, rdx), (dw, rdw), (db, rdb)):
        assert got.dtype == torch.float32
        _close(got, ref, 1e-4)


def _dw_case(g, dev, N, D, V, tied, bias):
    """Backward inputs with logits spread as a trained head's."""
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_fwd

    x = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((V, D) if tied else (D, V), generator=g, device=dev) * (3.5 * D ** -0.5)
    b = torch.randn((V,), generator=g, device=dev) * 0.1 if bias else None
    y = torch.randint(0, V, (N,), generator=g, device=dev)
    _, lse, ent = fused_logprob_fwd(x, w, y, b, tied=tied)
    return (x, w, b, y, lse, ent, *(torch.randn((N,), generator=g, device=dev) for _ in range(3)))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("V", [4097, 50257, 50400])
@pytest.mark.parametrize("rows", [64, 1000, 2048])
def test_fused_logprob_dw_kernel_matches_plain(rows, V, tied, bias):
    """Row 6, the dW/db kernel on the wgmma mainloop (both operands
    MN-major, one launch over all rows, a persistent grid): dW and db
    against the plain backward on all columns and on the columns no label
    hits, at row counts that are and are not multiples of 64 and 128, and
    vocabularies that are not multiples of 256, 128 or 8; launched once."""
    dev = _cuda()
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_bwd, fused_logprob_bwd_dw, fused_logprob_bwd_plain

    g = torch.Generator(device=dev).manual_seed(rows + V)
    args = _dw_case(g, dev, rows, 256, V, tied, bias)
    n_dw = fused_logprob_bwd_dw.launches
    _, dw, db = fused_logprob_bwd(*args, tied=tied)
    torch.cuda.synchronize()
    assert fused_logprob_bwd_dw.launches == n_dw + 1
    _, rdw, rdb = fused_logprob_bwd_plain(*args, tied=tied)
    assert dw.shape == rdw.shape and dw.dtype == torch.float32
    _close(dw, rdw, 1e-2)
    unhit = torch.ones(V, dtype=torch.bool, device=dev)
    unhit[args[3]] = False
    _close(dw[unhit] if tied else dw[:, unhit], rdw[unhit] if tied else rdw[:, unhit], 1e-2)
    if bias:
        _close(db, rdb, 1e-3)
        _close(db[unhit], rdb[unhit], 1e-3)
    else:
        assert db is None


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_fused_logprob_bwd_second_call_bit_equal(tied):
    """No atomics: a second backward call on the same inputs gives the same
    bits, over two chunks and a vocabulary tail, with the f32 weight cast by
    the wrapper and with the forward's bf16 copy handed in."""
    dev = _cuda()
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_bwd, fused_logprob_fwd, kernel_weight

    g = torch.Generator(device=dev).manual_seed(9)
    N, D, V = 1300, 256, 50257
    x = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((V, D) if tied else (D, V), generator=g, device=dev) * (3.5 * D ** -0.5)
    b = torch.randn((V,), generator=g, device=dev) * 0.1
    y = torch.randint(0, V, (N,), generator=g, device=dev)
    _, lse, ent = fused_logprob_fwd(x, w, y, b, tied=tied)
    cts = [torch.randn((N,), generator=g, device=dev) for _ in range(3)]
    first = fused_logprob_bwd(x, w, b, y, lse, ent, *cts, tied=tied)
    again = fused_logprob_bwd(x, w, b, y, lse, ent, *cts, tied=tied)
    handed = fused_logprob_bwd(x, w, b, y, lse, ent, *cts, tied=tied, wk=kernel_weight(w))
    torch.cuda.synchronize()
    for a, c, h in zip(first, again, handed):
        assert torch.equal(a, c) and torch.equal(a, h)


def test_wrappers_raise_instead_of_falling_back():
    """A CUDA tensor the kernel does not take raises; nothing drops to the
    plain version."""
    dev = _cuda()
    from trlx_tpu_torch.ops.decode_attention import decode_attention
    from trlx_tpu_torch.ops.flash_attention import flash_attention
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob

    q = torch.randn((1, 64, 2, 64), device=dev)  # float32: the kernels take bf16
    with pytest.raises(TypeError):
        flash_attention(q, q, q, torch.ones((1, 64), device=dev), scale=1.0)
    with pytest.raises(TypeError):
        decode_attention(q[:, 0], q, q, torch.zeros((1, 64), device=dev), scale=1.0)
    labels = torch.zeros((4,), dtype=torch.int32, device=dev)
    # f16 activations: neither mode of the fused head takes them.
    with pytest.raises(TypeError):
        fused_logprob(torch.randn((4, 64), device=dev).half(), torch.randn((64, 600), device=dev), labels)
    # The f32 mode takes an f32 weight only: nothing is cast for it.
    with pytest.raises(TypeError):
        fused_logprob(torch.randn((4, 64), device=dev), torch.randn((64, 600), device=dev).to(torch.bfloat16),
                      labels)
    qb = q.to(torch.bfloat16)[..., :48]  # head_dim 48: no kernel instance
    with pytest.raises(ValueError):
        flash_attention(qb, qb, qb, torch.ones((1, 64), device=dev), scale=1.0)
    from trlx_tpu_torch.ops.w8a16 import w8a16_matmul

    kq = torch.zeros((64, 32), dtype=torch.int8, device=dev)
    scale = torch.ones((32,), device=dev)
    with pytest.raises(TypeError):  # f32 activations: the W8 kernel takes bf16
        w8a16_matmul(torch.randn((4, 64), device=dev), kq, scale)
    with pytest.raises(ValueError):  # N % 16 != 0
        w8a16_matmul(torch.randn((4, 64), device=dev).to(torch.bfloat16), kq[:, :24].contiguous(), scale[:24])


def test_model_routes_through_kernels():
    """A bf16 model on the card: a long aligned prefill goes through the
    flash kernel in every layer, each decode step through the decode kernel,
    and the eligible fused head through the logprob kernel."""
    dev = _cuda()
    from trlx_tpu_torch.models.heads import LMWithValueHead
    from trlx_tpu_torch.models.hf_import import init_params
    from trlx_tpu_torch.models.lm import LMConfig, init_cache
    from trlx_tpu_torch.ops.decode_attention import decode_attention
    from trlx_tpu_torch.ops.flash_attention import flash_fwd
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_fwd

    cfg = LMConfig(vocab_size=1024, n_layer=2, n_head=8, d_model=1024, max_position=512, pos_type="rotary",
                   rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                   tie_word_embeddings=False, extra={"lm_head_bias": True})
    model = LMWithValueHead(cfg, branch_layer=1, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    B, P = 2, 256
    ids = torch.randint(0, 1024, (B, P), device=dev, dtype=torch.int32)
    pmask = torch.ones((B, P), dtype=torch.int32, device=dev)
    cache = init_cache(cfg, B, P + 1, dev)
    cmask = torch.cat([pmask, torch.zeros((B, 1), dtype=torch.int32, device=dev)], 1)
    f0, d0, l0 = flash_fwd.launches, decode_attention.launches, fused_logprob_fwd.launches
    with torch.no_grad():
        out = model(ids, pmask, cache=cache, cache_index=0, cache_mask=cmask)
        cmask[:, P] = 1
        step = model(ids[:, :1], torch.ones((B, 1), dtype=torch.int32, device=dev), cache=out["cache"],
                     cache_index=P, cache_mask=cmask)
        lp = model(ids, pmask, labels=ids[:, 1:])["logprobs"]
    torch.cuda.synchronize()
    assert flash_fwd.launches - f0 == 2 * cfg.n_layer
    assert decode_attention.launches - d0 == cfg.n_layer
    assert fused_logprob_fwd.launches - l0 == 1
    assert torch.isfinite(step["logits"].float()).all() and torch.isfinite(lp).all()


def test_generate_eos_exit_on_the_card():
    """With eos set, the decode loop on the card polls "every row finished"
    without waiting for the device. Tokens, mask and stats equal the CPU
    run's, which checks the flag at once, and the loop still stops well
    before max_new_tokens. Float32 model, too small for any kernel."""
    dev = _cuda()
    from trlx_tpu_torch.models.hf_import import init_params
    from trlx_tpu_torch.models.lm import LMConfig, TransformerLM
    from trlx_tpu_torch.ops.generate import make_generate_fn
    from trlx_tpu_torch.ops.sampling import GenerateConfig, make_bigram_mask_processor

    V, eos, N = 64, 40, 48
    cfg = LMConfig.from_dict(dict(vocab_size=V, n_layer=2, n_head=2, d_model=32, max_position=128,
                                  dtype="float32", param_dtype="float32"))
    cpu_model = TransformerLM(cfg, device="cpu")
    init_params(cpu_model, torch.Generator().manual_seed(0))
    gpu_model = TransformerLM(cfg, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    # Each token's one allowed successor is the next id: a row whose prompt
    # ends in token t emits eos at step eos - t - 1.
    forbid = torch.ones((V, V), dtype=torch.bool)
    forbid[torch.arange(V), (torch.arange(V) + 1) % V] = False
    ids = torch.tensor([[3, 5, 30], [7, 9, 35], [1, 2, 38]])
    gcfg = GenerateConfig(max_new_tokens=N, do_sample=True, eos_token_id=eos)

    def stats_fn(tok, s):
        return {"lp": torch.log_softmax(s["last_logits"], -1).gather(-1, tok[:, None].long())[:, 0]}

    runs = []
    for model, gen in ((cpu_model, torch.Generator()), (gpu_model, torch.Generator(device=dev))):
        fn = make_generate_fn(model, gcfg, processor=make_bigram_mask_processor(forbid), step_stats_fn=stats_fn)
        tokens, mask, stats = fn(ids, torch.ones_like(ids), gen.manual_seed(0))
        # The decode steps the loop ran: the step counter a replay advances on the card.
        runs.append((tokens.cpu(), mask.cpu(), stats["lp"].cpu(), int(fn.keywords["_keep"]["buffers"]["step"])))
    (ct, cm, clp, c_steps), (gt, gm, glp, g_steps) = runs
    assert torch.equal(ct, gt) and torch.equal(cm, gm)
    assert cm[:, 3:].sum(1).tolist() == [10, 5, 2]
    torch.testing.assert_close(glp, clp, rtol=0, atol=1e-4)
    assert c_steps == 10  # steps 0..9; all rows finished at step 9
    assert 10 <= g_steps < N


def _graph_model(dev, quant=False):
    """A bf16 hydra model at widths every decode kernel takes (8 heads of
    128, rotary, 2 layers, the top one trained), logits spread as a trained
    head's so greedy choices are no near ties; and its optimizer."""
    from trlx_tpu_torch.models.heads import LMWithValueHead, trainable_mask
    from trlx_tpu_torch.models.hf_import import init_params
    from trlx_tpu_torch.models.lm import LMConfig
    from trlx_tpu_torch.trainer.base import ClippedAdamW

    cfg = LMConfig(vocab_size=64, n_layer=2, n_head=8, d_model=1024, max_position=512, pos_type="rotary",
                   rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                   tie_word_embeddings=False, extra={"lm_head_bias": True}, kv_cache_quant=quant)
    model = LMWithValueHead(cfg, branch_layer=1, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        model.transformer.lm_head.kernel.mul_(30.0)
    keep = trainable_mask(model, cfg, 1)
    for name, p in model.named_parameters():
        p.requires_grad_(name in keep)
    params = [p for p in model.parameters() if p.requires_grad]
    return model, params, ClippedAdamW(params, lambda k: 1e-2, 0.9, 0.95, 0.0, 1.0)


def _optimizer_step(params, opt, seed):
    g = torch.Generator(device=params[0].device).manual_seed(seed)
    opt.step(params, [torch.randn(p.shape, generator=g, device=p.device) for p in params])


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_generate_graph_equals_eager(sample):
    """The chunked sampler's CUDA graph route against its eager route: the
    same tokens, masks and stats, bit for bit, and the same launches; again
    after an optimizer step (the graph reads the refreshed bf16 copies);
    sampled from equal generator states, which both leave equal."""
    dev = _cuda()
    from functools import partial

    from trlx_tpu_torch.ops.cuda_graph import launch_counters
    from trlx_tpu_torch.ops.decode_attention import decode_attention
    from trlx_tpu_torch.ops.generate import make_generate_fn
    from trlx_tpu_torch.ops.sampling import GenerateConfig

    model, params, opt = _graph_model(dev)
    gcfg = GenerateConfig(max_new_tokens=24, do_sample=sample, temperature=0.7, top_p=0.9)

    def stats_fn(tok, s):
        return {"lp": torch.log_softmax(s["last_logits"], -1).gather(-1, tok[:, None].long())[:, 0],
                "value": s["carry"]["values"], "branch_hidden": s["carry"]["branch_hidden"]}

    graph = make_generate_fn(model, gcfg, step_stats_fn=stats_fn, carry_keys=("values", "branch_hidden"),
                             apply_kwargs={"collect_branch_hidden": True})
    eager = partial(graph.func, *graph.args, **{**graph.keywords, "_keep": {}, "_eager": True})
    ids = torch.randint(1, 64, (4, 256), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    pmask = torch.ones_like(ids)
    pmask[1, :100] = 0
    counters = launch_counters()
    for k in range(3):
        if k == 2:
            _optimizer_step(params, opt, 5)
        runs = {}
        for name, fn in (("eager", eager), ("graph", graph)):
            gen = torch.Generator(device=dev).manual_seed(11)
            before = [c.launches for c in counters]
            out = fn(ids, pmask, gen)
            torch.cuda.synchronize()
            runs[name] = (out, [c.launches - b for c, b in zip(counters, before)], gen.get_state())
        (eo, el, es), (go, gl, gs) = runs["eager"], runs["graph"]
        assert torch.equal(eo[0], go[0]) and torch.equal(eo[1], go[1])
        assert all(torch.equal(eo[2][key], go[2][key]) for key in eo[2])
        assert el == gl and el[counters.index(decode_attention)] == 2 * 24  # both layers, every step
        assert torch.equal(es, gs)
    assert graph.keywords["_keep"]["buffers"]["graph"] is not None


@pytest.mark.parametrize("paged,quant", [(True, True), (False, False)], ids=["paged-int8", "fixed-bf16"])
def test_engine_graph_equals_eager(paged, quant):
    """The engine's CUDA graph of a decode call against its eager calls:
    the same episodes, bit for bit, with refills, and the same launches;
    again after an optimizer step handed over as a new version."""
    dev = _cuda()
    import numpy as np

    from trlx_tpu_torch.engine import RolloutEngine
    from trlx_tpu_torch.ops.cuda_graph import launch_counters
    from trlx_tpu_torch.ops.sampling import GenerateConfig

    model, params, opt = _graph_model(dev, quant)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, 64, size=(6, 200)).astype(np.int32)
    prompts[3] = prompts[0]
    mask = np.ones_like(prompts)
    mask[1, :70] = 0
    gcfg = GenerateConfig(max_new_tokens=16, do_sample=False)
    kw = dict(n_slots=4, prompt_width=200, prefill_batch=2, steps_per_sync=4, paged_kv=paged, kv_block_size=128)
    engines = {name: RolloutEngine(model, gcfg, **kw, _eager=name == "eager") for name in ("eager", "graph")}
    counters = launch_counters()
    for version in (1, 2):
        if version == 2:
            _optimizer_step(params, opt, 6)
        runs = {}
        for name, engine in engines.items():
            engine.update_weights(model, version=version)
            engine.submit(prompts, mask)
            before = [c.launches for c in counters]
            eps = []
            while not engine.idle:
                eps.extend(engine.step())
            torch.cuda.synchronize()
            runs[name] = ({(tuple(e.prompt_ids.tolist()), tuple(e.prompt_mask.tolist())): e.response_ids
                           for e in eps}, [c.launches - b for c, b in zip(counters, before)])
        (er, el), (gr, gl) = runs["eager"], runs["graph"]
        assert len(er) == 5 and er.keys() == gr.keys()
        for key in er:
            np.testing.assert_array_equal(gr[key], er[key])
        assert el == gl and sum(el) > 0
    assert engines["graph"]._graph is not None
    for engine in engines.values():
        engine.shutdown()


def _w8_check(M, K, N, bias, dev):
    from trlx_tpu_torch.ops.w8a16 import quantize_channels, w8a16_matmul, w8a16_plain

    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    kq, scale = quantize_channels(torch.randn((K, N), generator=g, device=dev) * K ** -0.5)
    b = torch.randn((N,), generator=g, device=dev) if bias else None
    before = w8a16_matmul.launches
    y = w8a16_matmul(x, kq, scale, b)
    y2 = w8a16_matmul(x, kq, scale, b)
    torch.cuda.synchronize()
    assert w8a16_matmul.launches == before + 2
    ref = w8a16_plain(x, kq, scale, b)
    assert y.shape == (M, N) and y.dtype == torch.bfloat16 and torch.equal(y, y2)
    err = (y.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    assert err <= max(1e-2 * top, 3 * 2.0 ** (math.floor(math.log2(top)) - 7)), err


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("M", [1, 8, 13, 16, 33, 64, 65, 200, 255, 256, 1000])
@pytest.mark.parametrize("K,N", [(64, 16), (200, 400), (1024, 4096), (4096, 1040), (256, 16384)])
def test_w8a16_kernel_matches_plain(M, K, N, bias):
    """The W8A16 product against ``w8a16_plain`` at the edges of its tilings
    (x tiles of 8, 32, 64 and 128 rows, 128 or 64 weight columns; K split
    over a cluster or not; the wide kernel from M = 65 at N = 4096), with
    masked edges in M, N (not a multiple of 128) and K (not a multiple of
    64), within 1e-2 of max |y| and never less than three bf16 ulps of it
    (the kernel's f32 sums run in another order, a sum near a bf16 boundary
    rounds either way, and QDense's scale and bias round twice more, so an
    output may move by two ulps); a second call is bit-equal."""
    _w8_check(M, K, N, bias, _cuda())


@pytest.mark.parametrize("M,K,N", [(65, 200, 33808), (1000, 200, 8208), (1669, 4096, 8208)])
def test_w8a16_wide_tiles_match_plain(M, K, N):
    """The two-warpgroup tiling on its persistent grid (more tiles than SMs,
    a partial last column tile, one or 14 row tiles) against the plain
    version, as above."""
    dev = _cuda()
    from trlx_tpu_torch.ops.w8a16 import launch_plan

    assert launch_plan(M, N, K, dev)[2] == 2
    _w8_check(M, K, N, True, dev)


def test_w8a16_cluster_counts_of_the_card():
    """The clusters of s CTAs the card runs at once for every swap tiling,
    which ``plan`` reads: on an H100 SXM (132 SMs) its GPCs hold 66 of 2 but
    only 30 of 4 (the table the CPU tests' model of ``plan`` takes), and at
    GPT-J-6B's 4096 x 4096 decode shape the launch is 64 narrow tiles split
    2 ways."""
    dev = _cuda()
    from trlx_tpu_torch.ops.w8a16 import BX_SIZES, launch_plan, max_clusters, tile_cols

    for bx in BX_SIZES:
        got = max_clusters(dev, bx)
        assert set(got) == {(c, s) for c in tile_cols(bx) for s in range(2, 9)}
        assert all(n >= 1 for n in got.values()), got
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        h100 = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
        assert max_clusters(dev, 8) == {(c, s): n for c in (64, 128) for s, n in h100.items()}
        assert launch_plan(8, 4096, 4096, dev) == (8, 64, 1, 2, 64)


@pytest.mark.parametrize("M,K,N", [(8, 4096, 4096), (8, 16384, 4096), (8, 4096, 16384), (8, 4096, 50400),
                                   (40, 4096, 4096), (13, 200, 400)])
def test_w8a16_decode_graph_replay_bit_equal(M, K, N):
    """A decode-shape product (one launch: a K-split cluster, or the
    persistent grid) captured in a CUDA graph: two replays give the eager
    call's bits."""
    dev = _cuda()
    from trlx_tpu_torch.ops.w8a16 import quantize_channels, w8a16_matmul

    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    kq, scale = quantize_channels(torch.randn((K, N), generator=g, device=dev) * K ** -0.5)
    b = torch.randn((N,), generator=g, device=dev)
    eager = w8a16_matmul(x, kq, scale, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w8a16_matmul(x, kq, scale, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = w8a16_matmul.launches
    with torch.cuda.graph(graph):
        out = w8a16_matmul(x, kq, scale, b)
    assert w8a16_matmul.launches == before + 1  # one launch a product
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, eager) and torch.equal(out, eager)


def _w8_graph_model(dev):
    from trlx_tpu_torch.ops.w8a16 import quantize_weights

    model, params, opt = _graph_model(dev)
    assert quantize_weights(model) == 2 * 6 + 1  # q k v out fc proj a layer, and lm_head
    return model, params, opt


def test_w8_generate_graph_reads_requantized_weights():
    """W8A16 decode on the chunked sampler: the graph route equals the eager
    route bit for bit, every product of prefill and decode goes through the
    W8 kernel (13 a forward), and after an optimizer step the int8 copies
    are re-quantized in place (same addresses, new codes) and the replayed
    graph reads them (graph still equals eager)."""
    dev = _cuda()
    from functools import partial

    from trlx_tpu_torch.ops.generate import make_generate_fn
    from trlx_tpu_torch.ops.sampling import GenerateConfig
    from trlx_tpu_torch.ops.w8a16 import quantized_weights, w8a16_matmul

    model, params, opt = _w8_graph_model(dev)
    N = 16
    graph = make_generate_fn(model, GenerateConfig(max_new_tokens=N, do_sample=False))
    eager = partial(graph.func, *graph.args, **{**graph.keywords, "_keep": {}, "_eager": True})
    ids = torch.randint(1, 64, (4, 256), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    pmask = torch.ones_like(ids)
    qw0 = {k: (kq.data_ptr(), kq.clone()) for k, (kq, _) in quantized_weights(model).items()}
    for k in range(3):
        if k == 2:
            _optimizer_step(params, opt, 5)
        out = {}
        for name, fn in (("eager", eager), ("graph", graph)):
            before = w8a16_matmul.launches
            out[name] = fn(ids, pmask, None)
            torch.cuda.synchronize()
            assert w8a16_matmul.launches - before == 13 * (1 + N)
        assert torch.equal(out["eager"][0], out["graph"][0])
    qw = quantized_weights(model)
    assert all(qw[k][0].data_ptr() == ptr for k, (ptr, _) in qw0.items())
    assert not torch.equal(qw["transformer.h_1.mlp.c_fc"][0], qw0["transformer.h_1.mlp.c_fc"][1])
    assert torch.equal(qw["transformer.h_0.mlp.c_fc"][0], qw0["transformer.h_0.mlp.c_fc"][1])  # frozen layer


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_engine_spec_greedy_and_graph(paged):
    """The speculative engine on the card: its verify call replayed as a
    CUDA graph equals its eager calls bit for bit, and its greedy tokens
    equal the non-speculative engine's (logits spread as a trained head's,
    so the verify window's einsum attention and the decode kernels do not
    split a near tie)."""
    dev = _cuda()
    import numpy as np

    from trlx_tpu_torch.engine import RolloutEngine
    from trlx_tpu_torch.ops.sampling import GenerateConfig

    model, _, _ = _graph_model(dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, 64, size=(6, 200)).astype(np.int32)
    mask = np.ones_like(prompts)
    mask[1, :70] = 0
    gcfg = GenerateConfig(max_new_tokens=16, do_sample=False)
    kw = dict(n_slots=4, prompt_width=200, prefill_batch=2, steps_per_sync=4, paged_kv=paged, kv_block_size=128)
    engines = {"off": RolloutEngine(model, gcfg, **kw),
               "eager": RolloutEngine(model, gcfg, **kw, spec_decode="ngram", spec_k=4, _eager=True),
               "graph": RolloutEngine(model, gcfg, **kw, spec_decode="ngram", spec_k=4)}
    runs = {}
    for name, engine in engines.items():
        engine.update_weights(model, version=1)
        engine.submit(prompts, mask)
        eps = []
        while not engine.idle:
            eps.extend(engine.step())
        torch.cuda.synchronize()
        runs[name] = {tuple(e.prompt_ids.tolist()) + tuple(e.prompt_mask.tolist()): e.response_ids for e in eps}
        assert len(runs[name]) == 6
    for key in runs["off"]:
        np.testing.assert_array_equal(runs["graph"][key], runs["eager"][key])
        np.testing.assert_array_equal(runs["graph"][key], runs["off"][key])
    assert engines["graph"]._graph is not None
    assert engines["graph"].stats()["engine/spec_accept_rate"] > 0
    for engine in engines.values():
        engine.shutdown()


def test_soft_prompt_backward_skips_the_frozen_heads_dw():
    """A soft-prompt model on the card: the gradient reaches the prefix
    through the flash backward of every layer and the fused head's ds + dx,
    and the frozen LM head launches no dW/db kernel; the prefix's gradient
    equals the plain route's (float32 model on the CPU, same weights) within
    bf16 tolerance."""
    dev = _cuda()
    from trlx_tpu_torch.models.heads import LMWithValueHead
    from trlx_tpu_torch.models.hf_import import init_params
    from trlx_tpu_torch.models.lm import LMConfig
    from trlx_tpu_torch.ops.flash_attention import flash_bwd_dq
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_bwd_dw, fused_logprob_bwd_dx

    arch = dict(vocab_size=1024, n_layer=2, n_head=8, d_model=1024, max_position=512, pos_type="rotary",
                rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                tie_word_embeddings=False, extra={"lm_head_bias": True}, n_soft_tokens=8)
    grads = {}
    for name, device, dtype in (("card", dev, "bfloat16"), ("cpu", "cpu", "float32")):
        cfg = LMConfig(**arch, dtype=dtype)
        model = LMWithValueHead(cfg, device=device)
        init_params(model, torch.Generator(device=device).manual_seed(0))
        if name == "cpu":
            model.load_state_dict({k: v.cpu() for k, v in ref_state.items()})
        else:
            ref_state = model.state_dict()
        for n, p in model.named_parameters():
            p.requires_grad_(n == "transformer.soft_prompt")
        ids = torch.randint(0, 1024, (2, 248), generator=torch.Generator().manual_seed(1)).to(device)
        mask = torch.ones_like(ids)
        before = (flash_bwd_dq.launches, fused_logprob_bwd_dx.launches, fused_logprob_bwd_dw.launches)
        lp = model(ids, mask, logits_start=0, labels=ids[:, 1:])["logprobs"]
        lp.sum().backward()
        if name == "card":
            torch.cuda.synchronize()
            dq, dx, dw = (a - b for a, b in zip((flash_bwd_dq.launches, fused_logprob_bwd_dx.launches,
                                                 fused_logprob_bwd_dw.launches), before))
            assert (dq, dw) == (2, 0) and dx >= 1
        grads[name] = model.transformer.soft_prompt.grad.float().cpu()
    ref = grads["cpu"]
    assert torch.isfinite(grads["card"]).all()
    assert (grads["card"] - ref).abs().max() <= 5e-2 * ref.abs().max()


def test_train_on_the_card(tmp_path):
    """A small end-to-end ``trlx_tpu_torch.train`` on the card, at widths
    every kernel takes (T = 256, head_dim 128, d_model 1024, V = 1024): the
    train steps go through the flash and fused-logprob backward kernels,
    every logged loss is finite, no step is skipped, and step 1's ratio is
    1 (the policy is the rollout policy)."""
    dev = _cuda()
    import json

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq
    from trlx_tpu_torch.ops.fused_logprob import fused_logprob_bwd_dw, fused_logprob_bwd_dx

    P, R, V = 192, 64, 1024
    arch = dict(vocab_size=V, n_layer=2, n_head=8, d_model=1024, max_position=512, pos_type="rotary",
                rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                tie_word_embeddings=False, extra={"lm_head_bias": True})
    config = TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1, model_arch=arch,
                      dtype="bfloat16", param_dtype="float32", remat=True),
        "train": dict(total_steps=8, seq_length=P + R, epochs=2, batch_size=8, lr_ramp_steps=1, lr_decay_steps=100,
                      weight_decay=1e-6, learning_rate_init=1e-4, learning_rate_target=1e-4,
                      checkpoint_interval=10**6, eval_interval=10**6, checkpoint_dir=str(tmp_path), seed=3),
        "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=2,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0, top_p=0.9,
                                       temperature=0.7, do_sample=True)),
    })
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, size=int(rng.integers(100, P + 1))).tolist() for _ in range(16)]
    counters = (flash_bwd_dq, flash_bwd_dkv, fused_logprob_bwd_dx, fused_logprob_bwd_dw)
    before = [c.launches for c in counters]
    trainer = trlx_tpu_torch.train(reward_fn=lambda s: [float(np.mean(np.asarray(x) % 2)) for x in s],
                                   prompts=prompts, config=config)
    torch.cuda.synchronize()
    assert trainer.device == dev and trainer.iter_count == 8
    assert [c.launches - b for c, b in zip(counters, before)] == [8 * 2, 8 * 2, 8, 8]
    with open(tmp_path / "metrics.jsonl") as f:
        steps = [r for r in map(json.loads, f) if "loss" in r]
    assert len(steps) == 8
    assert all(np.isfinite(r["loss"]) and r["resilience/nonfinite"] == 0.0 for r in steps)
    assert abs(steps[0]["mean_ratio"] - 1.0) < 0.05


def test_ilql_step_on_the_card_matches_the_cpu(tmp_path):
    """One ILQL train step on the card equals the same step on the CPU, at a
    small width the kernels take (d_model 512, V = 1024, T = 256, b = 4):
    f32 compute, the fused route on both (the card runs the fused head's f32
    kernels for the AWAC LM head and both Q heads, the CPU their plain
    versions; attention takes the einsum path at f32), from the same
    weights, targets and batch. The loss terms and grad_norm agree within
    1e-4 relative; every gradient the optimizer receives within 2e-3 of its
    max and at a cosine of at least 1 - 1e-6 (a ReLU of a head's first layer
    whose pre-activation lies within rounding of 0 takes the other side on
    the other device and moves that row's share of the gradient: up to
    9.7e-4 of the max on one H100); the Adam update itself is compared
    through its inputs (on a first step it is ~sign(g), which rounding can
    flip where g is ~0). The Polyak sync leaves each target at
    lerp(target, online, alpha) on the card as on the CPU."""
    dev = _cuda()
    import numpy as np

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.ops import fused_logprob as fl
    from trlx_tpu_torch.orchestrator.offline_orchestrator import OfflineOrchestrator
    from trlx_tpu_torch.trainer.ilql import ILQLTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T, V = 256, 1024
    arch = dict(vocab_size=V, n_layer=2, n_head=4, d_model=512, max_position=512, pos_type="rotary",
                rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                tie_word_embeddings=False, extra={"lm_head_bias": True, "fused_logprob": "force"},
                eos_token_id=None)
    config = TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type="ilql", num_layers_unfrozen=1, model_arch=arch,
                      dtype="float32", param_dtype="float32"),
        "train": dict(total_steps=1, seq_length=T, epochs=1, batch_size=4, lr_ramp_steps=0, lr_decay_steps=100,
                      weight_decay=1e-6, learning_rate_init=1e-3, learning_rate_target=1e-3,
                      checkpoint_dir=str(tmp_path), seed=3, orchestrator="OfflineOrchestrator"),
        "method": dict(name="ilqlconfig", alpha=0.1, steps_for_target_q_sync=1,
                       gen_kwargs=dict(prompt_length=T - 16, max_new_tokens=16)),
    })
    rng = np.random.default_rng(0)
    samples = [rng.integers(0, V, size=T).astype(np.int32) for _ in range(4)]
    rewards = rng.normal(size=(4,)).tolist()
    runs = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        trainer = ILQLTrainer(config, device=device)
        if name == "gpu":
            trainer.load_params(runs["cpu"]["init"], runs["cpu"]["init_extras"])
        OfflineOrchestrator(trainer).make_experience(samples, rewards)
        batch = trainer.put_batch(next(iter(trainer.store.create_loader(4, shuffle=False))))
        init = {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
        init_extras = {n: t.cpu().clone() for n, t in trainer.extras.items()}
        grads, step = {}, trainer.optimizer.step
        names = {id(p): n for n, p in trainer.model.named_parameters()}

        def recording_step(params, gs, step=step, grads=grads):
            grads.update((names[id(p)], g.detach().cpu().clone()) for p, g in zip(params, gs))
            return step(params, gs)

        trainer.optimizer.step = recording_step
        before = fl.fused_logprob_fwd_f32.launches
        stats = {k: float(v) for k, v in trainer.train_step(batch).items()}
        online = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if n in trainer.extras}
        trainer.iter_count = 1
        trainer.post_backward_callback(stats)
        if name == "gpu":
            torch.cuda.synchronize()
            assert fl.fused_logprob_fwd_f32.launches - before == 3
        for n, t in trainer.extras.items():
            want = torch.lerp(init_extras[n].to(t.device), online[n], 0.1)
            torch.testing.assert_close(t, want, rtol=1e-6, atol=1e-7, msg=n)
        runs[name] = dict(init=init, init_extras=init_extras, stats=stats, grads=grads)
    cpu, gpu = runs["cpu"], runs["gpu"]
    for k in ("losses/loss", "losses/loss_q", "losses/loss_v", "losses/loss_cql", "losses/loss_awac", "grad_norm"):
        np.testing.assert_allclose(gpu["stats"][k], cpu["stats"][k], rtol=1e-4, err_msg=k)
    assert sorted(gpu["grads"]) == sorted(cpu["grads"]) and gpu["grads"]
    errs = {}
    for n, c in cpu["grads"].items():
        g = gpu["grads"][n].double()
        assert torch.isfinite(g).all()
        cos = float(torch.nn.functional.cosine_similarity(g.reshape(-1), c.double().reshape(-1), dim=0))
        errs[n] = (float((g - c).abs().max()) / (float(c.abs().max()) + 1e-12), cos)
    bad = {n: e for n, e in errs.items() if not (e[0] <= 2e-3 and e[1] >= 1 - 1e-6)}
    assert not bad, bad


def _ckpt_trainer(tmp_path, run: str, seed: int):
    """A bf16 PPO trainer on the card at widths every kernel takes (8 heads
    of 128, d_model 1024, V = 1024, 2 layers, the top one trained), greedy
    decoding, checkpointing under ``tmp_path / run``."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.ppo import PPOTrainer

    P, R, V = 192, 32, 1024
    arch = dict(vocab_size=V, n_layer=2, n_head=8, d_model=1024, max_position=512, pos_type="rotary",
                rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                tie_word_embeddings=False, extra={"lm_head_bias": True})
    return PPOTrainer(TRLConfig.from_dict({
        "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1, model_arch=arch,
                      dtype="bfloat16", param_dtype="float32"),
        "train": dict(total_steps=1, seq_length=P + R, epochs=1, batch_size=8, lr_ramp_steps=0, lr_decay_steps=100,
                      weight_decay=1e-6, learning_rate_init=1e-2, learning_rate_target=1e-2,
                      checkpoint_dir=str(tmp_path / run), seed=seed),
        "method": dict(name="ppoconfig", num_rollouts=8, chunk_size=8,
                       gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, do_sample=False)),
    }))


def _adam_step(trainer, seed):
    g = torch.Generator(device=trainer.device).manual_seed(seed)
    trainer.optimizer.step(trainer.trainable, [torch.randn(p.shape, generator=g, device=trainer.device)
                                               for p in trainer.trainable])
    trainer.step += 1


def _train_state(trainer):
    opt = trainer.optimizer.state_dict()
    out = {f"param/{n}": p.detach().clone() for n, p in trainer.model.named_parameters()}
    out.update({f"extra/{n}": t.clone() for n, t in trainer.extras.items()})
    out.update({f"{k}/{n}": t.clone() for k in ("mu", "nu") for n, t in opt[k].items()})
    return out, (opt["count"], trainer.step, trainer.bad_steps, trainer.host_state_dict())


def test_checkpoint_round_trip_on_the_card(tmp_path):
    """An async save of a trainer on the card, then a load into a trainer
    of another seed: every parameter, extra and moment on the card equals
    the saver's at its save, bit for bit (a step taken while the writer
    runs does not reach the checkpoint), copied in place."""
    dev = _cuda()
    saver = _ckpt_trainer(tmp_path, "a", 3)
    _adam_step(saver, 1)
    want = _train_state(saver)
    saver.save(block=False)
    _adam_step(saver, 2)
    saver._finalize_pending_save()
    fresh = _ckpt_trainer(tmp_path, "b", 4)
    live = [t.data_ptr() for t in (*fresh.model.parameters(), *fresh.extras.values(), *fresh.optimizer.mu)]
    assert fresh.load(str(tmp_path / "a")) == "state_1"
    got = _train_state(fresh)
    assert got[1] == want[1] and sorted(got[0]) == sorted(want[0])
    for k, t in want[0].items():
        assert got[0][k].device.type == dev.type and torch.equal(got[0][k], t), k
    assert live == [t.data_ptr() for t in (*fresh.model.parameters(), *fresh.extras.values(), *fresh.optimizer.mu)]


def test_decode_graph_after_load_equals_a_fresh_load(tmp_path):
    """Trainer A captures its decode graph (one rollout), then loads a
    checkpoint; trainer B loads it before capturing anything: their greedy
    tokens are bit-equal, and A's changed with the load (the graph reads
    the loaded weights through the refreshed bf16 copies)."""
    _cuda()
    import numpy as np

    source = _ckpt_trainer(tmp_path, "src", 5)
    _adam_step(source, 7)
    source.save()
    del source
    a = _ckpt_trainer(tmp_path, "a", 3)
    rng = np.random.default_rng(0)
    ids = a.put(rng.integers(1, 1024, size=(8, a.prompt_length)).astype(np.int32))
    mask = torch.ones_like(ids)
    before = a.rollout_generate(ids, mask)[0]
    assert a._generate_fn.keywords["_keep"]["buffers"]["graph"] is not None
    a.load(str(tmp_path / "src"))
    b = _ckpt_trainer(tmp_path, "b", 4)
    b.load(str(tmp_path / "src"))
    ta, tb = a.rollout_generate(ids, mask)[0], b.rollout_generate(ids, mask)[0]
    assert torch.equal(ta, tb)
    assert not torch.equal(ta, before)


def test_reward_model_score_kernel_route_matches_plain():
    """The reward model's score (value head at the last valid token) on the
    kernel route, whose trunk runs the flash forward once per layer, against
    the plain route (einsum attention) on the same weights: left-padded
    rows, one all padding (score 0), within 2e-2 of max |score|."""
    dev = _cuda()
    import numpy as np

    from trlx_tpu_torch.models.heads import LMWithValueHead
    from trlx_tpu_torch.models.hf_import import init_params
    from trlx_tpu_torch.models.lm import LMConfig
    from trlx_tpu_torch.ops.flash_attention import flash_fwd
    from trlx_tpu_torch.trainer.ppo import reward_model_scores

    cfg = LMConfig(vocab_size=1024, n_layer=2, n_head=8, d_model=1024, max_position=512, pos_type="rotary",
                   rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                   tie_word_embeddings=False, extra={"lm_head_bias": True})
    rms = []
    for c in (cfg, cfg.replace(attn_impl="xla")):
        rm = LMWithValueHead(c, branch_layer=-1, device=dev)
        init_params(rm, torch.Generator(device=dev).manual_seed(5))
        rm.requires_grad_(False)
        rms.append(rm)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, 1024, size=(4, 256)), dtype=torch.int32, device=dev)
    mask = torch.ones_like(tokens)
    for i, pad in enumerate((0, 37, 200, 256)):
        mask[i, :pad] = 0
    before = flash_fwd.launches
    got = reward_model_scores(rms[0], tokens, mask)
    assert flash_fwd.launches == before + 2
    ref = reward_model_scores(rms[1], tokens, mask)
    assert flash_fwd.launches == before + 2
    assert got[-1] == 0 and ref[-1] == 0
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2 * float(ref.abs().max()))


def test_hf_load_onto_the_card_equals_the_cpu_load(tmp_path):
    """An HF directory (bf16 safetensors, sharded with an index, written by
    the port) loaded straight into a model on the card holds the same
    parameters, bit for bit, as the same load on the CPU; an export from
    the card reads back equal."""
    dev = _cuda()
    import shutil
    from types import SimpleNamespace

    from trlx_tpu_torch.models.heads import LMWithValueHead
    from trlx_tpu_torch.models.hf_export import export_hf
    from trlx_tpu_torch.models.hf_import import build_lm_config, init_params, load_hf_trunk, load_or_init_params
    from trlx_tpu_torch.models.lm import LMConfig
    from trlx_tpu_torch.models.safetensors_io import SafetensorsReader, write_safetensors

    cfg = LMConfig(vocab_size=512, n_layer=2, n_head=4, d_model=256, max_position=512, pos_type="rotary",
                   rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                   tie_word_embeddings=False, extra={"lm_head_bias": True})
    src = LMWithValueHead(cfg, device="cpu")
    init_params(src, torch.Generator().manual_seed(1))
    f32_dir = export_hf(dict(src.named_parameters()), cfg, str(tmp_path / "f32"))
    reader = SafetensorsReader(f32_dir)
    bf16_dir = str(tmp_path / "bf16")
    write_safetensors(bf16_dir, {k: reader[k].to(torch.bfloat16) for k in reader}, max_shard_bytes=1 << 20)
    shutil.copy(f"{f32_dir}/config.json", bf16_dir)
    config = SimpleNamespace(model=SimpleNamespace(model_path=bf16_dir, model_arch={}, dtype="bfloat16",
                                                   param_dtype="float32", remat=False, remat_policy="full",
                                                   kv_cache_quant=False))
    models = {}
    for d in ("cpu", dev):
        models[str(d)] = LMWithValueHead(build_lm_config(config), device=d)
        load_or_init_params(models[str(d)], config, torch.Generator(device=d).manual_seed(2))
    cpu, card = models["cpu"], models[str(dev)]
    for (n, a), (_, b) in zip(cpu.transformer.named_parameters(), card.transformer.named_parameters()):
        assert b.device.type == "cuda" and torch.equal(a, b.cpu()), n
    out = export_hf(dict(card.named_parameters()), card.cfg, str(tmp_path / "out"))
    back = load_hf_trunk(out, card.cfg)
    for n, p in card.transformer.named_parameters():
        assert torch.equal(back[n], p.cpu()), n


# The key-offset and non-causal modes (ring attention's per-chunk attention):
# offsets that put the visiting chunk wholly in the past, across the
# diagonal, off the tile grid, and wholly in the future.
_MODE_CASES = [(T, off, causal, window) for T in (128, 200) for off in (-2 * T, -T, -64, 0, 37, T)
               for causal in (True, False) for window in (0, 48)]


@pytest.mark.parametrize("T,offset,causal,window", _MODE_CASES,
                         ids=[f"T{T}-off{o}-{'causal' if c else 'full'}-w{w}" for T, o, c, w in _MODE_CASES])
@pytest.mark.parametrize("d", [64, 256])
def test_flash_modes_match_plain(T, offset, causal, window, d):
    """Forward, dq and dk/dv in the offset frame against the plain versions.
    Rows with a valid reachable key compare; rows that reach no key get o = 0
    and lse = -1e30 exactly and, with cotangents on, add nothing (dq = 0 and
    dk/dv as the plain backward's); rows that reach only masked keys carry
    no cotangent (their combine weight is 0)."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import (
        M_INIT, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_plain, flash_fwd, reachable,
    )

    b, h, scale = 2, 4, d ** -0.5
    q, k, v, mask, _, _ = _bwd_case(dev, 21, b, T, h, d, (0, 70))
    g = torch.Generator(device=dev).manual_seed(22)
    reach = reachable(T, T, dev, causal=causal, window=window, offset=offset)
    good = (reach[None] & mask.bool()[:, None, :]).any(-1)  # [b, T]
    dead = ~reach.any(-1)  # [T]
    keep = good | dead[None]
    do = (torch.randn((b, T, h, d), generator=g, device=dev) * keep[:, :, None, None]).to(torch.bfloat16)
    dlse = torch.randn((b, h, T), generator=g, device=dev) * keep[:, None, :]
    modes = dict(scale=scale, causal=causal, window=window, offset=offset)
    n0 = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, mask, **modes)
    dq, dk, dv = flash_attention_bwd(q, k, v, mask, o, lse, do, dlse, **modes)
    torch.cuda.synchronize()
    assert flash_fwd.launches == n0 + 1
    ro, rlse = flash_attention_plain(q, k, v, mask, return_lse=True, **modes)
    if good.any():
        torch.testing.assert_close(o[good].float(), ro[good].float(), rtol=0, atol=2e-2)
        lg = good[:, None, :].expand_as(lse)
        torch.testing.assert_close(lse[lg], rlse[lg], rtol=0, atol=1e-2)
    assert (o[:, dead] == 0).all() and (lse[:, :, dead] == M_INIT).all()
    rq, rk, rv = flash_attention_bwd_plain(q, k, v, mask, o, lse, do, dlse, **modes)
    if good.any():
        _close(dq[good], rq[good], 2e-2)
    assert (dq[:, dead] == 0).all()
    _close(dk, rk, 2e-2)
    _close(dv, rv, 2e-2)


@pytest.mark.parametrize("layout,causal", [("zigzag", True), ("contiguous", True), ("contiguous", False)],
                         ids=["zigzag", "contiguous", "contiguous-noncausal"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_on_local_group_matches_flash(n, layout, causal):
    """``ring_attention_sharded`` on a ``LocalSpGroup(n)`` (every rank on
    this card, the chunks through the kernels' offset mode) against
    single-device flash over the whole sequence, forward and backward; the
    kernels launch as the schedule says (zig-zag: the live half-pairs, 2n + 1
    a rank; contiguous: every chunk)."""
    dev = _cuda()
    from trlx_tpu_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from trlx_tpu_torch.parallel.mesh import LocalSpGroup, make_mesh
    from trlx_tpu_torch.parallel.ring_attention import causal_live_half_pairs, ring_attention_sharded

    b, T, h, d = 2, 2048, 4, 128
    q, k, v, mask, do, _ = _bwd_case(dev, 31, b, T, h, d, (0, 300))
    rows = mask.bool() if causal else torch.ones_like(mask, dtype=torch.bool)
    do = torch.randn((b, T, h, d), generator=torch.Generator(device=dev).manual_seed(32), device=dev)
    do = (do * rows[:, :, None, None]).to(torch.bfloat16)
    mesh = make_mesh((1, 1, 1, n), sp_group=LocalSpGroup(n))
    counters = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)

    def run(fn):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = fn(*leaves)
        return (o, *torch.autograd.grad(o, leaves, do))

    before = [c.launches for c in counters]
    got = run(lambda q_, k_, v_: ring_attention_sharded(q_, k_, v_, mask, scale=d ** -0.5, causal=causal, mesh=mesh,
                                                        layout=layout))
    torch.cuda.synchronize()
    per = sum(causal_live_half_pairs(n, "zigzag")) if layout == "zigzag" else n * n
    assert [c.launches - b_ for c, b_ in zip(counters, before)] == [per] * 3
    ref = run(lambda q_, k_, v_: flash_attention(q_, k_, v_, mask, scale=d ** -0.5, causal=causal))
    torch.testing.assert_close(got[0][rows].float(), ref[0][rows].float(), rtol=0, atol=2e-2)
    _close(got[1][rows], ref[1][rows], 2e-2)
    _close(got[2], ref[2], 2e-2)
    _close(got[3], ref[3], 2e-2)


_NCCL_RANK = """
import os, sys, torch, torch.distributed as dist
sys.path.insert(0, {root!r})
rank, world = int(sys.argv[1]), 2
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method="file://" + {store!r}, rank=rank, world_size=world)
from trlx_tpu_torch.ops.flash_attention import flash_attention
from trlx_tpu_torch.parallel.mesh import make_mesh
from trlx_tpu_torch.parallel.ring_attention import ring_attention_sharded
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn((2, 2048, 4, 128), generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
           for _ in range(3))
mask = torch.ones((2, 2048), device="cuda")
do = torch.randn((2, 2048, 4, 128), generator=g, device="cuda").to(torch.bfloat16)
o = ring_attention_sharded(q, k, v, mask, scale=128 ** -0.5, mesh=make_mesh((1, 1, 1, world)))
got = (o, *torch.autograd.grad(o, (q, k, v), do))
leaves = [x.detach().requires_grad_() for x in (q, k, v)]
r = flash_attention(*leaves, mask, scale=128 ** -0.5)
ref = (r, *torch.autograd.grad(r, leaves, do))
for a, b in zip(got, ref):
    err = float((a.float() - b.float()).abs().max())
    assert err <= 2e-2 * float(b.float().abs().max()) + 2e-2, err
dist.destroy_process_group()
print("ok")
"""


def test_ring_over_nccl_on_two_cards(tmp_path):
    """The ring over a real NCCL group of two processes, one card each,
    against single-device flash (zig-zag, forward and backward). Needs two
    cards: the chip machine of this repository's runs has one, and NCCL
    refuses two ranks on one device."""
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL refuses two ranks on one card)")
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _NCCL_RANK.format(root=root, store=str(tmp_path / "store"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), outs


def test_graph_capture_beside_a_thread_that_allocates_and_syncs():
    """The overlapped pipeline's capture rule (``ops.cuda_graph``): a thread
    captures decode-step graphs while another allocates and reads results
    back (cudaMalloc, host syncs) on the default stream. Every capture
    succeeds, every replay gives the eager result, and the other thread's
    launches are neither taken back nor replayed."""
    dev = _cuda()
    import threading

    from trlx_tpu_torch.ops.cuda_graph import CudaGraph, StepGraph
    from trlx_tpu_torch.ops.decode_attention import decode_attention

    stop, errors, sums = threading.Event(), [], []

    def busy():
        try:
            n = 1 << 16
            own = torch.Generator(device=dev).manual_seed(1)  # a capture registers the default generator
            while not stop.is_set():
                x = torch.randn((n,), device=dev, generator=own)  # new sizes: the allocator grows
                sums.append(float(x.sum()))  # a host sync
                n = n + 4096 if n < (1 << 24) else 1 << 16
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    other = threading.Thread(target=busy, name="trlx-test-busy")
    other.start()
    try:
        g = torch.Generator(device=dev).manual_seed(0)
        B, T, h, d = 4, 256, 16, 256
        q = torch.randn((B, h, d), generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, T, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        bias = torch.zeros((B, T), device=dev)
        out = torch.empty((B, h, d), dtype=torch.bfloat16, device=dev)

        def step():
            out.copy_(decode_attention(q, k, v, bias, scale=d ** -0.5)[:, 0])

        step()
        want = out.clone()
        for _ in range(5):
            before = decode_attention.launches
            graph = StepGraph(step, CudaGraph())
            assert decode_attention.launches == before
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want)
            assert decode_attention.launches == before + 1
    finally:
        stop.set()
        other.join(timeout=60)
    assert not errors and sums


def test_staleness_zero_producer_thread_gives_the_serial_run(tmp_path):
    """train() on the card with rollout_overlap at staleness 0, whose
    producer captures its decode graphs on its own thread: the step stats,
    the last store and the final parameters equal the serial run's, bit for
    bit."""
    _cuda()
    import json

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    P, R, V = 192, 32, 1024
    arch = dict(vocab_size=V, n_layer=2, n_head=8, d_model=1024, max_position=512, pos_type="rotary",
                rotary_dim=32, parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False,
                tie_word_embeddings=False, extra={"lm_head_bias": True})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, size=int(rng.integers(100, P + 1))).tolist() for _ in range(16)]
    runs = {}
    for name, method in (("serial", {}), ("overlap", {"rollout_overlap": True})):
        config = TRLConfig.from_dict({
            "model": dict(model_path="", tokenizer_path="", model_type="ppo", num_layers_unfrozen=1,
                          model_arch=arch, dtype="bfloat16", param_dtype="float32"),
            "train": dict(total_steps=6, seq_length=P + R, epochs=3, batch_size=8, lr_ramp_steps=1,
                          lr_decay_steps=100, weight_decay=1e-6, learning_rate_init=1e-4, learning_rate_target=1e-4,
                          checkpoint_interval=10**6, eval_interval=10**6, checkpoint_dir=str(tmp_path / name),
                          seed=3),
            "method": dict(name="ppoconfig", num_rollouts=16, chunk_size=8, ppo_epochs=1,
                           gen_kwargs=dict(prompt_length=P, max_length=P + R, min_length=P + R, top_k=0,
                                           top_p=0.9, temperature=0.7, do_sample=True), **method),
        })
        trainer = trlx_tpu_torch.train(reward_fn=lambda s: [float(np.mean(np.asarray(x) % 2)) for x in s],
                                       prompts=prompts, config=config)
        with open(tmp_path / name / "metrics.jsonl") as f:
            steps = [{k: r[k] for k in ("loss", "pg_loss", "vf_loss", "mean_kl", "grad_norm")}
                     for r in map(json.loads, f) if "loss" in r]
        runs[name] = (steps, trainer.store.columns(), {n: p.detach().cpu() for n, p in
                                                       trainer.model.named_parameters()})
    (s_steps, s_store, s_params), (o_steps, o_store, o_params) = runs["serial"], runs["overlap"]
    assert len(s_steps) == 6 and o_steps == s_steps
    for k in s_store:
        np.testing.assert_array_equal(o_store[k], s_store[k], err_msg=k)
    for n in s_params:
        assert torch.equal(o_params[n], s_params[n]), n


def test_snapshot_graph_on_the_producer_thread_reads_only_snapshot_weights(tmp_path):
    """A rollout from a boundary snapshot, replayed as a CUDA graph on a
    producer thread again and again while the main thread takes optimizer
    steps and decodes from the live weights: every replay gives the tokens
    the boundary weights give, and the live weights' tokens move away."""
    _cuda()
    import threading

    import numpy as np

    trainer = _ckpt_trainer(tmp_path, "snap", 3)
    rng = np.random.default_rng(0)
    ids = trainer.put(rng.integers(1, 1024, size=(8, trainer.prompt_length)).astype(np.int32))
    mask = torch.ones_like(ids)
    want = trainer.rollout_generate(ids, mask)[0]  # the boundary weights, live
    snapshot = trainer._rollout_snapshot()
    got, errors = [], []
    stop = threading.Event()

    def producer():
        try:
            assert snapshot["weights"].adopt() == 0
            while not stop.is_set() or len(got) < 4:
                got.append(trainer.rollout_generate(ids, mask, snapshot=snapshot)[0].cpu())
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    thread = threading.Thread(target=producer, name="trlx-test-producer")
    thread.start()
    try:
        for seed in range(8):
            _adam_step(trainer, 100 + seed)
            live = trainer.rollout_generate(ids, mask)[0]
    finally:
        stop.set()
        thread.join(timeout=300)
    assert not errors and not thread.is_alive() and len(got) >= 4
    snap_fn = trainer._generate_fns_for(snapshot["weights"].module)[0]
    assert snap_fn.keywords["_keep"]["buffers"]["graph"] is not None
    for toks in got:
        assert torch.equal(toks, want.cpu())
    assert not torch.equal(live, want)


_NCCL_SHARDED_RANK = """
import os, sys, torch, torch.distributed as dist
sys.path.insert(0, {root!r})
rank, world, shape = int(sys.argv[1]), 2, tuple(int(x) for x in sys.argv[2].split(","))
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method="file://" + {store!r}, rank=rank, world_size=world)
from trlx_tpu_torch.models.heads import LMWithValueHead
from trlx_tpu_torch.models.lm import LMConfig, gather_tensor, shard_tensor
from trlx_tpu_torch.ops import generate as gen_mod
from trlx_tpu_torch.ops.sampling import GenerateConfig
from trlx_tpu_torch.parallel import collectives as coll
from trlx_tpu_torch.parallel.mesh import make_mesh, set_mesh
from trlx_tpu_torch.trainer.base import reduce_gradients
arch = dict(vocab_size=512, n_layer=2, n_head=8, d_model=512, max_position=512, pos_type="rotary", rotary_dim=32,
            parallel_residual=True, fused_qkv=False, qkv_bias=False, out_bias=False, tie_word_embeddings=False,
            extra={{"lm_head_bias": True}})
torch.manual_seed(0)
ref = LMWithValueHead(LMConfig(**arch), device="cuda")
for p in ref.parameters():
    p.data.normal_(0, 0.05)
mesh = make_mesh(shape)
set_mesh(mesh)
model = LMWithValueHead(LMConfig(**arch).with_mesh(tp=shape[2], fsdp=shape[1]), device="cuda")
whole = dict(ref.named_parameters())
with torch.no_grad():
    for n, p in model.named_parameters():
        p.copy_(shard_tensor(model, n, whole[n].detach()))
ids = torch.randint(0, 512, (4, 256), device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
mask = torch.ones_like(ids)
if {mode!r} == "step":
    def loss_of(m, i, k, rows):
        out = m(i, k)
        return (out["logits"].float().logsumexp(-1).sum() + out["values"].float().sum()) / rows
    loss_of(ref, ids, mask, 4).backward()
    b = 4 // mesh.data_size
    sl = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    loss_of(model, ids[sl], mask[sl], 4).backward()
    names = [n for n, _ in model.named_parameters()]
    grads = reduce_gradients(model, mesh, names, [p.grad for _, p in model.named_parameters()])
    for n, g in zip(names, grads):
        got, want = gather_tensor(model, n, g).float(), whole[n].grad.float()
        err = float((got - want).abs().max())
        assert err <= 2e-2 * float(want.abs().max()) + 1e-4, (n, err)
    assert coll.TRAFFIC and all(r["stage_s"] == 0.0 for r in coll.traffic().values()), coll.traffic()
else:
    assert gen_mod.graphs_allowed(torch.device("cuda"))  # NCCL: the step with its all-reduces is captured
    gcfg = GenerateConfig(max_new_tokens=16, do_sample=False, eos_token_id=None, pad_token_id=0)
    keep = {{}}
    for _ in range(2):
        toks, _ = gen_mod.generate(model, ids[:, :64], mask[:, :64], None, gcfg=gcfg, _keep=keep)
    assert keep["buffers"]["graph"] is not None
    eager, _ = gen_mod.generate(model, ids[:, :64], mask[:, :64], None, gcfg=gcfg, _eager=True)
    assert torch.equal(toks, eager)
dist.destroy_process_group()
print("ok")
"""


def _two_card_ranks(tmp_path, shape, mode):
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL refuses two ranks on one card)")
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _NCCL_SHARDED_RANK.format(root=root, store=str(tmp_path / "store"), mode=mode)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), ",".join(map(str, shape))],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), outs


@pytest.mark.parametrize("shape", [(1, 2, 1, 1), (1, 1, 2, 1)])
def test_fsdp_tp_train_step_over_nccl_on_two_cards(tmp_path, shape):
    """A train step's loss and gradients over a real NCCL group, one card
    a rank, with the parameters split over fsdp or tp, against one process:
    every collective runs on the card (nothing staged). Needs two cards."""
    _two_card_ranks(tmp_path, shape, "step")


def test_decode_graph_capture_under_tp2_over_nccl(tmp_path):
    """Decode steps whose tp all-reduces run over NCCL are captured as CUDA
    graphs (``ops.generate.graphs_allowed``), and the replayed steps' greedy
    tokens equal the eager ones. Needs two cards."""
    _two_card_ranks(tmp_path, (1, 1, 2, 1), "decode")


_NCCL_OVERLAP_RANK = """
import os, sys, torch, torch.distributed as dist
sys.path.insert(0, {root!r})
sys.path.insert(0, os.path.join({root!r}, "tests"))
rank, world = int(sys.argv[1]), 2
os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method="file://" + {store!r}, rank=rank, world_size=world)
import trlx_tpu_torch
import torch_sp_train_case as case
from trlx_tpu_torch.data.configs import TRLConfig
cfg = case.ppo_config(os.path.join({ckpt!r}), (1, 1, 2, 1), arch=dict(case._arch(), vocab_size=32, dtype="bfloat16"))
cfg["train"].update(total_steps=4, epochs=2, desync_check_interval=1)
cfg["method"].update(max_staleness=1, rollout_engine=True, engine_slots=4, prefill_batch=2, engine_steps_per_sync=2)
cfg["model"].update(decode_weight_quant=True, dtype="bfloat16")
t = case.task(vocab=32)
trainer = trlx_tpu_torch.train(reward_fn=case.reward_fn, prompts=t["prompts"], eval_prompts=t["eval_prompts"],
                               config=TRLConfig.from_dict(cfg), logit_mask=t["logit_mask"])
assert trainer.iter_count == 4, trainer.iter_count
assert trainer._producer_stream is not None and trainer._producer_stream != torch.cuda.default_stream()
assert len(trainer.orch.schedule_crcs) >= 2
dist.destroy_process_group()
print("ok")
"""


def test_overlapped_pipeline_over_nccl_on_two_cards(tmp_path):
    """The overlapped pipeline at staleness 1 with the engine and int8
    decode weights on tp 2 over NCCL, one card a rank: the producer and its
    score worker use the second group set and a stream of their own,
    ordered at the snapshot handoff by events, and the run ends with the
    consistency guard on every step and equal engine schedules. Needs two
    cards (NCCL refuses two ranks on one card)."""
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL refuses two ranks on one card)")
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _NCCL_OVERLAP_RANK.format(root=root, store=str(tmp_path / "store"), ckpt=str(tmp_path / "ckpt"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), [o[-3000:] for o in outs]


def test_probe_tap_is_inert_in_a_captured_decode_graph():
    """graftnum's taps inside the engine's decode graph: the first step()
    (prefill, the eager decode call, then the capture) runs inside a live
    bisect session on this thread; the eager forwards are recorded, the
    capture records nothing (a live tap would read the host mid-capture and
    break it), and the replays outside the session decode the eager engine's
    tokens bit for bit."""
    dev = _cuda()
    import numpy as np

    from trlx_tpu_torch.engine import RolloutEngine
    from trlx_tpu_torch.observability import numerics
    from trlx_tpu_torch.ops.sampling import GenerateConfig

    model, _, _ = _graph_model(dev, quant=True)
    n_layer = model.cfg.n_layer
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, 64, size=(6, 200)).astype(np.int32)
    mask = np.ones_like(prompts)
    gcfg = GenerateConfig(max_new_tokens=16, do_sample=False)
    kw = dict(n_slots=4, prompt_width=200, prefill_batch=2, steps_per_sync=4, paged_kv=True, kv_block_size=128)
    out = {}
    for name in ("eager", "graph"):
        engine = RolloutEngine(model, gcfg, **kw, _eager=name == "eager")
        engine.update_weights(model, version=1)
        engine.submit(prompts, mask)
        eps = []
        if name == "graph":
            session = numerics.bisect_forward(lambda: eps.extend(engine.step()))
            assert engine._graph is not None
            assert not any(t["tap"] == "<error>" for t in session["taps"]), session["taps"][-1]
            # Two prefill forwards and the eager call's 4 decode steps: no record from the capture.
            assert len(session["taps"]) == 6 * (n_layer + 2) and session["first_nonfinite"] is None
        while not engine.idle:
            eps.extend(engine.step())
        torch.cuda.synchronize()
        out[name] = {tuple(e.prompt_ids.tolist()): e.response_ids for e in eps}
        engine.shutdown()
    assert out["eager"].keys() == out["graph"].keys() and len(out["eager"]) == 6
    for key in out["eager"]:
        np.testing.assert_array_equal(out["graph"][key], out["eager"][key])


def test_graftscope_ledger_conserves_with_cuda_event_fences():
    """The card's ledger: each monitored dispatch's CUDA event pair is placed
    on the host clock by the drain thread; over a window of dispatches and
    host gaps, device busy + host + bubble equals the wall (error <= 1e-9),
    no fence is dropped, every placed interval lies inside the window, and a
    dispatch's device interval lasts what its events measure."""
    dev = _cuda()
    import time

    from trlx_tpu_torch.observability import devicemon, graftscope

    mon = devicemon.DeviceMonitor(peak_flops=989e12, device=dev)
    gs = graftscope.GraftScope()
    mon.ledger = gs
    x = torch.randn((4096, 4096), device=dev, dtype=torch.bfloat16)
    step = mon.wrap("train/step", lambda a: a @ a, phase="train")
    gs.window()  # opens the window here
    t0 = time.time()
    for _ in range(6):
        step(x)
        graftscope.host_interval("train", time.time(), time.time() + 0.001)
        time.sleep(0.005)
    torch.cuda.synchronize()
    with gs._lock:
        placed = list(gs._device)
    stats = mon.window({"train": 1.0, "wall": 1.0})
    gauges = gs.window()
    t1 = time.time()
    wall = gauges["obs/ledger_wall_s"]
    assert abs(gauges["obs/ledger_device_busy_s"] + gauges["obs/ledger_host_s"] + gauges["obs/ledger_bubble_s"]
               - wall) / wall <= 1e-9
    assert gauges["obs/graftscope_fences_dropped_total"] == 0.0 and gauges["obs/ledger_device_busy_s"] > 0
    assert gauges["obs/ledger_device_busy_s"] <= stats["obs/train_device_s"] + 1e-3
    assert all(t0 - 1e-3 <= a <= b <= t1 for a, b, _ in placed) and len(placed) <= 6
    flops = mon.snapshot()["train/step"]["variants"][0]["flops"]
    assert flops == 2 * 4096 ** 3
    assert stats["obs/train_mfu_pct"] == pytest.approx(100 * 6 * flops / stats["obs/train_device_s"] / 989e12)
    gs.close()
