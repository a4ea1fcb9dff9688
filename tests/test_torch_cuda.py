"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so on a GPU machine without JAX it runs
alone:  ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda.py``.  Tolerances: 1e-4 (f32) and 1e-2 (bf16) of
max(1, max|plain|), the plain version run in f32 on the same inputs — the
kernels accumulate in f32 and round only their output; flash attention in
bf16 also rounds its probabilities to bf16 for the P·V product on the
tensor cores (at most 2^-9 relative error per term), and the bf16
index-embed demux's Hopper body rounds its activation gelu(zh + zp) to
bf16 for the W2 product (the TPU kernel keeps it in f32) with
tanh.approx.f32, and so does the bf16 decode demux's flat-row body.
Each Hopper test asserts which body the launch plan chose.  The paged
attention kernel (split over a cluster of blocks per slot and KV head) is
compared on query rows with at least one valid key (rows with none are
garbage in every implementation).
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import kernel as flash_kernel
from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.kernels.attention import ref as flash_ref
from repro_torch.kernels.demux import kernel as demux_kernel
from repro_torch.kernels.demux import ref as demux_ref
from repro_torch.kernels.multiplex import kernel as mux_kernel
from repro_torch.kernels.multiplex import ref as mux_ref
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.nn.layers import SharedMLPStack


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,n,l,d,hidden", [(8, 40, 1, 768, 1536),
                                            (3, 5, 7, 200, 300)])
def test_kernels_match_plain_versions_on_card(cuda, dtype, tol, b, n, l, d,
                                              hidden):
    g = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=cuda)
                ).to(dtype)

    x, v = randn(b, n, l, d), randn(n, d)
    want = mux_ref.hadamard_mux(x.float(), v.float())
    got = mux_kernel.hadamard_mux(x, v).float()
    assert (got - want).abs().max().item() <= tol * max(
        1.0, want.abs().max().item())

    mlp = SharedMLPStack([2 * d, hidden, d], device=cuda, dtype=dtype)
    h, p = randn(b, l, d), randn(b, n, d)
    l0, l1 = mlp.layers()
    with torch.no_grad():
        want = demux_ref.index_embed_demux(mlp.float(), h.float(), p.float())
        mlp.to(dtype)
        for fn in (demux_kernel.index_embed_demux, demux_kernel.decode_demux):
            got = fn(h, p, l0.weight, l0.bias, l1.weight, l1.bias).float()
            assert (got - want).abs().max().item() <= tol * max(
                1.0, want.abs().max().item())


@pytest.mark.cuda
def test_each_launch_counts_once(cuda):
    x = torch.randn(2, 3, 4, 16, device=cuda)
    _build.LAUNCHES.clear()
    mux_kernel.hadamard_mux(x, torch.randn(3, 16, device=cuda))
    assert dict(_build.LAUNCHES) == {"hadamard_mux": 1}


def _paged_case(dev, dtype, b, h, kvh, hd, pool, ps, mp, c, seed=0):
    """Random pool and block tables on the card: each slot maps a random
    number of distinct non-trash pages, each written up to a random
    length; C query rows at consecutive positions."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, c, h, hd), generator=g)
    k = torch.randn((pool, ps, kvh, hd), generator=g)
    v = torch.randn((pool, ps, kvh, hd), generator=g)
    bt = torch.full((b, mp), -1, dtype=torch.int32)
    pos = torch.full((pool, ps), -1, dtype=torch.int32)
    for i in range(b):
        n = int(torch.randint(1, min(mp, pool - 1) + 1, (1,), generator=g))
        pages = 1 + torch.randperm(pool - 1, generator=g)[:n]
        bt[i, :n] = pages.to(torch.int32)
        for j, p in enumerate(pages.tolist()):
            written = int(torch.randint(1, ps + 1, (1,), generator=g))
            pos[p, :written] = j * ps + torch.arange(written,
                                                     dtype=torch.int32)
    base = torch.randint(ps - 1, mp * ps - c + 1, (b, 1), generator=g)
    q_pos = (base + torch.arange(c)[None, :]).to(torch.int32)
    floats = [t.to(dev, dtype) for t in (q, k, v)]
    return floats + [t.to(dev) for t in (pos, bt, q_pos)]


def _live(args, *, causal, window):
    _q, _k, _v, pos, bt, q_pos = args
    k_pos = paged_ref.gather_positions(pos, bt)
    diff = q_pos[:, :, None] - k_pos[:, None, :]
    ok = (k_pos >= 0)[:, None, :].expand_as(diff)
    if causal:
        ok = ok & (diff >= 0)
    if window is not None:
        ok = ok & (diff < window)
    return ok.any(-1)[:, :, None, None]


PAGED_CARD = [  # (b, h, kvh, hd, pool, ps, mp, c, causal, window)
    (8, 12, 12, 64, 80, 16, 9, 1, False, None),   # the tmux slice
    (3, 8, 2, 128, 37, 8, 7, 3, True, 8),         # GQA 4, chunk 3, window
    (2, 4, 1, 64, 11, 4, 5, 2, True, None),       # MQA, small pages
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", PAGED_CARD)
@pytest.mark.parametrize("kblock", [1, 2, 4])
def test_paged_kernel_matches_plain_version_on_card(cuda, dtype, tol, case,
                                                    kblock):
    *shape, causal, window = case
    args = _paged_case(cuda, dtype, *shape)
    scale = shape[3] ** -0.5
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    want = paged_ref.paged_attention(*f32, scale=scale, causal=causal,
                                     window=window)
    got = paged_kernel.paged_decode_attention(
        *args, scale=scale, causal=causal, window=window,
        kblock_pages=kblock).float()
    torch.cuda.synchronize()
    live = _live(args, causal=causal, window=window)
    err = ((got - want) * live).abs().max().item()
    assert err <= tol * max(1.0, (want * live).abs().max().item())


@pytest.mark.cuda
def test_paged_kernel_kblock_widths_agree(cuda):
    """kblock_pages is a staging width only: the outputs for 1, 2 and 4
    agree within f32 rounding, though the plan splits the table
    differently for each (6, 3 and 2 splits per slot and KV head)."""
    args = _paged_case(cuda, torch.float32, 2, 4, 2, 32, 11, 4, 6, 2)
    splits = [paged_kernel.plan(2, 2, 4, 2, 32, 4, 6, kb,
                                torch.float32).splits for kb in (1, 2, 4)]
    assert splits == [6, 3, 2]
    _build.LAUNCHES.clear()
    outs = [paged_kernel.paged_decode_attention(
        *args, scale=32 ** -0.5, causal=True, kblock_pages=kb)
        for kb in (1, 2, 4)]
    assert dict(_build.LAUNCHES) == {"paged_decode_attention": 3}
    live = _live(args, causal=True, window=None)
    for o in outs[1:]:
        assert ((o - outs[0]) * live).abs().max().item() <= 2e-5


def _unmapped_split_case(dev, dtype, b, h, kvh, hd, ps, mp, c, seed=0):
    """Tables with a run of 4 unmapped entries in the middle of every row
    (a whole split where a split holds 4 entries or fewer), 80% of the
    other entries mapped, q at the last C positions; every page no table
    maps, page 0 too, holds 1e4 keys and values at positions that would
    pass every mask."""
    g = torch.Generator().manual_seed(seed)
    pool = 1 + b * mp
    q = torch.randn((b, c, h, hd), generator=g)
    k = torch.full((pool, ps, kvh, hd), 1e4)
    v = torch.full((pool, ps, kvh, hd), 1e4)
    pos = torch.arange(ps, dtype=torch.int32).repeat(pool, 1)
    bt = torch.full((b, mp), -1, dtype=torch.int32)
    free = (1 + torch.randperm(pool - 1, generator=g)).tolist()
    mid = (mp - 4) // 2
    for i in range(b):
        for j in list(range(mid)) + list(range(mid + 4, mp)):
            if torch.rand((), generator=g) < 0.8:
                p = free.pop()
                bt[i, j] = p
                k[p] = torch.randn((ps, kvh, hd), generator=g)
                v[p] = torch.randn((ps, kvh, hd), generator=g)
                pos[p] = j * ps + torch.arange(ps, dtype=torch.int32)
    q_pos = (mp * ps - c + torch.arange(c, dtype=torch.int32)).repeat(b, 1)
    floats = [t.to(dev, dtype) for t in (q, k, v)]
    return floats + [t.to(dev) for t in (pos, bt, q_pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", [  # (b, h, kvh, hd, ps, mp, c, causal,
    (2, 4, 4, 64, 4, 12, 1, True, None),          # window): n_rep 1
    (3, 8, 2, 128, 8, 16, 2, True, 8),            # n_rep 4, chunk 2
    (2, 12, 12, 64, 16, 12, 4, False, None)])     # the slice's heads, C 4
@pytest.mark.parametrize("kblock", [1, 2])
def test_paged_kernel_split_merge_on_card(cuda, dtype, tol, case, kblock):
    """S > 1 splits in one launch, one of them all unmapped, beside pages
    planted with 1e4 that no table maps: the planted values must not leak
    into the output, and the merge must give the empty split weight 0."""
    *shape, causal, window = case
    b, h, kvh, hd, ps, mp, c = shape
    args = _unmapped_split_case(cuda, dtype, *shape)
    plan = paged_kernel.plan(b, c, h, kvh, hd, ps, mp, kblock, dtype)
    bt = args[4].cpu()
    assert plan.splits > 1
    assert any(bool((bt[:, list(plan.split_entries(s, mp))] < 0).all())
               for s in range(plan.splits))
    scale = hd ** -0.5
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    want = paged_ref.paged_attention(*f32, scale=scale, causal=causal,
                                     window=window)
    _build.LAUNCHES.clear()
    got = paged_kernel.paged_decode_attention(
        *args, scale=scale, causal=causal, window=window,
        kblock_pages=kblock).float()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"paged_decode_attention": 1}
    live = _live(args, causal=causal, window=window)
    assert bool(live.any())
    err = ((got - want) * live).abs().max().item()
    assert err <= tol * max(1.0, (want * live).abs().max().item())
    assert bool(torch.isfinite(got).all())


# (b, h, kvh, hd, pool, ps, mp, c, kblock): shapes past the kernel's
# earlier limits -- 17 query rows (tmux-12l-768h at
# prefill_chunk 17, two row groups), 64 (C 16 x n_rep 4), 256 (C 32 x
# n_rep 8); head dims whose key row is not a power of two of 16-byte loads
# (80 f32: 20 loads; 192 bf16: 24), f32 hd 256 (64 loads, two per lane),
# hd 36 (72 bf16 bytes: the copy body); pages of 512 rows (several boxes
# per page); kblock 16.
PAGED_WIDE = [
    (2, 12, 12, 64, 9, 16, 4, 17, 1),
    (2, 16, 4, 64, 9, 16, 4, 16, 2),
    (1, 64, 8, 128, 5, 16, 4, 32, 1),
    (2, 4, 2, 36, 9, 16, 4, 3, 1),
    (2, 4, 2, 80, 9, 16, 4, 1, 4),
    (2, 8, 2, 192, 9, 16, 4, 2, 1),
    (2, 4, 1, 256, 9, 16, 4, 1, 1),
    (2, 4, 2, 64, 5, 512, 2, 2, 1),
    (2, 12, 12, 64, 40, 16, 19, 1, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", PAGED_WIDE)
def test_paged_kernel_takes_every_shape_on_card(cuda, dtype, tol, case):
    *shape, kblock = case
    args = _paged_case(cuda, dtype, *shape)
    b, h, kvh, hd, _pool, ps, mp, c = shape
    plan = paged_kernel.plan(b, c, h, kvh, hd, ps, mp, kblock, dtype)
    assert plan.body == ("copy" if hd == 36 and dtype == torch.bfloat16
                         else "tma")
    scale = hd ** -0.5
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    want = paged_ref.paged_attention(*f32, scale=scale, causal=True,
                                     window=None)
    _build.LAUNCHES.clear()
    got = paged_kernel.paged_decode_attention(
        *args, scale=scale, causal=True, kblock_pages=kblock).float()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"paged_decode_attention": 1}
    live = _live(args, causal=True, window=None)
    err = ((got - want) * live).abs().max().item()
    assert err <= tol * max(1.0, (want * live).abs().max().item())


@pytest.mark.cuda
def test_paged_kernel_copy_body_on_a_misaligned_pool(cuda):
    """Pools that do not start on 16 bytes cannot be TMA maps: the plan
    takes the copy body, which must agree with the plain version."""
    args = _paged_case(cuda, torch.bfloat16, 2, 4, 2, 64, 9, 16, 4, 2)
    for i in (1, 2):
        buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype,
                          device=cuda)
        view = buf[1:].view(args[i].shape)
        view.copy_(args[i])
        args[i] = view
    assert paged_kernel.plan(2, 2, 4, 2, 64, 16, 4, 1, torch.bfloat16,
                             aligned=False).body == "copy"
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    want = paged_ref.paged_attention(*f32, scale=0.125, causal=True)
    got = paged_kernel.paged_decode_attention(*args, scale=0.125).float()
    torch.cuda.synchronize()
    live = _live(args, causal=True, window=None)
    err = ((got - want) * live).abs().max().item()
    assert err <= 1e-2 * max(1.0, (want * live).abs().max().item())


@pytest.mark.cuda
def test_paged_kernel_raises_on_what_it_does_not_take(cuda):
    args = _paged_case(cuda, torch.bfloat16, 1, 2, 1, 272, 5, 4, 2, 1)
    with pytest.raises(ValueError, match="head_dim 272"):
        paged_kernel.paged_decode_attention(*args, scale=1.0)
    args = _paged_case(cuda, torch.float32, 1, 2, 1, 64, 5, 4, 2, 1)
    args[3] = args[3].long()
    with pytest.raises(TypeError, match="int64"):
        paged_kernel.paged_decode_attention(*args, scale=1.0)


FLASH_CARD = [  # (b, lq, lk, h, hd): the reference's test shapes, Lq != Lk
    (1, 8, 8, 1, 64), (2, 37, 37, 4, 64), (1, 256, 256, 2, 128),
    (1, 520, 520, 2, 64), (1, 37, 45, 2, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", FLASH_CARD)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_version_on_card(cuda, dtype, tol, case,
                                                    causal):
    b, lq, lk, h, hd = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, lq, h, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((b, lk, h, hd), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    want = flash_ref.flash_attention(q.float(), k.float(), v.float(),
                                     causal=causal)
    _build.LAUNCHES.clear()
    got = flash_ops.flash_attention(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"flash_attention": 1}
    assert (got - want).abs().max().item() <= tol * max(
        1.0, want.abs().max().item())


@pytest.mark.cuda
def test_flash_kernel_scale_override_and_large_logits(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((1, 32, 2, 64), generator=g, device=cuda)
    got = flash_kernel.flash_attention(q, q, q, causal=True, scale=0.05)
    want = flash_ref.flash_attention(q, q, q, causal=True, scale=0.05)
    assert (got - want).abs().max().item() <= 1e-4
    q = 8.0 * torch.randn((1, 128, 1, 64), generator=g, device=cuda)
    got = flash_kernel.flash_attention(q, q, q, causal=True)
    assert bool(torch.isfinite(got).all())
    want = flash_ref.flash_attention(q, q, q, causal=True)
    assert (got - want).abs().max().item() <= 1e-4 * max(
        1.0, want.abs().max().item())


@pytest.mark.cuda
def test_flash_ops_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.randn((1, 16, 2, 320), device=cuda)
    with pytest.raises(ValueError, match="head_dim 320"):
        flash_ops.flash_attention(q, q, q)
    q = torch.randn((1, 16, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float16"):
        flash_ops.flash_attention(q, q, q)


# (B, N, C, d, H) of the decode demux: the serving slices' C 1 and their
# prefill_chunk=4 form (tmux-12l-768h), and a ragged shape whose N·C = 9
# rows per slot tile across slots unevenly (d, H multiples of 8).
DECODE_CARD = [(8, 40, 1, 768, 1536), (8, 40, 4, 768, 1536),
               (3, 3, 3, 96, 160), (4, 8, 1, 18432, 36864)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_CARD)
@pytest.mark.parametrize("body", ["wgmma", "cluster"])
def test_decode_demux_bodies_match_plain_version_on_card(cuda, shape, body):
    """The bf16 decode demux against its plain version run in f32, through
    each body: the plan takes the flat-row wgmma body for 16-byte-aligned
    operands and the cluster body when h starts 8 bytes off (a view into a
    larger buffer).  The wgmma body rounds gelu(zh + zp) to bf16 before the
    W2 product and uses tanh.approx.f32; both stay inside the bf16
    tolerance of 1e-2 x max(1, max|plain|)."""
    b, n, c, d, hidden = shape
    g = torch.Generator(device=cuda).manual_seed(0)

    def randn(*s, scale=1.0):
        return (scale * torch.randn(s, generator=g, device=cuda)).to(
            torch.bfloat16)

    h, p = randn(b, c, d), randn(b, n, d)
    if body == "cluster":
        buf = torch.empty(h.numel() + 4, dtype=h.dtype, device=cuda)
        view = buf[4:].view(h.shape)
        view.copy_(h)
        h = view
    aligned = h.data_ptr() % 16 == 0
    assert demux_kernel.decode_plan(b, c, n, d, hidden, torch.bfloat16,
                                    aligned).body == body
    w1, b1 = randn(hidden, 2 * d, scale=(2 * d) ** -0.5), \
        randn(hidden, scale=0.1)
    w2, b2 = randn(d, hidden, scale=hidden ** -0.5), randn(d, scale=0.1)
    mlp = SharedMLPStack([2 * d, hidden, d], device=cuda)
    with torch.no_grad():
        for layer, (w, bias) in zip(mlp.layers(), ((w1, b1), (w2, b2))):
            layer.weight.copy_(w)
            layer.bias.copy_(bias)
        want = demux_ref.index_embed_demux(mlp, h.float(), p.float())
        _build.LAUNCHES.clear()
        got = demux_kernel.decode_demux(h, p, w1, b1, w2, b2).float()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"decode_demux": 1}
    assert got.shape == (b, n, c, d)
    assert (got - want).abs().max().item() <= 1e-2 * max(
        1.0, want.abs().max().item())


# (B, N, L, d, H): the evaluation slice's demux (qwen1.5-4b), nemotron-4-
# 340b's width (W1 alone 2.7 GB) and a ragged shape (L, N and H not
# multiples of the tiles; d, H multiples of 8, so still the TMA body),
# then one whose H breaks TMA's 16-byte strides.
DEMUX_HOPPER = [((2, 8, 1024, 2560, 5120), "wgmma"),
                ((1, 8, 256, 18432, 36864), "wgmma"),
                ((3, 3, 17, 96, 160), "wgmma"),
                ((3, 5, 7, 200, 300), "cluster")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,body", DEMUX_HOPPER)
def test_demux_body_matches_plain_version_on_card(cuda, shape, body):
    """The bf16 index-embed demux against its plain version run in f32,
    asserting the body the plan chose.  The wgmma body rounds the
    activation gelu(zh + zp) to bf16 before the W2 product (the TPU kernel
    keeps it in f32) and uses tanh.approx.f32; both stay inside the bf16
    tolerance of 1e-2 x max(1, max|plain|)."""
    b, n, l, d, hidden = shape
    assert demux_kernel.plan(b, l, n, d, hidden, torch.bfloat16).body == body
    g = torch.Generator(device=cuda).manual_seed(0)

    def randn(*s, scale=1.0):
        return (scale * torch.randn(s, generator=g, device=cuda)).to(
            torch.bfloat16)

    h, p = randn(b, l, d), randn(b, n, d)
    w1, b1 = randn(hidden, 2 * d, scale=(2 * d) ** -0.5), \
        randn(hidden, scale=0.1)
    w2, b2 = randn(d, hidden, scale=hidden ** -0.5), randn(d, scale=0.1)
    mlp = SharedMLPStack([2 * d, hidden, d], device=cuda)
    with torch.no_grad():
        for layer, (w, bias) in zip(mlp.layers(), ((w1, b1), (w2, b2))):
            layer.weight.copy_(w)
            layer.bias.copy_(bias)
        want = demux_ref.index_embed_demux(mlp, h.float(), p.float())
        _build.LAUNCHES.clear()
        got = demux_kernel.index_embed_demux(h, p, w1, b1, w2, b2).float()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"index_embed_demux": 1}
    assert (got - want).abs().max().item() <= 1e-2 * max(
        1.0, want.abs().max().item())


FLASH_HOPPER = [  # (b, lq, lk, h): Lq 1032 is ragged against 128-row tiles
    (2, 1032, 1032, 4), (1, 37, 45, 2), (2, 45, 37, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", FLASH_HOPPER)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bodies_match_plain_version_on_card(cuda, dtype, tol, case,
                                                  hd, causal):
    b, lq, lk, h = case
    body = flash_kernel.plan(b, lq, lk, h, hd, dtype).body
    assert body == ("wgmma" if dtype == torch.bfloat16 else "cuda_cores")
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((b, lq, h, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((b, lk, h, hd), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    want = flash_ref.flash_attention(q.float(), k.float(), v.float(),
                                     causal=causal)
    got = flash_kernel.flash_attention(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= tol * max(
        1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ignores_keys_past_lk_on_card(cuda, dtype, tol, causal):
    """Lk = 200 is not a multiple of the key tile (96 keys in bf16, 64 in
    f32), and the memory just past Lk holds large values: TMA delivers
    zeros there (which would score 0 and count) and the f32 body stages
    zeros; both must mask those keys, so the output is that of the 200
    keys alone."""
    g = torch.Generator(device=cuda).manual_seed(3)
    lk, hd = 200, 128
    q = torch.randn((1, 150, 2, hd), generator=g, device=cuda).to(dtype)
    bufs = [torch.full((1, lk + 64, 2, hd), 1e4, device=cuda, dtype=dtype)
            for _ in range(2)]
    for buf in bufs:
        buf[:, :lk] = torch.randn((1, lk, 2, hd), generator=g, device=cuda)
    k, v = (buf[:, :lk] for buf in bufs)
    assert k.is_contiguous() and v.is_contiguous()
    want = flash_ref.flash_attention(q.float(), k.float(), v.float(),
                                     causal=causal)
    got = flash_kernel.flash_attention(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= tol * max(
        1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("hd", [20, 32, 80, 96, 192, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_takes_every_head_dim_on_card(cuda, dtype, tol, hd, causal):
    """Head dims beyond the earlier 64 and 128: bf16 multiples of 8 on the
    wgmma body (zero-padded to 64-column boxes; 48-key tiles at 192 and
    256), the rest and all f32 on the CUDA-core body; Lq 150 and Lk 200
    are ragged against every tile."""
    body = flash_kernel.plan(1, 150, 200, 2, hd, dtype).body
    assert body == ("wgmma" if dtype == torch.bfloat16 and hd % 8 == 0
                    else "cuda_cores")
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((1, 150, 2, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((1, 200, 2, hd), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    want = flash_ref.flash_attention(q.float(), k.float(), v.float(),
                                     causal=causal)
    got = flash_kernel.flash_attention(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= tol * max(
        1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,n,l,d,aligned", [
    (8, 40, 1, 768, True),       # decode: 32 slots of 4 vectors
    (2, 8, 1032, 2560, True),    # eval: streaming, one slot
    (3, 5, 7, 200, True),        # ragged: 4 slots
    (2, 3, 5, 96, False)])       # x off 16 bytes: one element per thread
def test_mux_plans_match_plain_version_on_card(cuda, dtype, tol, b, n, l, d,
                                               aligned):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((b, n, l, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    if not aligned:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        x = view
    plan = mux_kernel.plan(b, n, l, d, dtype, aligned)
    assert (plan.vec == 1) == (not aligned)
    want = mux_ref.hadamard_mux(x.float(), v.float())
    got = mux_kernel.hadamard_mux(x, v).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= tol * max(
        1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 4])
def test_gemma3_smoke_paged_kernels_match_plain_path_on_card(cuda, chunk):
    """gemma3-4b's smoke config (f32, window 16, every 2nd layer global)
    served past its window (max_len 46 + prefix 2): the paged pool with the
    paged, mux and decode-demux kernels (local layers in rings, global
    layers paged) against the contiguous plain path over the same weights,
    one-token and in chunks of 4, the same tokens fed to both: logits
    within 1e-4 x max(1, max|plain|) at every step, and the paged kernel
    launched once per global layer and step."""
    _smoke_paged_kernels_match_plain_path(cuda, "gemma3-4b", chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 4])
def test_llama4_smoke_paged_kernels_match_plain_path_on_card(cuda, chunk):
    """llama4-scout-17b-a16e's smoke config (f32, every layer MoE: 4
    experts top-1 and a shared expert; 4 query heads over 4 KV heads) the
    same way: the paged pool with every kernel against the contiguous
    plain path, logits within 1e-4 x max(1, max|plain|) at every step,
    the paged kernel launched once per layer and step."""
    _smoke_paged_kernels_match_plain_path(cuda, "llama4-scout-17b-a16e",
                                          chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 4])
def test_deepseek_smoke_paged_kernels_match_plain_path_on_card(cuda, chunk):
    """deepseek-v3-671b's smoke config (f32, every layer MLA with its latent
    rows pooled, layer 0 dense and layers 1-3 MoE with 4 experts top-2 and
    a shared expert) the same way: the paged pool with the mux and
    decode-demux kernels against the contiguous plain path, logits within
    1e-4 x max(1, max|plain|) at every step; the paged attention kernel
    never launched (MLA attends on the plain path)."""
    _smoke_paged_kernels_match_plain_path(cuda, "deepseek-v3-671b", chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 4])
def test_jamba_smoke_paged_kernels_match_plain_path_on_card(cuda, chunk):
    """jamba-1.5-large-398b's smoke config (f32: Mamba + MoE, attention +
    dense, Mamba + MoE, Mamba + dense) the same way: the paged pool (the
    attention layer pooled, the Mamba states contiguous beside it) with
    every kernel against the contiguous plain path, logits within 1e-4 x
    max(1, max|plain|) at every step; the paged kernel launched once per
    step by the one attention layer (Mamba layers launch none)."""
    _smoke_paged_kernels_match_plain_path(cuda, "jamba-1.5-large-398b",
                                          chunk)


@pytest.mark.cuda
def test_xlstm_smoke_paged_kernels_match_plain_path_on_card(cuda):
    """xlstm-125m's smoke config (f32: mLSTM, sLSTM, mLSTM, sLSTM) the
    same way at prefill_chunk 1: no layer pooled (the page table holds no
    tensor), the mux and decode-demux kernels against the contiguous plain
    path, logits within 1e-4 x max(1, max|plain|) at every step; no paged
    attention launch."""
    _smoke_paged_kernels_match_plain_path(cuda, "xlstm-125m", 1)


def _smoke_paged_kernels_match_plain_path(cuda, arch, chunk):
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine, ServeState
    from repro_torch.serving.kvcache import KVSlotAllocator
    from repro_torch.serving.paging import PagedKVSlotAllocator

    b = 2
    base = get_smoke_config(arch, mux_n=2)
    cfg = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=ServingConfig(paged=True, page_size=8, use_kernel=True,
                              fuse_demux=True, prefill_chunk=chunk))
    model = Backbone(cfg, seed=0, device=cuda).eval()
    plain = model.with_config(dataclasses.replace(
        base, serving=ServingConfig(prefill_chunk=chunk)))
    engines = []
    for m, paged in ((model, True), (plain, False)):
        eng = Engine(m, batch=b, max_len=46)
        primed = eng.prime(compact=paged)
        alloc = (PagedKVSlotAllocator if paged else KVSlotAllocator)(
            m.cfg, b, eng.max_len, template=primed.cache)
        engines.append((eng, alloc, primed))
    assert [any(key.endswith("_pages") for key in c)
            for c in engines[0][1].cache] == \
        [k["window"] is None and k["mixer"] in ("attn", "mla")
         for k in cfg.layer_kinds()]
    n = cfg.mux.n
    pos = engines[0][2].pos.cpu().numpy().copy()
    lens = np.full(b, chunk, np.int32)
    rng = np.random.default_rng(0)
    _build.LAUNCHES.clear()
    for _ in range(24 // chunk):
        shape = (b, n, chunk) if chunk > 1 else (b, n)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, shape)).to(cuda)
        kw = {"chunk_lens": lens} if chunk > 1 else \
            {"lane_mask": torch.ones((b, n), device=cuda)}
        out = []
        for eng, alloc, primed in engines:
            extra = {}
            if isinstance(alloc, PagedKVSlotAllocator):
                alloc.ensure(pos, np.ones(b, bool), lens)
                extra["block_table"] = alloc.block_table
            logits, st = eng.step(ServeState(alloc.cache, pos.copy(),
                                             primed.index_embeds), toks,
                                  **kw, **extra)
            alloc.adopt(st.cache)
            out.append(logits.float())
        got, want = out
        assert (got - want).abs().max().item() <= 1e-4 * max(
            1.0, want.abs().max().item())
        pos += chunk
    torch.cuda.synchronize()
    n_global = sum(k["mixer"] == "attn" and k["window"] is None
                   for k in cfg.layer_kinds())
    assert _build.LAUNCHES.get("paged_decode_attention", 0) == \
        n_global * (24 // chunk)
    assert _build.LAUNCHES["decode_demux"] == 24 // chunk


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b"])
def test_cross_smoke_kernels_match_plain_path_on_card(cuda, arch):
    """A cross-attention arch's smoke config (f32, N 2, cross sublayers on
    layers 0 and 2 with nonzero gates; whisper's with its 2-layer
    encoder), served lock-step over a context as the reference serves it:
    ``Engine.generate`` with the mux, index-embed and decode demux kernels
    (each launched as the steps say) against a plain ``with_config`` view
    fed the same tokens, logits within 1e-4 x max(1, max|plain|) at every
    step; then a flash view's forward over the context against the plain
    one, flash launched once per decoder layer (never by the
    bidirectional encoder or the cross-attention)."""
    import dataclasses

    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine

    b, steps = 2, 8
    base = get_smoke_config(arch, mux_n=2)
    cfg = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=ServingConfig(fuse_demux=True))
    model = Backbone(cfg, seed=0, device=cuda).eval()
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            if layer.cross is not None:
                layer.cross_gate.fill_(0.3 + 0.1 * i)
    plain = model.with_config(dataclasses.replace(base,
                                                  serving=ServingConfig()))
    g = torch.Generator(device=cuda).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (b, 2, 6), generator=g,
                            device=cuda)
    ctx = torch.randn((b, cfg.context_len, cfg.context_dim), generator=g,
                      device=cuda)

    def close(got, want):
        got, want = got.float(), want.float()
        return (got - want).abs().max().item() <= 1e-4 * max(
            1.0, want.abs().max().item())

    _build.LAUNCHES.clear()
    out = Engine(model, batch=b, max_len=16).generate(prompts, steps,
                                                      context=ctx)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"hadamard_mux": steps + 1,
                                     "index_embed_demux": 1,
                                     "decode_demux": steps}
    engines = [Engine(m, batch=b, max_len=16) for m in (model, plain)]
    states = [e.prefill(prompts, context=ctx) for e in engines]
    for t in range(steps):
        assert close(states[0][0], states[1][0])
        states = [e.step(st, out[..., t])
                  for e, (_, st) in zip(engines, states)]
    assert close(states[0][0], states[1][0])
    flash = model.with_config(dataclasses.replace(cfg,
                                                  serving=ServingConfig()),
                              use_flash=True)
    toks = torch.randint(0, cfg.vocab, (1, 2, 30), generator=g, device=cuda)
    _build.LAUNCHES.clear()
    with torch.no_grad():
        got = flash(toks, context=ctx[:1])["logits"]
        want = plain(toks, context=ctx[:1])["logits"]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == cfg.n_layers
    assert close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [2, 8])
def test_moe_is_bitwise_repeatable_on_card(cuda, dtype, top_k):
    """The MoE block (16 experts, sigmoid scoring, a shared expert, tokens
    dropped at capacity 1.25) gives the same bits on every call: each
    row's top-k contributions are added one choice at a time in ascending
    expert order, with no float atomics; and its output is the CPU's on
    the same weights and inputs in the same dtype (the router float32 in
    both) within 1e-4 (f32) / 1e-2 (bf16) x max(1, max|CPU|)."""
    from repro_torch.nn.moe import MoE, MoEConfig

    cfg = MoEConfig(dim=256, moe_ff=128, n_experts=16, top_k=top_k,
                    n_shared_experts=1, router_scoring="sigmoid")
    cpu = MoE(cfg, generator=torch.Generator().manual_seed(0)).eval()
    cpu.to(dtype).router.float()
    model = MoE(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                device=cuda, dtype=dtype).eval()
    model.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 32, 256), generator=g).to(dtype)
    mask = torch.rand((4, 32), generator=g) > 0.2
    with torch.no_grad():
        want, want_aux = cpu(x, mask)
        want = want.float()
        outs = [model(x.to(cuda), mask.to(cuda)) for _ in range(3)]
    torch.cuda.synchronize()
    for out, aux in outs[1:]:
        assert torch.equal(out, outs[0][0]) and torch.equal(aux, outs[0][1])
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    got = outs[0][0].float().cpu()
    assert (got - want).abs().max().item() <= tol * max(
        1.0, want.abs().max().item())
    assert abs(float(outs[0][1]) - float(want_aux)) <= 1e-4 * max(
        1.0, float(want_aux))


# llama4-scout-17b-a16e's kernel shapes in chip_smoke.py's [moe] phase
# (d 5120, H 10240, 40 heads over 8 KV heads of 128), bf16.
LLAMA4_CARD = [
    ("hadamard_mux", (8, 8, 1, 5120)), ("hadamard_mux", (8, 8, 4, 5120)),
    ("hadamard_mux", (1, 8, 520, 5120)),
    ("decode_demux", (8, 8, 1, 5120)), ("decode_demux", (8, 8, 4, 5120)),
    ("index_embed_demux", (1, 8, 512, 5120)),
    ("flash_attention", (1, 520, 40, 128)),
    ("paged_decode_attention", (8, 1)), ("paged_decode_attention", (8, 4)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", LLAMA4_CARD)
def test_kernels_at_llama4_shapes_on_card(cuda, name, shape):
    """Each kernel at llama4-scout's shapes against its plain version run
    in f32 on the same bf16 inputs, within 1e-2 x max(1, max|plain|) (the
    paged kernel on query rows with a valid key)."""
    _kernel_matches_plain_version_at(cuda, name, shape)


# deepseek-v3-671b's kernel shapes in chip_smoke.py's [mla] phase (d 7168,
# H 14336), bf16: MLA runs neither the flash nor the paged kernel.
DEEPSEEK_CARD = [
    ("hadamard_mux", (8, 8, 1, 7168)), ("hadamard_mux", (8, 8, 4, 7168)),
    ("hadamard_mux", (1, 8, 520, 7168)),
    ("decode_demux", (8, 8, 1, 7168)), ("decode_demux", (8, 8, 4, 7168)),
    ("index_embed_demux", (1, 8, 512, 7168)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", DEEPSEEK_CARD)
def test_kernels_at_deepseek_shapes_on_card(cuda, name, shape):
    """The mux and both demux kernels at deepseek-v3-671b's shapes against
    their plain versions, as at llama4-scout's."""
    _kernel_matches_plain_version_at(cuda, name, shape)


# jamba-1.5-large-398b's kernel shapes in chip_smoke.py's [hybrid] phase
# (d 8192, H 16384; 64 heads over 8 KV heads of 128, n_rep 8: 8 query rows
# per KV head at C 1 and 32 at C 4), bf16.
JAMBA_CARD = [
    ("hadamard_mux", (8, 8, 1, 8192)), ("hadamard_mux", (8, 8, 4, 8192)),
    ("hadamard_mux", (1, 8, 520, 8192)),
    ("decode_demux", (8, 8, 1, 8192)), ("decode_demux", (8, 8, 4, 8192)),
    ("index_embed_demux", (1, 8, 512, 8192)),
    ("flash_attention", (1, 520, 64, 128)),
    ("paged_decode_attention", (8, 1, 64)),
    ("paged_decode_attention", (8, 4, 64)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", JAMBA_CARD)
def test_kernels_at_jamba_shapes_on_card(cuda, name, shape):
    """Each kernel at jamba's shapes against its plain version, as at
    llama4-scout's (the paged kernel at n_rep 8)."""
    _kernel_matches_plain_version_at(cuda, name, shape)


def _kernel_matches_plain_version_at(cuda, name, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*dims, scale=1.0):
        return (scale * torch.randn(dims, generator=g, device=cuda)).to(bf16)

    live = 1.0
    if name == "hadamard_mux":
        x, v = randn(*shape), randn(shape[1], shape[3])
        want = mux_ref.hadamard_mux(x.float(), v.float())
        got = mux_kernel.hadamard_mux(x, v)
    elif name == "flash_attention":
        q, k, v = (randn(*shape) for _ in range(3))
        want = flash_ref.flash_attention(q.float(), k.float(), v.float(),
                                         causal=True)
        got = flash_kernel.flash_attention(q, k, v, causal=True)
    elif name == "paged_decode_attention":
        b, c, *heads = shape          # 40 query heads unless given
        args = _paged_case(cuda, bf16, b, heads[0] if heads else 40, 8,
                           128, b * 9 + 1, 16, 9, c)
        f32 = [t.float() if t.is_floating_point() else t for t in args]
        want = paged_ref.paged_attention(*f32, scale=128 ** -0.5,
                                         causal=True)
        got = paged_kernel.paged_decode_attention(*args, scale=128 ** -0.5,
                                                  causal=True)
        live = _live(args, causal=True, window=None)
    else:
        b, n, l, d = shape
        hid = 2 * d
        mlp = SharedMLPStack([2 * d, hid, d], device=cuda, dtype=bf16)
        h, p = randn(b, l, d), randn(b, n, d)
        l0, l1 = mlp.layers()
        with torch.no_grad():
            want = demux_ref.index_embed_demux(mlp.float(), h.float(),
                                               p.float())
            mlp.to(bf16)
            got = getattr(demux_kernel, name)(h, p, l0.weight, l0.bias,
                                              l1.weight, l1.bias)
    torch.cuda.synchronize()
    err = ((got.float() - want) * live).abs().max().item()
    assert err <= 1e-2 * max(1.0, (want * live).abs().max().item())


def _mla_steps(device, seed=0):
    """An f32 MLA (d 96, 4 heads, q rank 48, latent 32, nope 16, rope 8,
    v 24) on ``device``, weights from ``seed``: its outputs over a
    cache-free forward of 12 positions, a prefill of 5 into a 16-row
    latent cache and two one-token steps at per-slot positions, and a
    3-row chunked step (ragged lengths) into a pool of pages of 4 through
    a scattered block table; all on inputs made on the CPU."""
    from repro_torch.nn.attention import MLA, MLAConfig

    cfg = MLAConfig(dim=96, n_heads=4, q_lora_rank=48, kv_lora_rank=32,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=24)
    model = MLA(cfg, generator=torch.Generator().manual_seed(seed)).eval()
    model.to(device)
    g = torch.Generator().manual_seed(seed + 1)

    def x(b, l):
        return torch.randn((b, l, cfg.dim), generator=g).to(device)

    def ar(*rows):
        return torch.tensor(rows, dtype=torch.int32, device=device)
    outs = []
    with torch.no_grad():
        pos = torch.arange(12, device=device).expand(3, 12)
        outs.append(model(x(3, 12), positions=pos)[0])
        cache = MLA.init_cache(cfg, 3, 16, torch.float32, device)
        outs.append(model(x(3, 5), positions=pos[:, :5], cache=cache)[0])
        for t in range(2):
            ci = ar(5 + t, 7 + t, 6 + t)
            outs.append(model(x(3, 1), positions=ci[:, None], cache=cache,
                              cache_index=ci)[0])
        pool = MLA.init_paged_cache(cfg, 14, 4, torch.float32, device)
        bt = ar([3, 7, 1, 9], [5, 2, 12, 4], [6, 13, 10, -1])
        base = ar(0, 2, 4)
        positions = base[:, None] + torch.arange(3, device=device)
        outs.append(model(x(3, 3), positions=positions, cache=pool,
                          cache_index=base, chunk_lens=ar(3, 1, 2),
                          block_table=bt)[0])
    return outs


@pytest.mark.cuda
def test_mla_matches_the_cpu_and_repeats_on_card(cuda):
    """The MLA module in f32 on the card, in each of its modes (the
    cache-free forward, prefill, contiguous decode at per-slot positions,
    paged chunked decode), against the same weights and inputs on the CPU
    within 1e-4 x max(1, max|CPU|), and bitwise the same on a second run.
    MLA launches none of the port's kernels."""
    want = _mla_steps(torch.device("cpu"))
    _build.LAUNCHES.clear()
    first, second = _mla_steps(cuda), _mla_steps(cuda)
    torch.cuda.synchronize()
    assert not _build.LAUNCHES
    for w, a, b in zip(want, first, second):
        assert torch.equal(a, b)
        assert (a.cpu() - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())


def _mamba_steps(device, seed=0):
    """An f32 Mamba (d 64, d_inner 128, state 16, scan chunks of 8) on
    ``device``, weights from ``seed``: its outputs over a cache-free scan
    of 21 positions (a padded last chunk), a prefill of 5 into a fresh
    cache, two one-token steps and a 3-row chunked step with ragged
    counts; all on inputs made on the CPU."""
    from repro_torch.nn.ssm import Mamba, MambaConfig

    cfg = MambaConfig(dim=64, d_state=16, chunk=8)
    model = Mamba(cfg, generator=torch.Generator().manual_seed(seed)).eval()
    model.to(device)
    g = torch.Generator().manual_seed(seed + 1)

    def x(b, l):
        return torch.randn((b, l, cfg.dim), generator=g).to(device)
    outs = []
    with torch.no_grad():
        outs.append(model(x(3, 21))[0])
        cache = Mamba.init_cache(cfg, 3, torch.float32, device)
        outs.append(model(x(3, 5), cache=cache)[0])
        for _ in range(2):
            outs.append(model(x(3, 1), cache=cache)[0])
        lens = torch.tensor([3, 0, 2], device=device)
        outs.append(model(x(3, 3), cache=cache, chunk_lens=lens)[0])
        outs += [cache["ssm"], cache["conv"]]
    return outs


@pytest.mark.cuda
def test_mamba_matches_the_cpu_and_repeats_on_card(cuda):
    """The Mamba module in f32 on the card, in each of its modes (the
    cache-free scan, prefill, one-token decode, row-gated chunked decode)
    and its final states, against the same weights and inputs on the CPU
    within 1e-4 x max(1, max|CPU|), and bitwise the same on a second run.
    Mamba launches none of the port's kernels."""
    want = _mamba_steps(torch.device("cpu"))
    _build.LAUNCHES.clear()
    first, second = _mamba_steps(cuda), _mamba_steps(cuda)
    torch.cuda.synchronize()
    assert not _build.LAUNCHES
    for w, a, b in zip(want, first, second):
        assert torch.equal(a, b)
        assert (a.cpu() - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())


def _xlstm_steps(device, mixer, seed=0):
    """An f32 mLSTM or sLSTM (d 64, 4 heads) on ``device``, weights from
    ``seed``: its outputs over a cache-free run of 21 positions, a prefill
    of 5 into a fresh cache, two one-token steps, and the final states;
    all on inputs made on the CPU."""
    from repro_torch.nn.ssm import MLSTM, SLSTM, XLSTMConfig

    cls = MLSTM if mixer == "mlstm" else SLSTM
    cfg = XLSTMConfig(dim=64, n_heads=4)
    model = cls(cfg, generator=torch.Generator().manual_seed(seed)).eval()
    model.to(device)
    g = torch.Generator().manual_seed(seed + 1)

    def x(b, l):
        return torch.randn((b, l, cfg.dim), generator=g).to(device)
    outs = []
    with torch.no_grad():
        outs.append(model(x(3, 21))[0])
        cache = cls.init_cache(cfg, 3, device)
        outs.append(model(x(3, 5), cache=cache)[0])
        for _ in range(2):
            outs.append(model(x(3, 1), cache=cache)[0])
        outs += list(cache.values())
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_xlstm_matches_the_cpu_and_repeats_on_card(cuda, mixer):
    """The mLSTM and sLSTM modules in f32 on the card, in each mode (the
    cache-free run, prefill, one-token decode) and their final states,
    against the same weights and inputs on the CPU within 1e-4 x max(1,
    max|CPU|), and bitwise the same on a second run.  They launch none of
    the port's kernels."""
    want = _xlstm_steps(torch.device("cpu"), mixer)
    _build.LAUNCHES.clear()
    first, second = _xlstm_steps(cuda, mixer), _xlstm_steps(cuda, mixer)
    torch.cuda.synchronize()
    assert not _build.LAUNCHES
    for w, a, b in zip(want, first, second):
        assert torch.equal(a, b)
        assert (a.cpu() - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())


IMAGE_STRATEGIES = ["identity", "ortho", "lowrank", "binary", "hadamard",
                    "rotation", "nonlinear"]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["MuxMLP", "MuxCNN"])
@pytest.mark.parametrize("strategy", IMAGE_STRATEGIES)
def test_image_models_match_the_cpu_on_card(cuda, model, strategy):
    """``MuxMLP`` and ``MuxCNN`` at the paper's sizes (20x20, N 4) with
    each strategy, f32: logits and the ``image_loss`` gradient of every
    parameter on the card against the same weights on the CPU within 1e-4
    x max(1, max|CPU|).  The mux launches no kernel (the image models mix
    through the strategies' plain ``combine``)."""
    from repro_torch.models import image

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = image.ImageMuxConfig(n=4, strategy=strategy)
    cls = getattr(image, model)
    g = torch.Generator().manual_seed(0)
    imgs = torch.randn((8, 4, 20, 20), generator=g)
    labels = torch.randint(0, 10, (8, 4), generator=g)
    cpu = cls(cfg, seed=0, device="cpu")
    card = cls(cfg, seed=0, device="cpu").to(cuda)
    card.load_state_dict(cpu.state_dict())
    _build.LAUNCHES.clear()
    out = []
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        logits = m(imgs.to(dev))
        loss, _ = image.image_loss(logits, labels.to(dev))
        grads = torch.autograd.grad(loss, list(m.parameters()),
                                    allow_unused=True)   # a frozen mux
        out.append([logits.detach(), loss.detach(),
                    *(g for g in grads if g is not None)])
    assert len(out[0]) == len(out[1])
    torch.cuda.synchronize()
    assert not _build.LAUNCHES
    for w, a in zip(*out):
        assert (a.cpu() - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())


@pytest.mark.cuda
def test_moe_shard_path_at_world_one_is_the_unsharded_block(cuda):
    """The expert-parallel path of the MoE block, run past the size-1
    shortcut on a world-1 ``nccl`` mesh (its all-to-all and sums issued
    over size-1 groups), is bitwise the unsharded block in out and aux,
    bf16, at a decode block (B 8, L 1) and a prefill block (B 8, L 40)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.nn.moe import MoE, MoEConfig, OnMesh
    from repro_torch.sharding import mesh_info_from_mesh

    cfg = MoEConfig(dim=512, moe_ff=1024, n_experts=16, top_k=1,
                    n_shared_experts=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    moe = MoE(cfg, generator=gen, device=cuda, dtype=torch.bfloat16)
    mesh = make_test_mesh(cuda)
    try:
        mi = mesh_info_from_mesh(mesh)
        for rows in (1, 40):
            x = torch.randn(8, rows, cfg.dim, generator=gen, device=cuda,
                            dtype=torch.bfloat16)
            with torch.no_grad():
                want = moe(x)
                got = moe(x, on_mesh=OnMesh(mesh, mi), shortcut=False)
            assert torch.equal(got[0], want[0]), rows
            assert torch.equal(got[1], want[1]), rows
    finally:
        dist.destroy_process_group()
