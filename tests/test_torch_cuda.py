"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so on a GPU machine without JAX it runs
alone:  ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda.py``.  Tolerances: 1e-4 (f32) and 1e-2 (bf16) of
max(1, max|plain|), the plain version run in f32 on the same inputs — the
kernels accumulate in f32 and round only their output.  The paged
attention kernel is compared on query rows with at least one valid key
(rows with none are garbage in every implementation).
"""
import pytest
import torch

from repro_torch.kernels import _build
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
    agree within f32 rounding."""
    args = _paged_case(cuda, torch.float32, 2, 4, 2, 32, 11, 4, 6, 2)
    outs = [paged_kernel.paged_decode_attention(
        *args, scale=32 ** -0.5, causal=True, kblock_pages=kb)
        for kb in (1, 2, 4)]
    live = _live(args, causal=True, window=None)
    for o in outs[1:]:
        assert ((o - outs[0]) * live).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_paged_kernel_raises_on_what_it_does_not_take(cuda):
    args = _paged_case(cuda, torch.bfloat16, 1, 2, 1, 20, 5, 4, 2, 1)
    with pytest.raises(ValueError, match="head_dim 20"):
        paged_kernel.paged_decode_attention(*args, scale=1.0)
    args = _paged_case(cuda, torch.float32, 1, 2, 1, 64, 5, 4, 2, 1)
    args[3] = args[3].long()
    with pytest.raises(TypeError, match="int64"):
        paged_kernel.paged_decode_attention(*args, scale=1.0)
