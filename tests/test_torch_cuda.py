"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so on a GPU machine without JAX it runs
alone:  ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda.py``.  Tolerances: 1e-4 (f32) and 1e-2 (bf16) of
max(1, max|plain|), the plain version run in f32 on the same inputs — the
kernels accumulate in f32 and round only their output.
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.demux import kernel as demux_kernel
from repro_torch.kernels.demux import ref as demux_ref
from repro_torch.kernels.multiplex import kernel as mux_kernel
from repro_torch.kernels.multiplex import ref as mux_ref
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
