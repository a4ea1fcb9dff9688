"""The port's kernel ops against the JAX package's Pallas kernels (interpret
mode) and its jnp references, f32, same numpy inputs.  On the CPU the port's
ops take their plain PyTorch versions; the CUDA kernels themselves are held
against those plain versions by ``tests/test_torch_cuda.py`` (on a card)
and by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.demux import kernel as jax_demux_kernel
from repro.kernels.demux import ref as jax_demux_ref
from repro.kernels.multiplex import kernel as jax_mux_kernel
from repro.kernels.multiplex import ref as jax_mux_ref
from repro_torch.kernels import _build
from repro_torch.kernels.demux import kernel as demux_kernel
from repro_torch.kernels.demux import ops as demux_ops
from repro_torch.kernels.demux import ref as demux_ref
from repro_torch.kernels.multiplex import kernel as mux_kernel
from repro_torch.kernels.multiplex import ops as mux_ops
from repro_torch.kernels.multiplex import ref as mux_ref
from repro_torch.nn.layers import SharedMLPStack

ATOL = 1e-5


def _mlp(rng, dims):
    """The same 2+-layer shared MLP as a JAX param dict and a port module."""
    jax_params, module = {}, SharedMLPStack(dims, device="cpu")
    for i, layer in enumerate(module.layers()):
        w = rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) \
            / np.sqrt(dims[i])
        b = 0.1 * rng.standard_normal(dims[i + 1]).astype(np.float32)
        jax_params[f"l{i}"] = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w.T.copy()))
            layer.bias.copy_(torch.from_numpy(b))
    return jax_params, module


@pytest.mark.parametrize("b,n,l,d", [(1, 2, 8, 128), (2, 5, 33, 192),
                                     (1, 4, 3, 64)])
def test_mux_op_matches_jax(b, n, l, d):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, n, l, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    got = mux_ops.hadamard_mux(torch.from_numpy(x), torch.from_numpy(v))
    for want in (jax_mux_kernel.hadamard_mux(x, v, interpret=True),
                 jax_mux_ref.hadamard_mux(x, v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("fn", ["index_embed_demux", "decode_demux"])
@pytest.mark.parametrize("b,n,l,d,hidden", [(1, 2, 8, 64, 128),
                                            (2, 3, 5, 96, 160),
                                            (2, 4, 1, 64, 128)])
def test_demux_ops_match_jax(fn, b, n, l, d, hidden):
    rng = np.random.default_rng(1)
    jax_mlp, mlp = _mlp(rng, [2 * d, hidden, d])
    h = rng.standard_normal((b, l, d)).astype(np.float32)
    p = rng.standard_normal((b, n, d)).astype(np.float32)
    with torch.no_grad():
        got = getattr(demux_ops, fn)(mlp, torch.from_numpy(h),
                                     torch.from_numpy(p))
    assert got.shape == (b, n, l, d)
    want_kernel = getattr(jax_demux_kernel, fn)(jax_mlp, h, p, interpret=True)
    for want in (want_kernel, jax_demux_ref.index_embed_demux(jax_mlp, h, p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_deeper_demux_takes_the_plain_version():
    """demux_layers != 2 goes to the plain version: the whole shared MLP on
    the concat, one layer after another."""
    rng = np.random.default_rng(2)
    d = 32
    _, mlp = _mlp(rng, [2 * d, 48, 48, d])
    h = torch.from_numpy(rng.standard_normal((2, 3, d)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((2, 4, d)).astype(np.float32))
    with torch.no_grad():
        want = mlp(torch.cat([h[:, None].expand(2, 4, 3, d),
                              p[:, :, None].expand(2, 4, 3, d)], dim=-1))
        for fn in (demux_ops.index_embed_demux, demux_ops.decode_demux):
            torch.testing.assert_close(fn(mlp, h, p), want, atol=0, rtol=0)


def test_cpu_ops_launch_no_kernel():
    rng = np.random.default_rng(3)
    _, mlp = _mlp(rng, [64, 64, 32])
    x = torch.randn(2, 3, 4, 32)
    h, p = torch.randn(2, 4, 32), torch.randn(2, 3, 32)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        mux_ops.hadamard_mux(x, torch.randn(3, 32))
        demux_ops.index_embed_demux(mlp, h, p)
        demux_ops.decode_demux(mlp, h, p)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("call", ["mux", "demux", "decode"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches only on CUDA tensors: a CPU tensor is refused
    before anything is built or launched."""
    x = torch.randn(2, 3, 4, 8)
    h, p = torch.randn(2, 4, 8), torch.randn(2, 3, 8)
    w1, b1, w2, b2 = (torch.randn(16, 16), torch.randn(16),
                      torch.randn(8, 16), torch.randn(8))
    with pytest.raises(ValueError, match="not CUDA"):
        if call == "mux":
            mux_kernel.hadamard_mux(x, torch.randn(3, 8))
        elif call == "demux":
            demux_kernel.index_embed_demux(h, p, w1, b1, w2, b2)
        else:
            demux_kernel.decode_demux(h, p, w1, b1, w2, b2)


def test_plain_versions_match_their_definitions():
    """ref.py holds the functions the kernels must compute: (1/N)·Σ x⊙v and
    gelu_tanh([h ; p]·W1 + b1)·W2 + b2."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 5, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    want = sum(x[:, i] * v[i] for i in range(3)) / 3
    torch.testing.assert_close(mux_ref.hadamard_mux(x, v), want)
    _, mlp = _mlp(rng, [16, 12, 8])
    h = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((2, 3, 8)).astype(np.float32))
    l0, l1 = mlp.layers()
    with torch.no_grad():
        z = h[:, None] @ l0.weight[:, :8].T + p[:, :, None] @ \
            l0.weight[:, 8:].T + l0.bias
        gelu = 0.5 * z * (1 + torch.tanh(np.sqrt(2 / np.pi)
                                         * (z + 0.044715 * z ** 3)))
        want = gelu @ l1.weight.T + l1.bias
        torch.testing.assert_close(demux_ref.index_embed_demux(mlp, h, p),
                                   want, atol=1e-5, rtol=1e-5)
