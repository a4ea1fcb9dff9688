"""Core layers: Linear, Embedding, norms, gated/ungated MLP blocks.

Weights are stored ``(out, in)`` and applied with ``F.linear`` (the JAX
package stores ``(in, out)``; ``repro_torch.bridge`` transposes).  Params
are kept in ``dtype`` and cast to the input's dtype at use, as in the
reference.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.nn import activations, initializers


def profiler_label(name: str):
    """A profiler range named ``name`` (its device time counts the kernels
    launched inside it), entered only while a profiler runs:
    ``record_function`` costs host time even with no profiler running."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def _cast(p, dtype):
    return p if p is None or p.dtype == dtype else p.to(dtype)


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 stddev: float | None = None, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        shape = (out_dim, in_dim)
        if stddev is None:
            w = initializers.scaled_normal(shape, in_dim, generator=generator,
                                           device=device, dtype=dtype)
        else:
            w = initializers.normal(shape, stddev, generator=generator,
                                    device=device, dtype=dtype)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device,
                                             dtype=dtype)) if bias else None

    def forward(self, x):
        return F.linear(x, _cast(self.weight, x.dtype),
                        _cast(self.bias, x.dtype))


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, stddev: float = 0.02,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.table = nn.Parameter(initializers.normal(
            (vocab, dim), stddev, generator=generator, device=device,
            dtype=dtype))

    def forward(self, ids, *, dtype=None):
        table = self.table if dtype is None else _cast(self.table, dtype)
        return F.embedding(ids, table)

    def attend(self, x):
        """Tied-embedding logits: x @ table.T."""
        return F.linear(x, _cast(self.table, x.dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        return (xf * self.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + self.eps)
        return (xf * self.scale.float() + self.bias.float()).to(x.dtype)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return RMSNorm
    if kind == "layernorm":
        return LayerNorm
    raise ValueError(f"unknown norm {kind!r}")


class MLP(nn.Module):
    """Transformer FFN.  ``gated=True`` gives the GLU family (GeGLU/SwiGLU);
    otherwise the classic up->act->down block."""

    def __init__(self, dim: int, hidden: int, *, gated: bool,
                 activation: str, bias: bool = False, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(bias=bias, generator=generator, device=device, dtype=dtype)
        self.act = activations.get(activation)
        self.up = Linear(dim, hidden, **kw)
        self.down = Linear(hidden, dim, **kw)
        self.gate = Linear(dim, hidden, **kw) if gated else None

    def forward(self, x):
        up = self.up(x)
        h = self.act(self.gate(x)) * up if self.gate is not None \
            else self.act(up)
        return self.down(h)


class SharedMLPStack(nn.Module):
    """n-layer MLP with an activation between layers (the DataMUX
    demultiplexer head).  Layers are named ``l0``, ``l1``, ... as in the
    reference's param tree."""

    def __init__(self, dims: list[int], *, bias: bool = True,
                 activation: str = "gelu", generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.act = activations.get(activation)
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.add_module(f"l{i}", Linear(
                dims[i], dims[i + 1], bias=bias, generator=generator,
                device=device, dtype=dtype))

    def layers(self) -> list[Linear]:
        return [getattr(self, f"l{i}") for i in range(self.n_layers)]

    def forward(self, x):
        layers = self.layers()
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = self.act(x)
        return x
