"""Public ops: fused index-embed demux, prefill and decode forms.

Reached through ``IndexEmbedDemux.kernel_apply`` / ``decode_apply``
(``repro_torch.core.strategies.demux``).  A CPU or meta tensor takes the
plain version (``kernels.takes_kernel``); so does a shared MLP that is
not the kernels' 2-layer shape (``demux_layers != 2``), on any device.
Otherwise a CUDA tensor launches the kernel, which raises on what it does
not take.  Weights and index embeddings are cast to h's dtype first, as
the reference does.
"""
from __future__ import annotations

from repro_torch.kernels import takes_kernel
from repro_torch.kernels.demux import kernel, ref


def _operands(mlp, h, index_embeds):
    l0, l1 = mlp.layers()
    dt = h.dtype
    return (h.contiguous(), index_embeds.to(dt).contiguous(),
            l0.weight.to(dt), l0.bias.to(dt), l1.weight.to(dt),
            l1.bias.to(dt))


def index_embed_demux(mlp, h, index_embeds):
    """h: (B, L, d); index_embeds: (B, N, d) -> (B, N, L, d)."""
    if mlp.n_layers != 2 or not takes_kernel(h):
        return ref.index_embed_demux(mlp, h, index_embeds)
    return kernel.index_embed_demux(*_operands(mlp, h, index_embeds))


def decode_demux(mlp, h, index_embeds):
    """Decode-epilogue fused demux: h (B, C, d), C the decode chunk width
    -> (B, N, C, d)."""
    if mlp.n_layers != 2 or not takes_kernel(h):
        return ref.index_embed_demux(mlp, h, index_embeds)
    return kernel.decode_demux(*_operands(mlp, h, index_embeds))
