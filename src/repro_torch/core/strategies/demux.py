"""Demultiplexing strategies (paper Sec 3.2).

  * "index_embed" — the paper's main method for Transformers.  Each instance
    is prepended with prefix^i (index token ε^i at position i, ε^pad
    elsewhere); the backbone's output at prefix position i is the index
    embedding p^i, and a *shared* MLP on [h_j^{1:N} ; p^i] emits h_j^i.
  * "mlp" — N independent MLPs, h^i = MLP^i(h^{1:N}).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.strategies.base import DemuxStrategy, ParamModule
from repro_torch.core.strategies.registry import register_demux
from repro_torch.nn import activations, initializers
from repro_torch.nn.layers import SharedMLPStack


def _dims(cfg, d: int, in_dim: int) -> list[int]:
    hidden = getattr(cfg, "demux_hidden", 0) or 2 * d
    return [in_dim] + [hidden] * (getattr(cfg, "demux_layers", 2) - 1) + [d]


@register_demux("index_embed")
class IndexEmbedDemux(DemuxStrategy):
    """Shared MLP on [mixed state ; index embedding] via the prefix protocol."""

    uses_kernel = True
    uses_prefix = True
    fused_decode = True

    def init(self, cfg, d, *, generator, device=None, dtype=torch.float32):
        return ParamModule(
            # ε^1..ε^N index tokens + ε^pad  (paper Sec 3.2)
            prefix_table=initializers.normal(
                (cfg.n + 1, d), 0.02, generator=generator, device=device,
                dtype=dtype),
            mlp=SharedMLPStack(_dims(cfg, d, 2 * d), generator=generator,
                               device=device, dtype=dtype))

    def narrow(self, params, cfg, w):
        """Keep ε^1..ε^w, the shared ε^pad row and the shared MLP."""
        table = params.prefix_table
        return ParamModule(prefix_table=torch.cat([table[:w], table[-1:]]),
                           mlp=params.mlp)

    def prefix_embeddings(self, params, cfg, dtype):
        """(N, P, d): prefix^i = [pad..pad, ε^i, pad..pad] with ε^i at
        position i; positions >= N are all ε^pad."""
        n, p = cfg.n, cfg.prefix_len
        table = params.prefix_table.to(dtype)
        out = table[n].expand(n, p, table.shape[-1]).clone()
        idx = torch.arange(n, device=table.device)
        out[idx, idx] = table[:n]
        return out

    def separate(self, params, h, cfg, *, index_embeds=None):
        assert index_embeds is not None, "index_embed demux needs index_embeds"
        b, l, d = h.shape
        n = index_embeds.shape[1]
        hb = h[:, None].expand(b, n, l, d)
        pb = index_embeds[:, :, None].expand(b, n, l, d)
        return params.mlp(torch.cat([hb, pb], dim=-1))

    def kernel_apply(self, params, h, cfg, *, index_embeds=None):
        assert index_embeds is not None, "index_embed demux needs index_embeds"
        from repro_torch.kernels.demux import ops as demux_ops
        return demux_ops.index_embed_demux(params.mlp, h, index_embeds)

    def decode_apply(self, params, h, cfg, *, index_embeds=None):
        """Fused decode epilogue (``ServingConfig.fuse_demux``): all N lanes
        of a slot in one program, the shared h·W1h computed once per slot.
        Deeper shared MLPs (demux_layers != 2) take the plain version inside
        the op."""
        assert index_embeds is not None, "index_embed demux needs index_embeds"
        from repro_torch.kernels.demux import ops as demux_ops
        return demux_ops.decode_demux(params.mlp, h, index_embeds)


class _StackedMLP(nn.Module):
    """N independent MLPs with their weights stacked on a leading N axis:
    layer ``l{i}`` holds ``weight`` (N, out, in) and ``bias`` (N, out)."""

    def __init__(self, layers: list[tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.n_layers = len(layers)
        for i, (w, b) in enumerate(layers):
            self.add_module(f"l{i}", ParamModule(weight=w, bias=b))

    def layers(self) -> list[ParamModule]:
        return [getattr(self, f"l{i}") for i in range(self.n_layers)]

    def forward(self, h):
        """h: (B, L, d) -> (B, N, L, d)."""
        act = activations.get("gelu")
        x = h
        for i, layer in enumerate(self.layers()):
            eq = "bli,noi->bnlo" if i == 0 else "bnli,noi->bnlo"
            x = torch.einsum(eq, x, layer.weight.to(h.dtype)) + \
                layer.bias.to(h.dtype)[None, :, None, :]
            if i < self.n_layers - 1:
                x = act(x)
        return x


@register_demux("mlp")
class MLPDemux(DemuxStrategy):
    """N independent MLPs on the mixed state — params ∝ N (paper Sec 3.2)."""

    def init(self, cfg, d, *, generator, device=None, dtype=torch.float32):
        dims = _dims(cfg, d, d)
        layers = [
            (initializers.scaled_normal(
                (cfg.n, dims[i + 1], dims[i]), dims[i], generator=generator,
                device=device, dtype=dtype),
             torch.zeros((cfg.n, dims[i + 1]), device=device, dtype=dtype))
            for i in range(len(dims) - 1)]
        return ParamModule(mlps=_StackedMLP(layers))

    def narrow(self, params, cfg, w):
        return ParamModule(mlps=_StackedMLP(
            [(layer.weight[:w], layer.bias[:w])
             for layer in params.mlps.layers()]))

    def separate(self, params, h, cfg, *, index_embeds=None):
        del index_embeds
        return params.mlps(h)
