"""Plain PyTorch version of the fused index-embed demultiplexer (paper
Sec 3.2): h^i_j = MLP_shared([h_j ; p^i]) on the materialised concat."""
from __future__ import annotations

import torch


def index_embed_demux(mlp, h, index_embeds):
    """mlp: ``SharedMLPStack`` with layers l0 (2d -> H) ... (-> d).
    h: (B, L, d); index_embeds: (B, N, d).  Returns (B, N, L, d)."""
    b, l, d = h.shape
    n = index_embeds.shape[1]
    hb = h[:, None].expand(b, n, l, d)
    pb = index_embeds[:, :, None].expand(b, n, l, d).to(h.dtype)
    return mlp(torch.cat([hb, pb], dim=-1))
