"""Plain PyTorch version of flash attention: the reference's oracle
(``repro.kernels.attention.ref``) written out — einsum, float32 scores,
``NEG_INF`` causal mask aligned top-left, float32 softmax, probabilities
cast to V's dtype, einsum.  The CPU runs it in place of the kernel; on the
card the tests and ``chip_smoke.py`` hold the kernel against it."""
from __future__ import annotations

import torch

from repro_torch.nn.attention import NEG_INF


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """q: (B, Lq, H, hd); k, v: (B, Lk, H, hd), KV already repeated for
    GQA.  Returns (B, Lq, H, hd).  Causal keeps key j for query i when
    j <= i."""
    hd = q.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float().mul_(scale)
    if causal:
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        logits.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
