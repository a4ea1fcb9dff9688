"""Public op: paged-attention decode.

Routed as the reference routes it: ``use_kernel=False`` (the configured
default) takes the plain gather version on any device; ``use_kernel=True``
takes the plain version for a CPU tensor and launches the CUDA kernel for a
CUDA tensor, which raises on what it does not take.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.paged_attention import kernel, ref


def paged_attention(q, k_pages, v_pages, pos_pages, block_table, q_pos, *,
                    scale: float, causal: bool = True,
                    window: Optional[int] = None, use_kernel: bool = False,
                    kblock_pages: int = 1):
    """q: (B, C, H, hd) -> (B, C, H, hd); see ``ref.paged_attention``.
    ``kblock_pages`` only sets the kernel's staging width; the plain
    version ignores it."""
    if use_kernel and q.device.type != "cpu":
        return kernel.paged_decode_attention(
            q.contiguous(), k_pages, v_pages, pos_pages, block_table,
            q_pos.contiguous(), scale=scale, causal=causal, window=window,
            kblock_pages=kblock_pages)
    return ref.paged_attention(q, k_pages, v_pages, pos_pages, block_table,
                               q_pos, scale=scale, causal=causal,
                               window=window)
