"""Public op: flash attention over a full sequence.

A CPU or meta tensor takes the plain version; a CUDA tensor launches the
kernel (``kernels.takes_kernel``), which raises on what it does not take
(another head dim or dtype).  There is no fallback from the kernel to the
plain version."""
from __future__ import annotations

from repro_torch.kernels import takes_kernel
from repro_torch.kernels.attention import kernel, ref


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """q: (B, Lq, H, hd); k, v: (B, Lk, H, hd) -> (B, Lq, H, hd)."""
    if not takes_kernel(q):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    return kernel.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal, scale=scale)
