"""Public op: fused Hadamard multiplexer.

Reached through ``HadamardMux.kernel_apply``
(``repro_torch.core.strategies.linear``) when ``cfg.use_kernel`` is set.
A CPU or meta tensor takes the plain version; a CUDA tensor launches the
kernel (``kernels.takes_kernel``), which raises on what it does not take.
"""
from __future__ import annotations

from repro_torch.kernels import takes_kernel
from repro_torch.kernels.multiplex import kernel, ref


def hadamard_mux(x, v):
    """x: (B, N, L, d); v: (N, d) -> (B, L, d)."""
    if not takes_kernel(x):
        return ref.hadamard_mux(x, v)
    return kernel.hadamard_mux(x, v)
