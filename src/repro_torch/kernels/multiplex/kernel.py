"""Launch wrapper of the CUDA Hadamard multiplexer
(``repro_torch/csrc/hadamard_mux.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def hadamard_mux(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x: (B, N, L, d); v: (N, d), both CUDA, contiguous, of one dtype
    (float32 or bfloat16) -> (B, L, d), accumulated in float32."""
    b, n, l, d = x.shape
    if v.shape != (n, d):
        raise ValueError(f"hadamard_mux: v is {tuple(v.shape)}, expected "
                         f"{(n, d)}")
    _build.check_inputs("hadamard_mux", x.dtype, x=x, v=v)
    out = torch.empty((b, l, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _build.library().hadamard_mux_launch(
        x.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[x.dtype], b, n, l, d, _build.stream_of(x))
    _build.raise_on_error("hadamard_mux", err)
    _build.LAUNCHES["hadamard_mux"] += 1
    return out
