"""Launch wrapper of the CUDA flash attention
(``repro_torch/csrc/flash_attention.cu``): one block per (head, batch row,
64-row query tile) walks the key axis in 64-key tiles with an online
float32 softmax."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)    # the kernel's instantiations
QUERY_TILE = 64
MAX_GRID_YZ = 65535      # grid.y = batch rows, grid.z = query tiles


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Lq, H, hd); k, v: (B, Lk, H, hd) of q's dtype, contiguous,
    on one CUDA device.  Returns (B, Lq, H, hd)."""
    name = "flash_attention"
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    for arg, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, lk, h, hd):
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)}, expected "
                             f"{(b, lk, h, hd)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not supported; the kernel "
                         f"takes {HEAD_DIMS}")
    if min(b, lq, lk, h) < 1:
        raise ValueError(f"{name}: empty input, q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if b > MAX_GRID_YZ or -(-lq // QUERY_TILE) > MAX_GRID_YZ:
        raise ValueError(f"{name}: B={b} or Lq={lq} exceeds the launch grid")
    _build.check_inputs(name, q.dtype, q=q, k=k, v=v)
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")
    scale = hd ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, lq, lk, h, hd, scale, int(causal),
        _build.stream_of(q))
    _build.raise_on_error(name, err)
    _build.LAUNCHES[name] += 1
    return out
