"""Launch wrappers of the CUDA index-embed demultiplexers
(``repro_torch/csrc/index_embed_demux.cu`` and ``decode_demux.cu``).

Both take the 2-layer shared MLP as raw tensors in PyTorch's (out, in)
layout: w1 (H, 2d), b1 (H), w2 (d, H), b2 (d), all of h's dtype."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _launch(name: str, h, p, w1, b1, w2, b2) -> torch.Tensor:
    b, rows, d = h.shape
    n = p.shape[1]
    hidden = w1.shape[0]
    want = {"p": (b, n, d), "w1": (hidden, 2 * d), "b1": (hidden,),
            "w2": (d, hidden), "b2": (d,)}
    got = {"p": p, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    for arg, shape in want.items():
        if tuple(got[arg].shape) != shape:
            raise ValueError(f"{name}: {arg} is {tuple(got[arg].shape)}, "
                             f"expected {shape}")
    _build.check_inputs(name, h.dtype, h=h, **got)
    out = torch.empty((b, n, rows, d), dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out
    err = getattr(_build.library(), name + "_launch")(
        h.data_ptr(), p.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[h.dtype], b, rows, n, d, hidden,
        _build.stream_of(h))
    _build.raise_on_error(name, err)
    _build.LAUNCHES[name] += 1
    return out


def index_embed_demux(h, p, w1, b1, w2, b2) -> torch.Tensor:
    """h (B, L, d), p (B, N, d) -> (B, N, L, d)."""
    return _launch("index_embed_demux", h, p, w1, b1, w2, b2)


def decode_demux(h, p, w1, b1, w2, b2) -> torch.Tensor:
    """h (B, C, d), p (B, N, d) -> (B, N, C, d); all N lanes of a slot in
    one block, h·W1h computed once per slot."""
    return _launch("decode_demux", h, p, w1, b1, w2, b2)
