"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
tensor-core rates without sparsity, at the full 700 W power limit)."""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take for ``flops`` operations over
    ``nbytes`` bytes: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
