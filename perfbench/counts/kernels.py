"""Operations and bytes of one call of each kernel, from its shapes.

Bytes count each input read once and each output written once, whatever
the kernel reads again; operations count multiplies and adds of the
algorithm the kernel implements (elementwise biases and activations are
not counted).  Each function returns (flops, bytes).
"""
from __future__ import annotations


def hadamard_mux(b: int, n: int, l: int, d: int, itemsize: int = 2):
    """x (B, N, L, d), v (N, d) -> (B, L, d): a multiply and an add per
    input element."""
    flops = 2 * b * n * l * d
    nbytes = (b * n * l * d + n * d + b * l * d) * itemsize
    return flops, nbytes


def index_embed_demux(b: int, n: int, l: int, d: int, hidden: int,
                      itemsize: int = 2):
    """h (B, L, d), p (B, N, d) and the 2-layer shared MLP (w1 (H, 2d),
    b1, w2 (d, H), b2) -> (B, N, L, d).  The first layer is computed as
    h·W1h once per (b, l) and p·W1p once per (b, n); the second once per
    (b, n, l)."""
    flops = 2 * b * l * d * hidden + 2 * b * n * d * hidden \
        + 2 * b * n * l * hidden * d
    nbytes = (b * l * d + b * n * d + hidden * 2 * d + hidden
              + d * hidden + d + b * n * l * d) * itemsize
    return flops, nbytes


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs attended: all, or, causal, query i (at position
    lk - lq + i) over the keys at or before it."""
    if not causal:
        return lq * lk
    first = lk - lq + 1        # keys seen by the first query
    return sum(max(0, min(lk, first + i)) for i in range(lq))


def flash_attention(b: int, lq: int, lk: int, h: int, hd: int,
                    causal: bool, itemsize: int = 2):
    """q (B, Lq, H, hd), k and v (B, Lk, H, hd) -> out (B, Lq, H, hd):
    Q·Kᵀ and P·V over the pairs attended."""
    flops = 4 * b * h * attention_pairs(lq, lk, causal) * hd
    nbytes = (2 * b * lq * h * hd + 2 * b * lk * h * hd) * itemsize
    return flops, nbytes


def paged_decode_attention(rows_keys: list, h: int, kvh: int, hd: int,
                           c: int, b: int, itemsize: int = 2):
    """One launch over a pool: ``rows_keys`` holds, for each live slot,
    (query rows, keys mapped before them); row r of a slot attends to the
    keys mapped before the step and rows 0..r of its chunk.  Bytes: each
    slot's mapped K and V (with their int32 positions) read once, q read
    and out written for all b x c rows."""
    pairs = sum(rows * keys + rows * (rows + 1) // 2
                for rows, keys in rows_keys)
    mapped = sum(keys + rows for rows, keys in rows_keys)
    flops = 4 * h * hd * pairs
    nbytes = mapped * (2 * kvh * hd * itemsize + 4) \
        + 2 * b * c * h * hd * itemsize
    return flops, nbytes
