"""Launch plan and wrapper of the CUDA Hadamard multiplexer
(``repro_torch/csrc/hadamard_mux.cu``).

A thread owns one output vector (16 bytes where d and the pointers allow,
else one element) and one of ``slots`` instance slots; the slots' f32
partials meet in shared memory.  ``plan`` picks the split: one slot (the
streaming form) where B·L rows already give the card many blocks, more
slots and narrower blocks where they do not, so the decode shape's 8 rows
still spread over more blocks than the card has SMs."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

H100_SMS = 132
MAX_THREADS = 256
MIN_THREADS = 64
MAX_SLOTS = 32
DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class MuxPlan:
    vec: int          # elements per thread's vector: 16 bytes' worth, or 1
    cv: int           # output vectors per block
    slots: int        # instance slots per block
    threads: int      # cv * slots
    blocks: int
    smem: int         # bytes of the slots' f32 partials (0 for one slot)

    def vectors(self, block: int, total: int) -> range:
        """Flat output vectors (row-major over B·L rows x d / vec) that
        block ``block`` writes."""
        return range(block * self.cv, min((block + 1) * self.cv, total))

    def instances(self, slot: int, n: int) -> range:
        """Instances that slot ``slot`` sums."""
        return range(slot, n, self.slots)


def plan(b: int, n: int, l: int, d: int, dtype: torch.dtype,
         aligned: bool = True, sms: int = H100_SMS) -> MuxPlan:
    """The launch of x (B, N, L, d) against v (N, d): start from 256-thread
    blocks of one slot; while that gives fewer than two blocks per SM,
    double the slots (up to N and 32), then halve the block (down to 64
    threads) while there are fewer blocks than SMs."""
    name = "hadamard_mux"
    if dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported; the kernel "
                        f"takes {sorted(map(str, DTYPES))}")
    if min(b, n, l, d) < 1:
        raise ValueError(f"{name}: empty input, B={b} N={n} L={l} d={d}")
    per = 16 // torch.empty((), dtype=dtype).element_size()
    vec = per if aligned and d % per == 0 else 1
    total = b * l * (d // vec)
    threads, slots = MAX_THREADS, 1

    def blocks_of(threads, slots):
        return -(-total // (threads // slots))

    while (2 * slots <= min(n, MAX_SLOTS)
           and blocks_of(threads, slots) < 2 * sms):
        slots *= 2
    while (blocks_of(threads, slots) < sms and threads > MIN_THREADS
           and threads // slots > 1):
        threads //= 2
    cv = threads // slots
    blocks = blocks_of(threads, slots)
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"{name}: {total} output vectors exceed the grid")
    return MuxPlan(vec, cv, slots, threads, blocks,
                   threads * vec * 4 if slots > 1 else 0)


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
    aligned = (x.data_ptr() | v.data_ptr() | out.data_ptr()) % 16 == 0
    p = plan(b, n, l, d, x.dtype, aligned, sms=_build.sm_count(x.device))
    err = _build.library().hadamard_mux_launch(
        x.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[x.dtype], b, n, l, d, p.vec, p.cv, p.slots,
        p.blocks, _build.stream_of(x))
    _build.raise_on_error("hadamard_mux", err)
    _build.LAUNCHES["hadamard_mux"] += 1
    return out
