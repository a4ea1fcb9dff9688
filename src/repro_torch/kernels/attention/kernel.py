"""Launch plan and wrapper of the CUDA flash attention
(``repro_torch/csrc/flash_attention.cu``).

bf16 takes the Hopper body: 384-thread blocks (a TMA producer warpgroup
and two ``wgmma`` consumer warpgroups) over 128-row query tiles laid from
the end of the sequence, 96-key K/V tiles in a 3-stage mbarrier ring.
float32 takes the CUDA-core body: 256 threads over 64-row query tiles
laid from the start, 64-key tiles.  ``plan`` holds the tiling; the C
entry point refuses a plan its body was not built for."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)    # the kernel's instantiations
MAX_GRID_YZ = 65535      # grid.y = batch rows, grid.z = query tiles
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
BODIES = {"cuda_cores": 0, "wgmma": 1}


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    body: str           # "wgmma" (bf16) or "cuda_cores" (float32)
    q_tile: int         # query rows per block
    k_tile: int         # keys per staged tile
    stages: int         # K/V tiles staged in shared memory at once
    threads: int
    smem_bytes: int     # dynamic shared memory per block
    grid: tuple         # (H, B, query tiles); blockIdx.z counts down

    def query_rows(self, z: int, lq: int) -> range:
        """Rows of q that the blocks with blockIdx.z == z write (the
        heaviest, last, tile first): the wgmma body lays its tiles from
        Lq down, so its ragged tile is the first rows; the CUDA-core body
        from 0 up, so its ragged tile is the last."""
        if self.body == "wgmma":
            q0 = lq - (z + 1) * self.q_tile
            return range(max(q0, 0), q0 + self.q_tile)
        q0 = (self.grid[2] - 1 - z) * self.q_tile
        return range(q0, min(q0 + self.q_tile, lq))


def plan(b: int, lq: int, lk: int, h: int, hd: int,
         dtype: torch.dtype) -> FlashPlan:
    """The launch of q (B, Lq, H, hd) against k/v (B, Lk, H, hd); raises on
    what the kernel does not take."""
    name = "flash_attention"
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported; the kernel "
                        f"takes torch.float32 and torch.bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not supported; the kernel "
                         f"takes {HEAD_DIMS}")
    if min(b, lq, lk, h) < 1:
        raise ValueError(f"{name}: empty input, B={b} Lq={lq} Lk={lk} H={h}")
    if dtype == torch.bfloat16:
        # TMA reads (B, L, H, hd) through a 4-D map: strides of hd * 2,
        # H * hd * 2 and L * H * hd * 2 bytes, multiples of 16 below 2^40,
        # in 64-column (128-byte) boxes.
        if b * max(lq, lk) * h * hd * 2 >= 2 ** 40:
            raise ValueError(f"{name}: tensor too large for a TMA map")
        q_tile, k_tile, stages = 128, 96, 3
        smem = 1024 + q_tile * hd * 2 + 2 * stages * k_tile * hd * 2 \
            + (1 + 4 * stages) * 8
        p = FlashPlan("wgmma", q_tile, k_tile, stages, 384, smem,
                      (h, b, -(-lq // q_tile)))
    else:
        smem = (64 * (hd + 4) * 3 + 64 * 68) * 4   # Q, K, V and P in f32
        p = FlashPlan("cuda_cores", 64, 64, 1, 256, smem,
                      (h, b, -(-lq // 64)))
    if p.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: plan needs {p.smem_bytes} bytes of "
                         f"shared memory, above {SMEM_LIMIT}")
    if b > MAX_GRID_YZ or p.grid[2] > MAX_GRID_YZ:
        raise ValueError(f"{name}: B={b} or Lq={lq} exceeds the launch grid")
    return p


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
    p = plan(b, lq, lk, h, hd, q.dtype)
    _build.check_inputs(name, q.dtype, q=q, k=k, v=v)
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")
    scale = hd ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, lq, lk, h, hd, scale, int(causal),
        BODIES[p.body], p.q_tile, p.k_tile, p.stages, p.threads,
        p.smem_bytes, _build.stream_of(q))
    _build.raise_on_error(name, err)
    _build.LAUNCHES[name] += 1
    return out
