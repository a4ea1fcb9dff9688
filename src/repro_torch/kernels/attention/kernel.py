"""Launch plan and wrapper of the CUDA flash attention
(``repro_torch/csrc/flash_attention.cu``).

Both bodies pad the head axis with zeros to ``hdp``, hd rounded up to a
multiple of 64, so every hd from 1 to 256 runs.  bf16 with hd a multiple
of 8 on 16-byte-aligned tensors (what TMA can read) takes the Hopper body:
384-thread blocks (a TMA producer warpgroup and two ``wgmma`` consumer
warpgroups) over 128-row query tiles laid from the end of the sequence,
K/V tiles in a 3-stage mbarrier ring: 96 keys at hdp 64 and 128, 48 at
hdp 192 and 256.  Everything else takes the CUDA-core body: 256 threads
over 64-row query tiles laid from the start, 64-key tiles.  ``plan``
holds the tiling; the C entry point refuses a plan its body was not built
for."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256       # the widest zero-padded head the bodies hold
MAX_GRID_YZ = 65535      # grid.y = batch rows, grid.z = query tiles
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
BODIES = {"cuda_cores": 0, "wgmma": 1}


def padded_head_dim(hd: int) -> int:
    """The head width both bodies compute on: hd rounded up to 64."""
    return -(-hd // 64) * 64


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    body: str           # "wgmma" (bf16, TMA) or "cuda_cores"
    q_tile: int         # query rows per block
    k_tile: int         # keys per staged tile
    stages: int         # K/V tiles staged in shared memory at once
    threads: int
    smem_bytes: int     # dynamic shared memory per block
    grid: tuple         # (H, B, query tiles); blockIdx.z counts down
    hdp: int            # the zero-padded head width computed on

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


def plan(b: int, lq: int, lk: int, h: int, hd: int, dtype: torch.dtype,
         aligned: bool = True) -> FlashPlan:
    """The launch of q (B, Lq, H, hd) against k/v (B, Lk, H, hd); raises on
    what the kernel does not take (another dtype, hd outside 1..256, an
    empty input, a grid or TMA map too large)."""
    name = "flash_attention"
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported; the kernel "
                        f"takes torch.float32 and torch.bfloat16")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {hd} outside 1.."
                         f"{MAX_HEAD_DIM}")
    if min(b, lq, lk, h) < 1:
        raise ValueError(f"{name}: empty input, B={b} Lq={lq} Lk={lk} H={h}")
    hdp = padded_head_dim(hd)
    if dtype == torch.bfloat16 and hd % 8 == 0 and aligned:
        # TMA reads (B, L, H, hd) through a 4-D map: strides of hd * 2,
        # H * hd * 2 and L * H * hd * 2 bytes, multiples of 16 below 2^40,
        # in 64-column (128-byte) boxes.
        if b * max(lq, lk) * h * hd * 2 >= 2 ** 40:
            raise ValueError(f"{name}: tensor too large for a TMA map")
        # 48-key tiles past 128 columns keep O, S and P within a thread's
        # registers (the source's notes)
        q_tile, k_tile, stages = 128, 96 if hdp <= 128 else 48, 3
        smem = 1024 + q_tile * hdp * 2 + 2 * stages * k_tile * hdp * 2 \
            + (1 + 4 * stages) * 8
        p = FlashPlan("wgmma", q_tile, k_tile, stages, 384, smem,
                      (h, b, -(-lq // q_tile)), hdp)
    else:
        smem = (64 * (hdp + 4) * 3 + 64 * 68) * 4  # Q, K, V and P in f32
        p = FlashPlan("cuda_cores", 64, 64, 1, 256, smem,
                      (h, b, -(-lq // 64)), hdp)
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
    # out is a fresh allocation, so 16-byte aligned like every tensor the
    # caching allocator hands out.
    aligned = (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0
    p = plan(b, lq, lk, h, hd, q.dtype, aligned)
    _build.check_inputs(name, q.dtype, q=q, k=k, v=v)
    out = torch.empty_like(q)
    scale = hd ** -0.5 if scale is None else float(scale)
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, lq, lk, h, hd, scale, int(causal),
        BODIES[p.body], p.q_tile, p.k_tile, p.stages, p.threads,
        p.smem_bytes, _build.stream_of(q))
    _build.raise_on_error(name, err)
    _build.LAUNCHES[name] += 1
    return out
