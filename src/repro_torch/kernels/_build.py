"""Build, load and launch-check the port's CUDA kernels.

The sources in ``repro_torch/csrc/`` have a plain C interface.  At first
use they are compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, then linked into one shared
library under ``build/kernels/`` at the root of the checkout and loaded
with ``ctypes``.  The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` runs only when a kernel is first launched on a CUDA tensor.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# Launches of each kernel since the last ``LAUNCHES.clear()``: a wrapper
# adds one exactly where it launches its kernel.
LAUNCHES: collections.Counter = collections.Counter()

# The C entry points: name -> argument types after the pointers.
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "hadamard_mux_launch": [_P, _P, _P, _I, ctypes.c_longlong, _I, _I, _I,
                            _P],
    "index_embed_demux_launch": [_P] * 7 + [_I] * 6 + [_P],
    "decode_demux_launch": [_P] * 7 + [_I] * 6 + [_P],
    "paged_decode_attention_launch": [_P] * 7 + [_I] * 9
    + [ctypes.c_float, _I, _I, _P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> tuple[list[Path], str]:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return sources, digest.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link one shared
    library; returns its path.  An existing library for the same sources is
    reused.  ``verbose`` adds ``-Xptxas -v`` and prints each kernel's
    registers and shared memory."""
    sources, digest = _sources()
    lib = BUILD_DIR / f"libdatamux_kernels_{digest}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *flags, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        failed = []
        for s, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{s.name}:\n{out}")
            elif verbose:
                print(f"[build] {s.name}\n{out}", end="")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                               str(tmp_lib)], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_inputs(name: str, dtype: torch.dtype, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    (float32 or bfloat16, or int32 for index tensors) on one device, with
    no gradient to carry (the kernels have no backward yet)."""
    if dtype not in DTYPE_CODES and dtype != torch.int32:
        raise TypeError(f"{name}: dtype {dtype} not supported; the kernel "
                        f"takes {sorted(map(str, DTYPE_CODES))}")
    devices = {t.device for t in tensors.values()}
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name}: {arg} requires grad, but the kernel "
                               f"has no backward; run under torch.no_grad()")
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
