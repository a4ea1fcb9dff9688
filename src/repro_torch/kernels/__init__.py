"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version (``ref.py``), its launch wrapper (``kernel.py``) and its public op
(``ops.py``): a CUDA tensor takes the kernel, a CPU or meta tensor (the
dry-run's shapes) the plain version, and any other device raises."""


def takes_kernel(t) -> bool:
    """Whether the op on ``t`` launches its kernel: True on CUDA, False on
    the CPU and on ``meta``; another device raises."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind in ("cpu", "meta"):
        return False
    raise ValueError(f"the kernel ops run on cuda, cpu or meta tensors, "
                     f"not on {kind}")
