"""DataMUX in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the ``repro`` (JAX + Pallas) package, module for module: each
module here mirrors the ``repro`` module of the same name.  The JAX package
is the reference; ``repro_torch`` imports nothing of it and keeps its own
copy of whatever it needs (configs, strategy registry).

Entry points run on the GPU unless the caller passes ``device="cpu"``
(see ``repro_torch.device.resolve_device``).  On the CPU every kernel op
takes its plain PyTorch version; on a CUDA tensor it launches the kernel.
"""
