"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version (``ref.py``), its launch wrapper (``kernel.py``) and its public op
(``ops.py``): a CPU tensor takes the plain version, a CUDA tensor the
kernel."""
