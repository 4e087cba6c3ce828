"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each module holds one kernel's wrapper (CUDA tensors), its plain version
(CPU tensors, and the solver's 'torch' path) and its launch counter. The
kernel sources are in ``scso_tpu_torch/csrc/``; ``build`` compiles them
on first use, so importing these modules builds nothing."""
