"""repro_torch -- Flare (whole-query compilation with native kernels for
relational workloads) on PyTorch and CUDA, for one NVIDIA Hopper GPU.

Packages: ``relational`` (tables, the TPC-H generator and queries),
``core`` (plan IR, optimizer, whole-query lowering, the stages API),
``native`` (kernel-pattern dispatch) and ``kernels`` (hand-written CUDA
kernels built with nvcc at first use, each beside its plain PyTorch
version).  The entry points run on the CUDA device unless the caller
asks for the CPU (``FlareContext(device="cpu")``).
"""
