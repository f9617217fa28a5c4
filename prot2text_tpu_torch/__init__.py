"""PyTorch + CUDA port of prot2text_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module layout (`models/decoder.py` ↔
`models/decoder.py`, ...).  Plain tensor code is PyTorch; every Pallas kernel
on the ported path is a hand-written CUDA C++ kernel under `kernels/csrc/`,
built with nvcc at first use and loaded with ctypes (`kernels/_build.py`).
Each kernel wrapper runs its plain PyTorch version for CPU tensors, so the
whole package runs (slowly) on the CPU for tests against the JAX reference.

The host-side data code is the port's own copy (`data/`, numpy only);
nothing in this package imports `jax` or the JAX package.
"""
