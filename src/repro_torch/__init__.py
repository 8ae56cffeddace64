"""PyTorch and CUDA port of the three-component-key proximity search.

Mirrors the layout of the reference package ``src/repro`` (JAX): the same
host code, the fused serving program on torch tensors, and hand-written CUDA
kernels for Hopper (``kernels/csrc``) in place of the reference's Pallas TPU
kernels.  Every serving entry point takes ``device`` and runs on ``"cuda"``
unless the caller passes ``device="cpu"``, where each kernel wrapper takes
its plain PyTorch version.  Nothing here imports the reference package or
JAX.
"""
