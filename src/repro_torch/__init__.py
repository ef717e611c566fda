"""HALO 1.0 on PyTorch and CUDA for the NVIDIA H100.

The port of the ``repro`` package, module for module: the C2MPI host
interface, the kernel registry and runtime agent, and hand-written Hopper
kernels (``csrc/``) as the top-priority record of each alias.  It imports
``torch``, never ``jax``, and nothing of ``repro``.
"""
