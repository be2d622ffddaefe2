"""PyTorch/CUDA port of the test-time-scaling serving stack.

Mirrors the JAX package's subpackages (``configs``, ``data``, ``quant``,
``kernels``, ``models``, ``serving``, ``core``, ``launch``) and imports
nothing of it.  Hot kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc``); each has a plain PyTorch version that runs for CPU
tensors.
"""
