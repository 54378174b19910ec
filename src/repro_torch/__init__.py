"""PyTorch/CUDA port of the ``repro`` recipe.

The JAX package ``repro`` is the reference this package is held against;
``repro_torch`` imports neither it nor JAX.  Its hot kernels are CUDA C++
for Hopper (``csrc/``), built at first use; every kernel keeps a plain
PyTorch version beside it, which CPU tensors take.
"""
