"""Hand-written Hopper kernels of the port, their plain versions and wrappers.

  block_spmm — semiring frontier hop ``F @ A`` (CUDA C++, ``csrc/block_spmm.cu``)

``ops.py`` holds the wrappers (kernel on CUDA tensors, plain version on CPU
tensors), ``ref.py`` the plain versions, ``build.py`` the nvcc build.
"""
