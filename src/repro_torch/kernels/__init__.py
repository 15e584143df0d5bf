"""Hand-written Hopper kernels of the port, their plain versions and wrappers.

  block_spmm        — semiring frontier hop ``F @ A`` over the slabs of A
                      that its slab map lists (CUDA C++,
                      ``csrc/block_spmm.cu``)
  segment_multi_agg — fused PNA mean/max/min/std over bucketed messages
                      (CUDA C++, ``csrc/segment_agg.cu``); its layout step
                      ``bucketize_messages`` is plain tensor code
  flash_attention   — online-softmax attention forward with grouped KV heads
                      (CUDA C++, ``csrc/flash_attention.cu``)

``ops.py`` holds the wrappers (kernel on CUDA tensors, plain version on CPU
tensors), ``ref.py`` the plain versions, ``build.py`` the nvcc build.
"""
