"""MV4PG on PyTorch: materialized views for property graphs on one GPU.

The PyTorch/CUDA port of the ``repro`` package.  It mirrors that package's
layout (``repro_torch.core.views`` is the counterpart of
``repro.core.views``) and never imports JAX or ``repro``.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``.
"""
