"""Training runtime on PyTorch (the port of ``repro.train``): optimizer,
trainer, gradient compression, checkpointing, fault tolerance."""
