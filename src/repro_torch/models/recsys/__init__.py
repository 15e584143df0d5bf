"""Recsys models on PyTorch (the port of ``repro.models.recsys``): MIND
multi-interest retrieval over the embedding-bag substrate."""
