"""GNN models on PyTorch (the port of ``repro.models.gnn``)."""
