"""Launch layer on PyTorch (the port of ``repro.launch``): the view-fed GNN
training and inference loops, and the shard grid of sharded sessions."""
