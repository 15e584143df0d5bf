"""Launch layer on PyTorch (the port of ``repro.launch``): the view-fed GNN
training and inference loops, the serve and train CLIs, the shard grid of
sharded sessions, and the multi-device layer: rank meshes, their
collectives, the sharding rules and the spawn helper that starts ranks."""
