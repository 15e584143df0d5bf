"""The plain reference: a graph kept as NumPy arrays and a path evaluator in
plain PyTorch.  It imports nothing of the port and takes nothing the port
made: it replays the benchmark's own writes on its own arrays."""
