"""Models on PyTorch (the port of ``repro.models``): plain functions over
parameter dictionaries, in the reference's layouts."""
