"""Hand-written Hopper kernels (``repro_torch/csrc``) and their plain
PyTorch versions; ``ops`` is the public surface."""
