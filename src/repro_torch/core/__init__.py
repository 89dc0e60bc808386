"""Core of the port: PCA fit and pruning, the dense index, quantisation and
metrics."""
