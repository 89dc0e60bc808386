"""Architecture configs of the port (copies of ``repro/configs``): the shape
cells, the decoder LMs' and the bi-encoder's configs, the registry and the
step bundles. The GNN and recsys families are not yet ported."""
