"""Architecture configs of the port (copies of ``repro/configs``): the shape
cells, the decoder LMs', the recommenders' and the bi-encoder's configs,
the registry and the step bundles. The GNN family is not yet ported."""
