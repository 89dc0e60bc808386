"""Model substrate of the port: the transformer's building blocks, the
decoder LMs (dense and MoE) and the bi-encoder (the paper's encoder
family). The GNN and recsys models are not yet ported."""
