"""Model substrate of the port: the transformer's building blocks, the
decoder LMs (dense and MoE), the recommenders (DLRM, DeepFM, AutoInt, the
two-tower retriever) and the bi-encoder (the paper's encoder family). The
GNN models are not yet ported."""
