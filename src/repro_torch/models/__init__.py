"""Model substrate of the port: the transformer's building blocks and the
bi-encoder (the paper's encoder family). The LM forward, MoE, GNN and
recsys models wait for the model zoo."""
