"""The paper's protocols on the port: Tables 1-2, Figures 1-2 and the index
size table, each runnable as ``python -m repro_torch.benchmarks.<name>``."""
