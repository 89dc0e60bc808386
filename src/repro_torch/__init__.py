"""PyTorch/CUDA port of ``repro``: PCA static pruning for dense retrieval on
one NVIDIA H100, the bi-encoder that makes the embeddings, and the model
zoo's decoder LMs.

Module names follow ``repro`` so each counterpart is easy to find. The
package imports neither ``jax`` nor ``repro``. Entry points run on the card
unless the caller asks for the CPU; library objects follow the device of the
tensors they are given. On a CUDA tensor every kernel of the search path is
a hand-written CUDA kernel (``repro_torch/csrc``); on a CPU tensor the same
functions run their plain PyTorch versions.
"""
from repro_torch.util import set_fp32_policy

set_fp32_policy()
