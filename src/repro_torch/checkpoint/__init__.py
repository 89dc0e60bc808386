"""Checkpoints and the durable-commit helpers of the port's on-disk artifacts
(port of ``repro/checkpoint/manager.py``: its commit protocol in ``fsio``,
the checkpoint manager in ``manager``)."""
from repro_torch.checkpoint.manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]
