"""Optimisation substrate of the port: AdamW and the LR schedules (Adafactor,
the rowwise optimiser and gradient compression wait for the model zoo)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import constant_lr, warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "constant_lr", "warmup_cosine"]
