"""Optimisation substrate of the port: AdamW (with its ZeRO-1 specs),
Adafactor and the LR schedules; the recsys family's rowwise AdaGrad and
int8 gradient compression are the modules ``optim.rowwise`` and
``optim.grad_compress``."""
from repro_torch.optim.adafactor import AdafactorConfig, adafactor_init, adafactor_update
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                                     opt_state_specs, zero1_specs)
from repro_torch.optim.schedule import constant_lr, warmup_cosine

__all__ = ["AdafactorConfig", "adafactor_init", "adafactor_update",
           "AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "opt_state_specs", "zero1_specs", "constant_lr", "warmup_cosine"]
