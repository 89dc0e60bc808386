"""The training step (port of the part of ``repro/configs/steps.py`` the
bi-encoder needs: ``_make_train_step`` without micro-batching; the
bi-encoder's loss is ``models.biencoder.contrastive_loss``).

``biencoder_bundle`` never micro-batches (it calls ``_train_bundle``
without ``microbatch``), and in-batch negatives make the loss a function of
the whole batch, so accumulating over micro-batches would compute another
function. The step bundles, shardings and the other families' steps wait
for ``par/sharding.py`` and the model zoo.
"""
from __future__ import annotations

from collections.abc import Callable, Mapping

import torch
import torch.nn as nn

from repro_torch.convert import decay_mask
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import constant_lr


def value_and_grad(loss_fn: Callable, model: nn.Module, batch: Mapping
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``(loss, grads)``: ``loss_fn(model, batch)`` (gradients enabled) and
    its gradient with respect to each of the model's parameters, by name.
    The parameters' ``.grad`` is left alone."""
    params = dict(model.named_parameters())
    with torch.enable_grad():
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def make_train_step(loss_fn: Callable, optimizer: str = "adamw", lr=1e-4):
    """``(step, opt_init)``: ``step(model, opt_state, batch, t=0)`` computes
    the loss and its gradients and applies one optimizer update, in place,
    at ``lr``: a constant (the reference's, 1e-4) or a schedule ``t -> lr``
    (``optim.schedule``) read at step index ``t``; it returns ``{"loss":
    loss}``. ``opt_init(model)`` is the optimizer state, with the
    reference's decay mask. The model's parameters must require
    gradients."""
    if optimizer != "adamw":
        raise ValueError(f"optimizer {optimizer!r}: the port has 'adamw'; adafactor and "
                         f"the rowwise optimizer wait for the model zoo")
    lr_fn = lr if callable(lr) else constant_lr(lr)

    def step(model: nn.Module, opt_state: dict, batch: Mapping, t: int = 0) -> dict:
        loss, grads = value_and_grad(loss_fn, model, batch)
        adamw_update(grads, opt_state, dict(model.named_parameters()), lr_fn(t))
        return {"loss": loss}

    def opt_init(model: nn.Module) -> dict:
        named = dict(model.named_parameters())
        return adamw_init(named, decay_mask(named))

    return step, opt_init
