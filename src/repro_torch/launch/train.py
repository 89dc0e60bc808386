"""Training entry point for the bi-encoder family, with checkpoint and restart
(port of ``repro/launch/train.py``; the other families wait for the model
zoo and the registry).

  * the step is ``configs.steps.make_train_step(contrastive_loss)``: AdamW
    at the reference bundle's constant lr of 1e-4, gradients by autograd
    through the encoder (per-layer recompute when the config's ``remat``
    is set);
  * ``--resume auto`` restores the latest complete checkpoint under
    ``--ckpt-dir`` (the reference's format: either package's checkpoints
    restore in the other);
  * async checkpoints every ``--ckpt-every`` steps, the last 3 kept;
  * ``train_loop`` and ``resume_latest`` are shared with ``launch.encode
    --steps``;
  * deterministic data: batch t is ``pair_batch(seed, t, …)``, prefetched
    on a background thread (depth 2), so a resumed job replays the same
    batches;
  * a non-finite loss raises.

``--smoke`` swaps in the config's ``smoke_cfg`` and the reference's smoke
cell (seq 16 × batch 8), so the whole path (init → steps → checkpoint →
resume) runs on the CPU in seconds. Without it the run is
``configs/biencoder_msmarco.CFG`` at BERT-base width on the ``train_pairs``
cell (seq 128 × 4,096 pairs, which one H100 80GB holds with per-layer
recompute); ``--batch`` sets another number of pairs a step, for a
shorter run.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch biencoder-msmarco \\
      --smoke --device cpu --steps 20 --ckpt-every 10 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch biencoder-msmarco \\
      --steps 20 --ckpt-every 10 --ckpt-dir build/ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import biencoder_msmarco
from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.configs.steps import make_train_step
from repro_torch.convert import checkpoint_tree, restore_into
from repro_torch.data.tokens import Prefetcher, pair_batch
from repro_torch.models.biencoder import BiEncoder, contrastive_loss, init_biencoder
from repro_torch.util import as_tensor, default_device


def _spec(arch: str, smoke: bool) -> ArchSpec:
    spec = biencoder_msmarco.spec()
    if arch != spec.arch_id:
        raise ValueError(f"--arch {arch!r}: the port trains only {spec.arch_id!r}; the "
                         f"registry and the LM, MoE, GNN and recsys families are not "
                         f"ported yet")
    if not smoke:
        return spec
    cell = ShapeCell("smoke", "train", dict(seq_len=16, global_batch=8))
    return dataclasses.replace(spec, cfg=biencoder_msmarco.smoke_cfg(), shapes=(cell,))


def resume_latest(mgr: CheckpointManager | None, model: BiEncoder, opt_state: dict) -> int:
    """Restore ``mgr``'s latest checkpoint into the model and the optimizer
    state, in place; return its step (0 when there is none)."""
    if mgr is None or mgr.latest_step() is None:
        return 0
    tree, step = mgr.restore(checkpoint_tree(model, opt_state))
    restore_into(model, opt_state, tree)
    print(f"[train] resumed from step {step}")
    return step


def train_loop(model: BiEncoder, opt_state: dict, step_fn, batch_fn, *, start: int, stop: int,
               mgr: CheckpointManager | None = None, ckpt_every: int = 0,
               log_every: int = 0) -> list[float]:
    """Steps ``start`` to ``stop - 1``, in place: batch t is ``batch_fn(t)``
    (host arrays, made on a background thread, depth 2) and goes to
    ``step_fn(model, opt_state, batch, t)`` (``make_train_step``'s). A
    checkpoint under ``mgr`` every ``ckpt_every`` steps, a ``[train]`` line
    every ``log_every``; a non-finite loss raises. Returns the losses."""
    dev = model.device
    prefetch = Prefetcher(batch_fn, start_step=start, depth=2)
    losses = []
    t0 = time.time()
    try:
        for i in range(start, stop):
            _, host_batch = next(prefetch)
            metrics = step_fn(model, opt_state,
                              {k: as_tensor(v, dev) for k, v in host_batch.items()}, i)
            loss = float(metrics["loss"])
            losses.append(loss)
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {i}")
            if log_every and (i + 1) % log_every == 0:
                dt = (time.time() - t0) / len(losses)
                print(f"[train] step {i+1:4d} loss {loss:.4f} ({dt*1e3:.0f} ms/step)")
            if mgr and ckpt_every and (i + 1) % ckpt_every == 0:
                mgr.save(i + 1, checkpoint_tree(model, opt_state))
    finally:
        prefetch.close()
        if mgr:
            mgr.wait()
    return losses


def train(arch: str, *, steps: int, smoke: bool, ckpt_dir: str | None,
          ckpt_every: int, resume: str, seed: int, shape: str | None = None,
          batch: int | None = None, device=None, log_every: int = 10) -> dict:
    """Train ``steps`` steps (after any resumed ones). Returns the
    reference's dict: ``final_loss``, ``losses``, ``steps_run``, and the
    ``model`` and its ``opt_state``."""
    dev = default_device(device)
    spec = _spec(arch, smoke)
    cell = spec.shapes[0] if shape is None else spec.cell(shape)
    if cell.kind != "train":
        raise ValueError(f"shape {cell.name!r} is a {cell.kind} cell, not a train cell")
    seq_len = cell.dims["seq_len"]
    global_batch = batch or cell.dims["global_batch"]

    model = init_biencoder(spec.cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    model.requires_grad_(True)
    step_fn, opt_init = make_train_step(contrastive_loss, spec.optimizer)
    opt_state = opt_init(model)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = resume_latest(mgr, model, opt_state) if resume == "auto" else 0
    losses = train_loop(model, opt_state, step_fn,
                        lambda t: pair_batch(seed, t, batch=global_batch, seq_len=seq_len,
                                             vocab=spec.cfg.vocab),
                        start=start, stop=start + steps, mgr=mgr, ckpt_every=ckpt_every,
                        log_every=log_every)
    return {"final_loss": losses[-1] if losses else None,
            "losses": losses, "steps_run": len(losses),
            "model": model, "opt_state": opt_state}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="pairs a step (default: the cell's global batch)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, smoke=args.smoke, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume, seed=args.seed,
                shape=args.shape, batch=args.batch, device=args.device)
    final = "none" if out["final_loss"] is None else f"{out['final_loss']:.4f}"
    print(f"[train] done: {out['steps_run']} steps, final loss {final}")
    return out


if __name__ == "__main__":
    main()
