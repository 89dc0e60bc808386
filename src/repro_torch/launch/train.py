"""Training entry point for every family (decoder LMs, the GNN, recsys and
the bi-encoder), with checkpoint and restart (port of
``repro/launch/train.py``).

  * the step is the cell's bundle's (``configs.steps``): for an LM,
    ``forward_train``'s loss in ``microbatch`` sequential micro-batches
    (gradients summed in ``grad_accum_dtype``) and the arch's optimizer
    (Adafactor for arctic-480b, AdamW otherwise); for the bi-encoder
    ``contrastive_loss`` and AdamW; for the two-tower model its in-batch
    softmax and AdamW; for graphcast ``mse_loss`` and AdamW; for DLRM,
    DeepFM and AutoInt the rowwise step
    (rows gathered outside autograd, rowwise AdaGrad on the tables in
    place, AdamW on the rest); the reference bundle's constant lr of 1e-4,
    gradients by autograd (per-layer recompute when the config's ``remat``
    is set);
  * ``--resume auto`` restores the latest complete checkpoint under
    ``--ckpt-dir`` (the reference's format, with the bundle's spec tree in
    its manifest: either package's checkpoints restore in the other);
  * async checkpoints every ``--ckpt-every`` steps, the last 3 kept;
  * ``train_loop`` and ``resume_latest`` are shared with ``launch.encode
    --steps``;
  * deterministic data: batch t is ``token_batch(seed, t, …)`` (LM),
    ``pair_batch(seed, t, …)`` (bi-encoder), ``two_tower_batch`` or
    ``ctr_batch(seed, t, …)`` (recsys), ``batched_molecules(…, seed + t)``
    (GNN: zero targets, all-ones masks), prefetched on a background thread
    (depth 2), so a resumed job replays the same batches;
  * a non-finite loss raises.

``--smoke`` swaps in the arch's ``smoke_cfg`` and the reference's smoke
cell (LM: seq 32 × batch 8; bi-encoder: seq 16 × 8; recsys: batch 32;
GNN: 4 graphs of 30 nodes and 120 edges) on
a 1 × 1 host mesh of the run's device, so the whole path (init → steps →
checkpoint → resume) runs on the CPU in seconds. Without it the run is the
arch's full config on its first train cell, with specs resolved on the
production mesh (16 × 16, or 2 × 16 × 16 under ``--multi-pod``), as the
reference writes them; the steps run on the one card, so ``--batch`` sets
the one-card cut of the cell's global batch (sequences, pairs, or recsys
samples of ``train_batch``'s 65,536), or for a GNN the number of graphs
the cell's nodes and edges are split into (default 4).

GNN batches are the reference launcher's: ``batched_molecules`` at the
config's ``d_in`` and ``d_edge_in``, whatever the cell's ``d_feat`` (the
full config trains its 227-input model on 227-wide features; the bundle's
meta and specs describe the cell's ``d_feat``), as ``repro``'s does.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --device cpu --steps 20 --ckpt-every 10 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --batch 8 \\
      --steps 20 --ckpt-every 10 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --batch 65536 \\
      --steps 20 --ckpt-every 10 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch graphcast \\
      --steps 20 --ckpt-every 10 --ckpt-dir build/ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.configs.steps import BUNDLE_BUILDERS, _opt_pack
from repro_torch.convert import checkpoint_tree, restore_into
from repro_torch.data.graph import batched_molecules
from repro_torch.data.recsys import ctr_batch, two_tower_batch
from repro_torch.data.tokens import Prefetcher, pair_batch, token_batch
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.biencoder import init_biencoder
from repro_torch.models.gnn import init_gnn
from repro_torch.models.recsys import init_recsys
from repro_torch.models.transformer import init_lm
from repro_torch.util import as_tensor, default_device

_SMOKE_CELLS = {"lm": ShapeCell("smoke", "train", dict(seq_len=32, global_batch=8)),
                "biencoder": ShapeCell("smoke", "train", dict(seq_len=16, global_batch=8)),
                "recsys": ShapeCell("smoke", "train", dict(batch=32)),
                "gnn": ShapeCell("smoke", "train", dict(n_nodes=120, n_edges=480, batch=4))}
_INITS = {"lm": init_lm, "biencoder": init_biencoder, "recsys": init_recsys,
          "gnn": init_gnn}


def _smoke_spec(arch_id: str) -> ArchSpec:
    spec = registry.get_arch(arch_id)
    cfg = registry.get_smoke_cfg(arch_id)
    cell = _SMOKE_CELLS[spec.family]
    if spec.family == "gnn":
        cell = dataclasses.replace(cell, dims={**cell.dims, "d_feat": cfg.d_in})
    return dataclasses.replace(spec, cfg=cfg, shapes=(cell,))


def _gnn_batch_fn(cfg, d: dict, seed: int):
    """The reference launcher's GNN batches: ``batch`` graphs of the cell's
    nodes and edges split evenly, at the config's input widths."""
    b = d.get("batch", 4)

    def gnn_batch(t):
        out = batched_molecules(b, d["n_nodes"] // b, d["n_edges"] // b, cfg.d_in,
                                cfg.d_edge_in, seed=seed + t)
        N, E = out["nodes"].shape[0], out["edge_index"].shape[1]
        out["targets"] = np.zeros((N, cfg.d_out), np.float32)
        out["edge_mask"] = np.ones((E,), np.float32)
        out["node_mask"] = np.ones((N,), np.float32)
        out["edges"] = out["edges"][:, :cfg.d_edge_in]
        return out
    return gnn_batch


def make_batch_fn(spec: ArchSpec, cell: ShapeCell, seed: int):
    """t -> batch t as host arrays: a pure function of (seed, t)."""
    d = cell.dims
    cfg = spec.cfg
    if spec.family == "gnn":
        return _gnn_batch_fn(cfg, d, seed)
    if spec.family == "recsys":
        if cfg.kind == "two_tower":
            return lambda t: two_tower_batch(seed, t, batch=d["batch"],
                                             user_vocab=cfg.user_vocab,
                                             item_vocab=cfg.item_vocab)
        return lambda t: ctr_batch(seed, t, batch=d["batch"], vocab_sizes=cfg.vocab_sizes,
                                   n_dense=cfg.n_dense)
    make = token_batch if spec.family == "lm" else pair_batch
    return lambda t: make(seed, t, batch=d["global_batch"], seq_len=d["seq_len"],
                          vocab=spec.cfg.vocab)


def resume_latest(mgr: CheckpointManager | None, model, opt_state: dict) -> int:
    """Restore ``mgr``'s latest checkpoint into the model and the optimizer
    state, in place; return its step (0 when there is none)."""
    if mgr is None or mgr.latest_step() is None:
        return 0
    tree, step = mgr.restore(checkpoint_tree(model, opt_state))
    restore_into(model, opt_state, tree)
    print(f"[train] resumed from step {step}")
    return step


def train_loop(model, opt_state: dict, step_fn, batch_fn, *, start: int, stop: int,
               mgr: CheckpointManager | None = None, ckpt_every: int = 0,
               log_every: int = 0, spec_tree=None) -> list[float]:
    """Steps ``start`` to ``stop - 1``, in place: batch t is ``batch_fn(t)``
    (host arrays, made on a background thread, depth 2) and goes to
    ``step_fn(model, opt_state, batch, t)`` (``make_train_step``'s). A
    checkpoint under ``mgr`` (with ``spec_tree``'s specs) every
    ``ckpt_every`` steps, a ``[train]`` line every ``log_every``; a
    non-finite loss raises. Returns the losses."""
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
                mgr.save(i + 1, checkpoint_tree(model, opt_state), spec_tree=spec_tree)
    finally:
        prefetch.close()
        if mgr:
            mgr.wait()
    return losses


def train(arch: str, *, steps: int, smoke: bool, ckpt_dir: str | None,
          ckpt_every: int, resume: str, seed: int, shape: str | None = None,
          batch: int | None = None, multi_pod: bool = False, device=None,
          log_every: int = 10) -> dict:
    """Train ``steps`` steps (after any resumed ones). Returns the
    reference's dict: ``final_loss``, ``losses``, ``steps_run``, the
    ``model`` and its ``opt_state``; and the ``bundle`` (its ``mesh`` and
    spec trees)."""
    dev = default_device(device)
    spec = _smoke_spec(arch) if smoke else registry.get_arch(arch)
    cell = spec.shapes[0] if shape is None else spec.cell(shape)
    if cell.kind not in ("train", "train_sampled"):
        raise ValueError(f"shape {cell.name!r} is a {cell.kind} cell, not a train cell")
    if batch:
        key = "batch" if spec.family in ("recsys", "gnn") else "global_batch"
        cell = dataclasses.replace(cell, dims={**cell.dims, key: batch})
    mesh = make_host_mesh(device=dev) if smoke else make_production_mesh(multi_pod=multi_pod)
    bundle = BUNDLE_BUILDERS[spec.family](spec, cell, mesh)

    model = _INITS[spec.family](spec.cfg, generator=torch.Generator().manual_seed(seed),
                                device=dev)
    model.requires_grad_(True)
    opt_init, _ = _opt_pack(spec.optimizer)
    opt_state = opt_init(model)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = resume_latest(mgr, model, opt_state) if resume == "auto" else 0
    losses = train_loop(model, opt_state, bundle.fn, make_batch_fn(spec, cell, seed),
                        start=start, stop=start + steps, mgr=mgr, ckpt_every=ckpt_every,
                        log_every=log_every, spec_tree=bundle.in_specs[:2])
    return {"final_loss": losses[-1] if losses else None,
            "losses": losses, "steps_run": len(losses),
            "model": model, "opt_state": opt_state, "bundle": bundle}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences (LM), pairs (bi-encoder) or samples (recsys) a step: "
                         "the one-card cut of the cell's global batch (default: all of it); "
                         "for a GNN, the graphs the cell is split into (default 4)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="resolve the specs on the two-pod production mesh")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, smoke=args.smoke, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume, seed=args.seed,
                shape=args.shape, batch=args.batch, multi_pod=args.multi_pod,
                device=args.device)
    final = "none" if out["final_loss"] is None else f"{out['final_loss']:.4f}"
    print(f"[train] done: {out['steps_run']} steps, final loss {final}")
    return out


if __name__ == "__main__":
    main()
