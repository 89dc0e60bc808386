"""End-to-end driver: train a bi-encoder, encode a corpus, PCA-prune,
serve; the port of ``examples/train_biencoder.py``, through
``repro_torch.launch.encode``.

By default a width- and depth-reduced encoder (4 layers, d 128) trains for
``--steps`` steps (contrastive loss, AdamW at ``warmup_cosine(3e-4, steps //
10, steps)``, a ``[train]`` line every 25 steps, a checkpoint under
``--ckpt-dir`` every 100 steps, 2 kept), then encodes 2,000 synthetic
passages and 64 queries, fits a pruner, prunes and searches; ``--full``
takes the BERT-base-scale config instead (same code path). As the
reference, a run trains from step 0 whatever ``--ckpt-dir`` holds. Weights
start from a seeded init (seed 0).

  PYTHONPATH=src python -m repro_torch.examples.train_biencoder --device cpu --steps 200
  PYTHONPATH=src python -m repro_torch.examples.train_biencoder --steps 200   # on the card
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.launch import encode
from repro_torch.models.biencoder import BiEncoder, BiEncoderConfig, init_biencoder
from repro_torch.util import default_device


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=24)
    ap.add_argument("--full", action="store_true",
                    help="BERT-base scale (~110M params)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "biencoder_ckpt"))
    ap.add_argument("--cutoff", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the card; 'cpu' to run on the CPU)")
    return ap.parse_args(argv)


def train_biencoder(args: argparse.Namespace, model: BiEncoder | None = None
                    ) -> encode.EncodeRun:
    """Train ``model`` (default: the seeded init of the example's config)
    from step 0, then encode, prune and serve as ``launch.encode`` does,
    printing the example's lines."""
    dev = default_device(args.device)
    if model is None:
        cfg = BiEncoderConfig() if args.full else encode.SMALL_CFG
        model = init_biencoder(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    ns = encode.parse_args(["--steps", str(args.steps), "--batch", str(args.batch),
                            "--seq-len", str(args.seq_len), "--cutoff", str(args.cutoff),
                            "--ckpt-dir", args.ckpt_dir, "--device", str(dev)])
    return encode.run(ns, model=model, resume=False)


def main(argv: list[str] | None = None) -> encode.EncodeRun:
    return train_biencoder(parse_args(argv))


if __name__ == "__main__":
    main()
