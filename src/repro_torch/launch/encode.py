"""Train -> encode -> prune -> serve entry point (port of
``examples/train_biencoder.py``): with ``--steps N`` the bi-encoder is
first trained for N steps as the example trains it, then it encodes a
corpus and its queries, a PCA pruner is fitted on the encoded corpus, and
the corpus is pruned into a ``DenseIndex`` and searched.

Training is the example's loop: in-batch-negative contrastive loss on
``pair_batch(0, t, batch=--batch, seq_len=--seq-len)``, AdamW at
``warmup_cosine(3e-4, N // 10, N)``, a ``[train]`` line every 25 steps and,
under ``--ckpt-dir``, a checkpoint every 100 steps (the last 2 kept); a
run whose ``--ckpt-dir`` holds a checkpoint resumes from its latest step.
With ``--steps 0`` (the default) the weights are the seeded random init
(``--seed``; the same seed gives the same weights on the CPU and the card).

Corpus tokens are the example's synthetic query/document pairs
(``pair_batch(7, i, batch=64, …)``); query i's relevant document is
document i. The encoder runs in micro-batches of
``--encode-batch`` rows under ``torch.inference_mode()``; the fit (``gram``
kernel), the prune (``pca_project``), the int8 build under
``--quantize-int8`` (``pca_project_quant``) and the searches
(``topk_score``) run on the card's hand-written kernels.

Prints the example's ``[train]``, ``[encode]``, ``[prune]`` and ``[serve]
MRR@10 full=… pruned=…`` lines; ``--json`` adds one JSON line with each
stage's seconds.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.encode --device cpu
  PYTHONPATH=src python -m repro_torch.launch.encode --device cpu --steps 200
  PYTHONPATH=src python -m repro_torch.launch.encode --full --seq-len 256 \\
      --n-docs 100000 --n-queries 1000 --quantize-int8 --json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import biencoder_msmarco
from repro_torch.configs.steps import make_train_step
from repro_torch.core.index import DenseIndex
from repro_torch.core.metrics import evaluate_run, mean_metrics
from repro_torch.core.pruning import StaticPruner
from repro_torch.core.quantization import scale_from_absmax
from repro_torch.data.tokens import pair_batch
from repro_torch.kernels import ops
from repro_torch.launch.train import resume_latest, train_loop
from repro_torch.models.biencoder import (BiEncoder, BiEncoderConfig, contrastive_loss, encode,
                                          init_biencoder)
from repro_torch.optim import warmup_cosine
from repro_torch.util import as_tensor, default_device

# the example's reduced config (examples/train_biencoder.py, without --full)
SMALL_CFG = BiEncoderConfig(n_layers=4, d_model=128, n_heads=4, d_ff=512,
                            vocab=2048, embed_dim=128, max_len=64,
                            compute_dtype="float32", remat=False)
PAIR_SEED = 7       # the example's corpus seed
PAIR_BATCH = 64     # ... and its batch of pairs
TRAIN_SEED = 0      # the example's training pairs: pair_batch(0, t, ...)
BASE_LR = 3e-4      # warmup_cosine(3e-4, steps // 10, steps)
LOG_EVERY = 25
CKPT_EVERY = 100
CKPT_KEEP = 2


def train_encoder(model: BiEncoder, steps: int, batch: int, seq_len: int,
                  ckpt_dir: str | None = None, resume: bool = True) -> list[float]:
    """The example's training loop, in place on ``model``: ``steps`` AdamW
    steps of contrastive loss on ``pair_batch(0, t, …)``, lr
    ``warmup_cosine(3e-4, steps // 10, steps)(t)``; under ``ckpt_dir`` a
    checkpoint every 100 steps (2 kept) and, with ``resume``, a resume from
    its latest one (without, step 0 onwards, as the example trains).
    Returns the losses of the steps run; leaves the parameters' gradients
    off."""
    if steps <= 0:
        return []
    model.requires_grad_(True)
    step_fn, opt_init = make_train_step(contrastive_loss,
                                        lr=warmup_cosine(BASE_LR, steps // 10, steps))
    opt = opt_init(model)
    mgr = CheckpointManager(ckpt_dir, keep_n=CKPT_KEEP) if ckpt_dir else None
    start = resume_latest(mgr, model, opt) if resume else 0
    losses = train_loop(model, opt, step_fn,
                        lambda t: pair_batch(TRAIN_SEED, t, batch=batch, seq_len=seq_len,
                                             vocab=model.cfg.vocab),
                        start=start, stop=steps, mgr=mgr, ckpt_every=CKPT_EVERY,
                        log_every=LOG_EVERY)
    model.requires_grad_(False)
    return losses


def pair_tokens(n_docs: int, n_queries: int, seq_len: int, vocab: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """The example's corpus: ``(d_tokens (n_docs, S), q_tokens (n_queries,
    S))`` from ``pair_batch(7, i, batch=64)`` for i = 0, 64, 128, …"""
    if n_queries > n_docs:
        raise ValueError(f"{n_queries} queries need as many paired documents; "
                         f"the corpus has {n_docs}")
    docs, queries = [], []
    for i in range(0, n_docs, PAIR_BATCH):
        b = pair_batch(PAIR_SEED, i, batch=PAIR_BATCH, seq_len=seq_len, vocab=vocab)
        docs.append(b["d_tokens"])
        queries.append(b["q_tokens"])
    return np.concatenate(docs)[:n_docs], np.concatenate(queries)[:n_queries]


def encode_rows(model: BiEncoder, tokens, batch_rows: int) -> torch.Tensor:
    """Embeddings (n, embed_dim) f32 of ``tokens`` (n, S) on the model's
    device, all-ones masks as the example's, ``batch_rows`` rows at a time
    under ``torch.inference_mode()``."""
    n = tokens.shape[0]
    out = torch.empty((n, model.cfg.embed_dim), dtype=torch.float32, device=model.device)
    with torch.inference_mode():
        for i in range(0, n, batch_rows):
            t = as_tensor(tokens[i:i + batch_rows], model.device)
            out[i:i + t.shape[0]] = encode(model, t, torch.ones_like(t))
    return out


def fused_int8_index(pruner: StaticPruner, D: torch.Tensor, pruned: torch.Tensor
                     ) -> DenseIndex:
    """The int8 index of ``D`` built through the fused kernel: the per-dim
    scale from the pruned rows' absmax, as ``DenseIndex.build`` takes it,
    then one ``pca_project_quant`` pass that projects and quantises. Its
    epilogue multiplies by the reciprocal scale where the two-pass build
    divides, so an entry on a rounding boundary may differ by one."""
    W, mean = pruner.projection()
    scale = scale_from_absmax(pruned.float().abs().amax(0))
    X = D if mean is None else D - mean
    return DenseIndex(vectors=ops.pca_project_quant(X.contiguous(), W, scale), scale=scale)


def mrr_at_10(ids: torch.Tensor) -> float:
    """MRR@10 of a run whose query i has document i as its one relevant doc."""
    ids = ids.cpu().numpy()
    run = {i: ids[i].tolist() for i in range(ids.shape[0])}
    qrels = {i: {i: 1} for i in range(ids.shape[0])}
    return mean_metrics(evaluate_run(run, qrels, metrics=("MRR@10",)))["MRR@10"]


@dataclasses.dataclass
class EncodeRun:
    """What one run built: the model, its training losses, the encoded
    corpus ``D`` and queries ``Q``, the fitted pruner, the pruned rows and
    their index, each search's (scores, ids), MRR@10 and each stage's
    seconds."""
    model: BiEncoder
    losses: list
    D: torch.Tensor
    Q: torch.Tensor
    pruner: StaticPruner
    pruned: torch.Tensor
    index: DenseIndex
    results: dict
    mrr: dict
    seconds: dict


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=0,
                    help="training steps before encoding (default 0: the seeded init)")
    ap.add_argument("--batch", type=int, default=32, help="pairs a training step")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint the training here every 100 steps, and resume from it")
    ap.add_argument("--full", action="store_true",
                    help="the BERT-base-width config (configs/biencoder_msmarco.py); "
                         "default: the example's reduced config")
    ap.add_argument("--seq-len", type=int, default=24)
    ap.add_argument("--n-docs", type=int, default=2000)
    ap.add_argument("--n-queries", type=int, default=64)
    ap.add_argument("--cutoff", type=float, default=0.5)
    ap.add_argument("--quantize-int8", action="store_true",
                    help="build the pruned index in int8, through the fused "
                         "projection and quantisation kernel")
    ap.add_argument("--encode-batch", type=int, default=1024, metavar="ROWS",
                    help="rows per encoder micro-batch")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights' init")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the card; 'cpu' to run on the CPU)")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line with each stage's seconds")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, model: BiEncoder | None = None,
        resume: bool = True) -> EncodeRun:
    """Train, encode, fit, prune, build and search as ``args`` say, printing
    the example's lines. ``model`` replaces the seeded init (its config is
    used; ``--steps`` trains it in place); ``resume=False`` trains from step
    0 whatever ``--ckpt-dir`` holds."""
    dev = default_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if model is None:
        cfg = biencoder_msmarco.CFG if args.full else SMALL_CFG
        model = init_biencoder(cfg, generator=torch.Generator().manual_seed(args.seed),
                               device=dev)
    cfg = model.cfg
    print(f"[biencoder] {cfg.param_count()/1e6:.1f}M params")
    secs = {}
    t0 = time.perf_counter()
    losses = train_encoder(model, args.steps, args.batch, args.seq_len, args.ckpt_dir,
                           resume)
    sync()
    secs["train_s"] = time.perf_counter() - t0
    d_tok, q_tok = pair_tokens(args.n_docs, args.n_queries, args.seq_len, cfg.vocab)
    print(f"[encode] corpus of {args.n_docs} docs")
    t0 = time.perf_counter()
    D = encode_rows(model, d_tok, args.encode_batch)
    Q = encode_rows(model, q_tok, args.encode_batch)
    sync()
    secs["encode_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pruner = StaticPruner(cutoff=args.cutoff).fit(D)
    sync()
    secs["fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pruned = pruner.prune_index(D)
    sync()
    secs["prune_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = (fused_int8_index(pruner, D, pruned) if args.quantize_int8
             else DenseIndex.build(pruned))
    sync()
    secs["build_s"] = time.perf_counter() - t0
    print(f"[prune] {D.shape[1]} -> {pruner.kept_dims} dims "
          f"({D.numel() * D.element_size()/2**20:.2f} -> {index.nbytes/2**20:.2f} MiB)")

    t0 = time.perf_counter()
    results = {"full": DenseIndex.build(D).search(Q, k=10),
               "pruned": index.search(pruner.transform_queries(Q), k=10)}
    sync()
    secs["search_s"] = time.perf_counter() - t0
    mrr = {name: mrr_at_10(ids) for name, (_, ids) in results.items()}
    print(f"[serve] MRR@10 full={mrr['full']:.4f} pruned={mrr['pruned']:.4f}")
    if args.json:
        print(json.dumps({"device": str(dev), "config": cfg.name,
                          "param_count": cfg.param_count(), "n_docs": args.n_docs,
                          "n_queries": args.n_queries, "seq_len": args.seq_len,
                          "train_steps": len(losses), "final_loss": losses[-1] if losses else None,
                          "kept_dims": pruner.kept_dims, "index_dtype": str(index.dtype),
                          **{f"mrr10_{k}": v for k, v in mrr.items()}, **secs}))
    return EncodeRun(model=model, losses=losses, D=D, Q=Q, pruner=pruner, pruned=pruned,
                     index=index, results=results, mrr=mrr, seconds=secs)


def main(argv: list[str] | None = None) -> EncodeRun:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
