#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card
    python3 chip_smoke.py --n-docs 300000 --protocol-docs 20000 --encode-docs 10000
                                   # a shorter rehearsal

Phases, each printing one JSON line:
  1. device: the card's name, count, and nvidia-smi's name and power limit;
  2. build: every kernel of ``src/repro_torch/csrc`` with nvcc for sm_90a,
     with ptxas's registers, shared memory and spills;
  3. kernels vs their plain versions on edge cases (ragged n, k > n,
     n_valid mid-chunk, ties across chunks, row_ids out of order and
     masked, m not a multiple of 16, n and B at the tile edges,
     f32/bf16/int8, k in {1, 10, 32, 33, 100, 1000, 2048, n + 7};
     gram exactly symmetric; the paged kernel over scrambled pool/tail
     tables with ragged pages, lo > 0, carry splits and ids_pool, pages
     of 100 rows, a walk of more chunks than CTAs, k up to 2048); B =
     65,537 queries, past one launch's 65,535 query rows, dense, paged,
     the select alone and DenseIndex.search, the last row bitwise equal
     to a one-query call;
  4. the main path at full width: an MS MARCO-sized corpus (8,841,823 x 768,
     27.2 GB f32) drawn on the card, PCA fit (gram kernel), pruning at
     cutoff 0.5 to m = 384 (pca_project kernel), int8 by the two-pass
     absmax build and by the fused epilogue (pca_project_quant kernel),
     batches of 32 queries through search_projected on the f32 and int8
     indexes (topk_score kernel) and an exact f32 rescore of the int8
     shortlist (topk_score, row_ids mode); each kernel is compared with its
     plain version and timed at the shapes this path gives it, gram also at
     the protocol's 100,000 x 768 (there held bitwise equal to the in-order
     sum of one-range launches over its row ranges), pca_project
     also on 32 query rows, topk_score also at k = 100, 1000, 2000 and
     10,000, and the large-k select alone on one batch's keys at k = 100;
  5. the Table-1 protocol on make_dataset("tasb", n_docs=100_000, d=768) at
     cutoffs {0.25, 0.5, 0.75}, and Table 2's (W_m fit on an out-of-domain
     corpus of the same encoder, drawn on the card), each checked against
     the CPU path (plain versions, the card's PCA state carried across) at
     0.5;
  6. a pipeline_depth=3 RetrievalServer over the full-size int8 and f32
     indexes: closed and open loop (beside each open-loop result its tape's
     own rate, ``tape_qps``), replies checked against direct
     search_projected calls;
  7. the paged path: both full-size indexes paged (256-row pages, 34,539
     each) by a device-side copy; (a) 8 batches through
     PagedIndex.search_projected held bitwise equal to
     DenseIndex.search_projected (also at k = 100, 1000 and 2000) and the
     paged kernel against its plain version, timed at k = 10, 2000 and
     10,000; (b) a lifecycle (three appends, one x9 to widen an
     int8 scale, promote, compact, evict 2,048 pages to pinned host
     memory, searched in 64-page waves), each step against the plain
     version, the f32 appended index also against the dense base merged
     with a dense index over the appended rows, and promote/compact/evict
     held bitwise unchanged; (c) a pipeline_depth=3 server over the paged int8
     index, closed loop, then open loop while swap_index installs the
     append, the compaction and the eviction under a background client;
  8. the live path: (a) both full-size indexes wrapped as SegmentedIndex
     (4,096-row deltas) and grown by 10,000 documents in 64-row
     IndexUpdater.add_documents blocks (one x9, so an int8 delta widens),
     8 batches at k = 10 and 1000 held bitwise (f32) to the merge of two
     dense searches and (int8, mixed scales) to an f32 oracle over the
     dequantised segments, each delta's top-k against its plain version,
     a batch timed at 0, 1 and 3 deltas; (b) PagedIndex.from_segmented of
     both, bitwise equal to the segmented search; (c) an IndexUpdater behind
     a depth-3 server taking 2,000 rows/s of appends during a closed and an
     open loop, then compact_async under that traffic: no reply lost,
     health ok, replies after the last swap equal to the final index, the
     compacted base bitwise its rebuild; (d) a paged IndexUpdater: appends
     with a widen, then compact by pointer swaps, against the plain version;
  9. the store, under build/store_smoke/ (each artifact removed when its
     checks are done; one line per step with the bytes it wrote and the
     free disk): (a) StaticPruner.build_index_to over the regenerated full
     corpus in 262,144-row blocks on the card, int8, bitwise equal to phase
     4's int8 index; (b) the fit inside the build (gram) at the protocol
     size against the same build on the CPU (plain versions): eigenvalues,
     the kept subspace and the well-conditioned components up to sign, int8
     bytes ±1 on at most 0.1 % for the same rotation; (c) the
     cold start from (a)'s artifact (open + validate, DenseIndex.load, the
     first answered query through RetrievalServer), page cache dropped and
     warm, beside a pinned 1 GB host-to-device copy, searches bitwise equal
     at k = 10 and 1000; (e) IndexUpdater.from_store on it, 10,000 rows of
     durable 64-row add_documents (one widens) in turns with a store-less
     updater, SegmentedIndex.load of the store bitwise equal, and the
     store-backed compact bitwise the store-less one; (d) the f32 index
     saved and loaded, bitwise (cut to the rows the free disk holds, and
     said so); (f) phase 7's int8 index with 2,048 host-tier pages, a few
     appended blocks, PagedIndex.save and load, bitwise equal in search and
     extent_rows;
 10. the cascade over phase 4's f32 pruned rows, CascadeIndex.build at
     64:8 (coarse int8) with the full side f32 and int8, and from_index on
     the int8 index (its coarse scale and bytes held to numpy): (a) the
     coarse int8 scan (m 64, k 80; m 128, k 160), the row_ids rescore of a
     real shortlist and the paged coarse scan against their plain
     versions; (b) the anchor on a 100,000-row prefix with N = ceil(n/k),
     bitwise the full search, dense, segmented (10,000 appended rows) and
     paged, f32 and int8; (c) recall@10 against the full f32 search and
     the batch time split (projection, coarse scan, the select alone,
     shortlist, gather, rescore) at 64:8, 128:16 and 128:32, beside the
     single-resolution batch; (d) a segmented int8 cascade grown by 10,000
     rows in 64-row blocks while a depth-3 server takes 1,000 qps open
     loop: no reply lost, then paged and bitwise the segmented one; (e)
     its store round trip under build/cascade_smoke/, coarse deltas
     bitwise, segmented and paged loads;
 11. the fleet under build/fleet_smoke/: three replicas over the int8
     artifact at 1,000 qps for 10 s while r1 is killed at 3 s and
     restarted at 6 s (no accepted reply lost, every OK reply's ids the
     single server's, health ok after), a timed restart, a good rollout
     (recall 1.0 on each replica), a row-permuted artifact rolled back
     after the first replica with no misrouted reply under traffic, and a
     torn artifact refused while the fleet serves;
 12. the sharded index over phase 4's indexes, the slots of a (4,) and a
     (2, 2) mesh all on the card, each shard a row view: (a) 8 batches at
     k 10 and 100, flat and hierarchical merges, f32 and int8, bitwise
     equal to the dense search with one top-k launch per shard; (b) each
     batch timed beside the dense one, the merges alone, one shard's
     top-k against its plain version; (c) gram_distributed and
     fit_pca_distributed at 100,000 x 768 and at full size (phase 4's
     corpus drawn again) against an fp64 Gram and fit_pca; (d) the int8 index saved under build/sharded_smoke/ and
     loaded sharded, bitwise; (e) a SegmentedIndex over the sharded int8
     base grown by 10,000 rows (one x9 block), bitwise the same appends
     over the dense base, compacted onto the same mesh, bitwise the dense
     compaction; (f) a depth-3 server over the sharded int8 index on each
     mesh, closed loop, p50 beside the dense server's, replies bitwise the
     dense search;
 13. the encoder: configs/biencoder_msmarco.CFG at full width (BERT-base,
     137,491,968 parameters by the config's count), weights from a seeded
     generator on the card: (a) 8 x 256 encoded on the card and on the CPU,
     f32 compute within ENCODE_F32_TOL, bf16 at cosine >= ENCODE_BF16_COS
     per row, the bf16 GELU within one ULP of the CPU's; (b) one
     encode_corpus batch (8,192 x 256) in --encode-batch micro-batches and
     query batches of 32 x 32 and 32 x 256, against the bound, with the
     peak memory; (c) launch.encode's encode -> fit -> prune -> search over
     --encode-docs passages (default 100,000) and 1,000 queries at seq
     256 under --quantize-int8 (the int8 index built by pca_project_quant,
     held to the two-pass build), an f32 pruned index beside it, ids
     against the plain top-k, MRR@10 (random weights: a check that the
     pieces connect, not a quality claim); (d) one encoder layer at the
     micro-batch, op by op against each op's bound, the ops' composition
     bitwise the layer's, SDPA's time beside the attention (a yardstick
     the port never calls);
 14. the training half at the same width (bf16 compute, remat on, seq 128
     as train_pairs): (a) one step's loss and gradients on 8 pairs x 32
     tokens on the card and on the CPU, f32 and bf16 compute; (b) the step
     at the largest power-of-two batch of train_pairs' 4,096 that fits,
     chosen from the peaks at 128 and 256 pairs: forward, backward with its
     recompute, optimizer, tokens/s, peak memory, against the bound; (c)
     launch.train for 20 steps at 256 pairs, checkpoints every 10 under
     build/train_smoke/, finite and descending; (d) the checkpoint's bytes,
     its blocking host copy and background write beside a step, a bitwise
     restore, and a resume at step 10 that gives the step-11 loss; (e)
     launch.encode --full --steps 20 --batch 256 --seq-len 128
     --quantize-int8 over 100,000 passages: trained, then encoded, fitted,
     pruned and searched through the kernels, ids against the plain top-k;
 15. the decoder-LM family: (a) the smoke configs of qwen2, mixtral and
     arctic on the card against the CPU (f32 loss, gradients, prefill and
     decode logits, MoE aux loss, the arch's optimizer step; bf16 loss and
     gradient cosine); (b) qwen2-1.5b at full width in bf16: prefill of
     32,768 tokens and decode_step against a 32,768-slot static cache at
     the largest batch that fits, against their bounds, and decode at p
     equal to the full forward at p on a 64-token prompt; (c) one
     qwen2-1.5b train step at seq 4,096 in 4 micro-batches at the largest
     global batch that fits; (d) mixtral-8x7b cut to 4 layers: the window's
     prefill, then decode_step_sliding past position 524,000 (wrapped),
     with the MoE layers' share; (e) launch.train --arch smollm-135m (full
     config) for 20 steps with checkpoints under build/lm_smoke/: specs in
     the manifest equal param_specs, a bitwise resume, and an elastic
     restore onto a (2, 2) mesh of the card's slots;
 16. the recsys family: (a) the smoke configs of the two-tower, DLRM,
     DeepFM and AutoInt on the card against the CPU (f32 loss, gradients
     per leaf, the arch's step: rowwise AdaGrad tables and accumulators or
     AdamW, CTR forwards, retrieval ids); (b) the two-tower at full width:
     the candidate index from item_embedding over 1,000,448 items, fitted
     (gram) and pruned to m = 128 (pca_project), retrieval_cand at k 100
     through its bundle (full d 256, pruned f32, pruned int8, int8 with a
     4,096-row delta, int8 under hier_merge on a (2, 2) mesh of the card's
     slots), ids against the plain top-k, recall@100 against the full
     search, and compress_tables over the 1,048,576 x 256 item table; (c)
     one train_batch step at the largest batch that fits (65,536 first),
     serve_p99 and serve_bulk, against their bounds, with peak memory; (d)
     DLRM with its tables cut to 2^24 rows (45.0 GB): a rowwise step at
     65,536 in place, peak under tables + 20 GB; DeepFM and AutoInt whole:
     a rowwise step and serve_p99; (e) launch.train --arch deepfm (full
     config, 20 steps, checkpoints under build/recsys_smoke/) and a
     bitwise resume;
 17. the GNN family (graphcast: 16 layers, h 512, bf16 compute, f32
     parameters, remat): (a) the smoke config on the card against the CPU,
     each aggregator with and without an edge mask, f32 loss, gradients and
     one AdamW step, bf16 by cosine; (b) a full-width step twice from one
     state, bitwise; (c) one AdamW step a cell at the published sizes
     (molecule, full_graph_sm, minibatch_lg through the fanout sampler over
     a 232,965-node, 114,615,892-edge power-law CSR graph, ogb_products cut
     by the smallest power of two that fits), each against its one-card
     bound, with peak memory and the gathers' and segment sums' share; (d)
     launch.train --arch graphcast (20 steps, checkpoints under
     build/gnn_smoke/) and a bitwise resume; (e) launch.dryrun --all --mesh
     both on meta tensors, in DRYRUN_JOBS processes started after (c), so
     that no timed phase shares the host with it: every cell of every
     family accounted for, and the roofline tables;
 18. the analysis gate (``repro_torch.analysis``), run right after phase 12
     over phase 4's indexes: (a) the top-k's live count as a 0-d device
     tensor bitwise the host int's (a 4,096-row delta, f32 and int8, at
     counts 0, 1, 1,808, 4,095 and 4,096, k 10 and 100; the full index at
     n - 1), and a delta search captured once in a CUDA graph replayed at
     three counts bitwise eager, both timed; (b) the dispatch lints on the
     full-size dense, sharded (4 slots), segmented, paged and cascade entry
     points (top-k calls a search as the CPU counts them, no upcast of the
     int8 index, nothing synchronizing under set_sync_debug_mode("error"));
     (c) the kernel budget, one line a kernel (registers, shared bytes,
     spills), no error; (d) each entry point's batch timed (median of CUDA
     events) into build/analysis/measured.json, and the cost model's
     cross-check against it; (e) ``python -m repro_torch.analysis
     --fail-on-findings`` exits 0.

Phases 4-6 are the main path: every launch counter is zeroed just before
phase 4 and read just after phase 6; phases 7 (the paged path), 8 (the
live path), 9 (the store), 10 (the cascade), 11 (the fleet), 12 (the
sharded index), 18 (the analysis gate), 13 (the encoder), 14 (the
training half), 15 (the LM family, which runs none of the kernels), 16
(the recsys family) and 17 (the GNN family, which runs none either) are
counted the same way, each on its own, in that order. Launches made only to compare or
time a kernel are not counted. Then one line {"kernels": [...]}, the nvidia-smi
line, and last {"ok": true, "device": {...}}. Any failure raises and exits
non-zero without the last line; so does a machine without a CUDA device.
"""
import argparse
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_DOCS = 8_841_823          # MS MARCO passage corpus rows (the paper's corpus)
DIM = 768                   # TAS-B / ANCE / Contriever width
CUTOFF = 0.5                # m = 384
BATCH = 32                  # serving batch
K = 10
SEARCH_BATCHES = 8
SHORTLIST_K = 100
PROTOCOL_DOCS = 100_000
PROTOCOL_DEPTH = 1000       # benchmarks/common.py:24
SERVER_CLOSED = 256
SERVER_OPEN = 512
PAGE_ROWS = 256             # the reference's default page size
WAVE_PAGES = 64             # host-tier pages per streamed wave
EVICT_PAGES = 2048          # pages moved to pinned host memory in phase 7
DELTA_CAPACITY = 4096       # rows of a delta segment (the reference's default)
APPEND_BLOCK = 64           # rows per add_documents (serve.py --live-append)
LIVE_APPEND = 10_000        # phase 8(a): rows appended to each index
LIVE_DELTAS = [4096, 4096, 1808]
WIDEN_AT = 5056             # first row of the x9 block (in the second delta)
LIVE_RATE = 2000.0          # phase 8(c): rows/s appended under traffic
PAGED_APPEND = 2048         # phase 8(d): rows appended to the paged updater
LIVE_DOCS = 32_768          # new documents drawn in phase 4 for phases 8 and 9
BUILD_BLOCK = 262_144       # phase 9: rows per card-resident block of a build
STORE_APPEND = 10_000       # phase 9(e): rows appended durably
PAGED_STORE_APPEND = 384    # phase 9(f): rows appended before the paged save
DISK_MARGIN = 2 << 30       # phase 9(d): free disk kept beside the f32 artifact
FIT_BLOCK = 25_000          # phase 9(b): rows per block of the fit-inside build
COMP_TOL = 1e-3             # phase 9(b): two fits' kept subspace and conditioned columns
CASCADE_M = 64              # phase 10: the coarse width of 64:8 (README's operating point)
CASCADE_N = 8               # phase 10: shortlist depth N (N·k candidates a query)
CASCADE_CONFIGS = [(64, 8), (128, 16), (128, 32)]   # phase 10(c): M:N points timed
ANCHOR_DOCS = 100_000       # phase 10(b): rows of the bitwise anchor's prefix
CASCADE_TAPE = 2048         # phase 10(d): open-loop queries during the appends
CASCADE_RATE = 1000.0       # phase 10(d): qps offered
FLEET_REPLICAS = 3          # phase 11
FLEET_RATE = 1000.0         # phase 11: qps offered
FLEET_SECONDS = 10.0        # phase 11: the chaos drive's length
FLEET_KILL_AT = 3.0         # phase 11: r1 killed ...
FLEET_RESTART_AT = 6.0      # ... and restarted (seconds into the drive)
ROLLOUT_TAPE = 3000         # phase 11: queries during the bad rollout
SHARD_KS = (K, SHORTLIST_K)  # phase 12: k of the sharded searches (the chunk select, the radix)
ENCODE_DOCS = 100_000       # phase 13(c): passages encoded at seq 256 (--encode-docs)
ENCODE_QUERIES = 1000       # phase 13(c): queries encoded, query i paired with passage i
ENCODE_BATCH = 1024         # phase 13: rows per encoder micro-batch (--encode-batch)
ENCODE_PARITY_ROWS = 8      # phase 13(a): sequences encoded on the card and on the CPU
# phase 13(a): the full-width encoder on the card against the same weights
# on the CPU; f32 compute sums 12 layers in another order on each side
ENCODE_F32_TOL = 1e-4       # max |card - CPU| of the unit-norm embeddings
ENCODE_BF16_COS = 0.999     # per-row cosine, bf16 compute (products round to bf16)
TRAIN_PARITY_PAIRS = 8      # phase 14(a): pairs of the card-against-CPU step ...
TRAIN_PARITY_SEQ = 32       # ... and their tokens
# phase 14(a) bars: f32 compute, loss and each gradient leaf within 1e-4 of
# the CPU's (relative to the leaf's largest entry); bf16 compute, the loss
# within 1e-2 relative and the flattened gradient at cosine >= 0.999
TRAIN_F32_TOL = 1e-4
TRAIN_BF16_LOSS_RTOL = 1e-2
TRAIN_BF16_COS = 0.999
TRAIN_PROBE_BATCHES = (128, 256)    # phase 14(b): pairs a step whose peaks predict the fit
TRAIN_TIMED_STEPS = 3       # phase 14(b): timed steps at the batch that fits (median)
TRAIN_RUN_BATCH = 256       # phase 14(c, d): pairs a step of the 20-step run
TRAIN_RUN_STEPS = 20
TRAIN_CKPT_EVERY = 10
TRAINED_STEPS = 20          # phase 14(e): launch.encode --steps ...
TRAINED_BATCH = 256         # ... --batch ...
TRAINED_SEQ = 128           # ... --seq-len (train_pairs' sequence length)
TRAINED_DOCS = 100_000      # ... --n-docs: the shapes of phase 13(c)'s kernel rows
LM_PARITY_ARCHS = ("qwen2-1.5b", "mixtral-8x7b", "arctic-480b")    # phase 15(a)
# phase 15(a) bars: f32 compute, loss and each gradient leaf within 1e-4 of
# the CPU's (relative to the leaf's largest entry), logits within 1e-4
# absolute; the MoE aux loss within 1e-5; bf16 loss within 1e-2 relative and
# the flattened gradient at cosine >= 0.999
LM_F32_TOL = 1e-4
LM_AUX_TOL = 1e-5
LM_BF16_COS = 0.999
SERVE_ARCH = "qwen2-1.5b"   # phase 15(b, c)
PREFILL_BATCH = 1           # phase 15(b): sequences of prefill_32k's 32 (~10 s each)
DECODE_BATCHES = (128, 64, 32, 16, 8)   # phase 15(b): decode_32k's 128, then halved
LM_CHECK_PROMPT = 64        # phase 15(b): decode at p against the full forward
LM_TRAIN_K = 4              # phase 15(c): micro-batches of the train step ...
LM_TRAIN_PROBES = (4, 8)    # ... global batches whose peaks predict the fit ...
LM_TRAIN_BATCHES = (128, 64, 32, 16, 8)     # ... then tried largest first (train_4k's 256)
MIXTRAL_LAYERS = 4          # phase 15(d): of mixtral's 32 (2.90 GB of bf16 weights each)
LONG_POS = 524_288 + 2 * 4096 + 17      # phase 15(d): first position decoded, past 524,000
LM_RUN_BATCH = 4            # phase 15(e): sequences a step (4 micro-batches of 1) ...
LM_RUN_STEPS = 20           # ... steps of launch.train --arch smollm-135m
LM_RUN_CKPT_EVERY = 10
RECSYS_ARCHS = ("two-tower-retrieval", "dlrm-mlperf", "deepfm", "autoint")   # phase 16(a)
RECSYS_PARITY_BATCH = 32    # phase 16(a): the reference launcher's smoke cell
# phase 16(a) bars (PERF.md §2): f32 loss and each gradient leaf within 1e-4
# of the CPU's (relative to the leaf's largest entry), forwards within 1e-4
# absolute; after one step the parameters and tables within 1e-6 absolute,
# the accumulators and moments within 1e-4 of the leaf's largest entry
RECSYS_F32_TOL = 1e-4
RECSYS_STEP_TOL = 1e-6
TT_CANDIDATES = 1_000_448   # phase 16(b): retrieval_cand's 10^6, rounded up to 512 as the bundle
TT_CUTOFF = 0.5             # ... pruned 256 -> 128
TT_DELTA_ROWS = 4096        # ... a delta of this capacity (delta_rows) ...
TT_DELTA_LIVE = 4000        # ... holding this many new items (n_valid below the capacity)
TT_USER = 5                 # ... the query's user id
TT_EMBED_BLOCK = 262_144    # items through item_embedding at a time
TT_TRAIN_BATCHES = (65536, 32768, 16384, 8192)  # phase 16(c): train_batch's 65,536, then halved
TT_TIMED_STEPS = 3          # ... timed steps at the batch that fits (median)
DLRM_ROW_CAP = 1 << 24      # phase 16(d): rows a DLRM table keeps (five Criteo-TB tables cut)
RECSYS_TRAIN_BATCH = 65536  # phase 16(d, e): train_batch's global batch, whole on one card
RECSYS_RUN_STEPS = 20       # phase 16(e): launch.train --arch deepfm steps ...
RECSYS_RUN_CKPT_EVERY = 10  # ... and its checkpoint interval
GNN_AGGS = ("sum", "mean", "max")   # phase 17(a): every aggregator, masked and not
# phase 17(a) bars: f32 compute, loss and each gradient leaf within 1e-4 of the
# CPU's (relative to the leaf's largest entry), parameters after one AdamW
# step within 1e-4 absolute; bf16 compute, outputs per node row and the
# flattened gradient at cosine >= 0.999
GNN_F32_TOL = 1e-4
GNN_BF16_COS = 0.999
GNN_TIMED_STEPS = 5         # phase 17(c): timed steps a cell (median), after one warm-up
GNN_OGB_FACTORS = (16, 32, 64, 128)     # phase 17(c): ogb_products' nodes and edges divided
                                        # by the first of these that fits one card
GNN_RUN_STEPS = 20          # phase 17(d): launch.train --arch graphcast steps ...
GNN_RUN_CKPT_EVERY = 10     # ... and its checkpoint interval
DRYRUN_JOBS = 8             # phase 17(e): processes of the dry run (the host's cores)
DRYRUN_TIMEOUT = 300        # ... seconds it may take, from its start after 17(c)
ANALYSIS_DELTA = 4096       # phase 18(a): rows of the delta searched with a device count
ANALYSIS_COUNTS = (0, 1, 1808, 4095, 4096)   # ... at these live counts
ANALYSIS_REPLAY = (1, 1808, 4096)            # ... and replayed in a CUDA graph at these
ANALYSIS_TIMED = 7          # phase 18(d): CUDA-event runs an entry point (median)
ANALYSIS_TIMEOUT = 300      # phase 18(e): seconds python -m repro_torch.analysis may take
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peaks (700 W)
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12    # dense, tensor cores
TOL = 1e-5                  # tests/test_kernels.py:126
# gram over 8.8M rows: max |kernel - G64| / max |G64|, G64 the plain
# version's product in fp64. The kernel's longest fp32 chain is 16,384 rows
# plus a 540-term sum of partials; it measured 1.5e-6 (PERF.md).
GRAM_TOL = 1e-5


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(bytes_moved, flops, bf16_flops=0):
    """The least time for the work: bytes over the memory rate against fp32
    FLOP (CUDA cores) plus bf16 FLOP (tensor cores) over their peaks."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP32_FLOP_PER_S + bf16_flops / BF16_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps=3):
    """Mean device time of ``fn`` over ``reps`` launches after one warmup."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_ms(fn, reps=50):
    """Mean host time for ``fn`` to return, with no synchronise inside the
    loop: where it comes close to ``cuda_ms`` the call is bound by its host
    work (the wrapper, the launches), not by the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


class Counters:
    """The kernels' launch counters: zeroed before the main path, read
    after it; ``uncounted`` restores them around compare/timing launches.
    ``gram`` counts its calls and the CUDA launches its C entry reports.
    ``topk_score`` and its paged wrapper count per mode (storage dtype,
    row_ids, paged_<dtype>, paged_ids), both their calls and the CUDA
    launches their C entries report; the large-k select counts its runs
    per calling mode."""

    def __init__(self):
        from repro_torch.kernels.gram import gram_cuda
        from repro_torch.kernels.pca_project import pca_project_cuda, pca_project_quant_cuda
        from repro_torch.kernels.topk_score import (topk_score_cuda, topk_score_paged_cuda,
                                                    topk_select_cuda)
        self.fns = {"gram": gram_cuda, "pca_project": pca_project_cuda,
                    "pca_project_quant": pca_project_quant_cuda}
        self.topk = (topk_score_cuda, topk_score_paged_cuda)
        self.select = topk_select_cuda

    def read(self):
        out = {name: fn.launches for name, fn in self.fns.items()}
        out["gram_cuda"] = self.fns["gram"].cuda_launches
        for fn in self.topk:
            for mode, v in fn.launches.items():
                out[f"topk_score_{mode}"] = v
                out[f"topk_score_{mode}_cuda"] = fn.cuda_launches[mode]
        for mode, v in self.select.launches.items():
            out[f"topk_select_{mode}"] = v
        out["topk_select_keys_cuda"] = self.select.cuda_launches["keys"]
        # runs of the select, whoever called it
        out["topk_select"] = sum(self.select.launches.values())
        return out

    def restore(self, values):
        for name, fn in self.fns.items():
            fn.launches = values[name]
        self.fns["gram"].cuda_launches = values["gram_cuda"]
        for fn in self.topk:
            for mode in fn.launches:
                fn.launches[mode] = values[f"topk_score_{mode}"]
                fn.cuda_launches[mode] = values[f"topk_score_{mode}_cuda"]
        for mode in self.select.launches:
            self.select.launches[mode] = values[f"topk_select_{mode}"]
        self.select.cuda_launches["keys"] = values["topk_select_keys_cuda"]

    def zero(self):
        self.restore(dict.fromkeys(self.read(), 0))

    @contextlib.contextmanager
    def uncounted(self):
        saved = self.read()
        try:
            yield
        finally:
            self.restore(saved)


def compare_topk(s_ref, i_ref, s_got, i_got, what):
    """Scores within TOL; ids equal except where the plain version's
    neighbouring scores lie within TOL (another sum order may swap them),
    or, in the last slot, where the doc from past the cut scores within
    TOL of the one it displaced. Returns (max_abs_err, ids_equal,
    near_ties)."""
    import torch
    s_ref, i_ref, s_got, i_got = (x.cpu() for x in (s_ref, i_ref, s_got, i_got))
    finite = torch.isfinite(s_ref)
    if not torch.equal(finite, torch.isfinite(s_got)):
        raise AssertionError(f"{what}: -inf pads differ")
    delta = (s_ref[finite] - s_got[finite]).abs()
    err = float(delta.max()) if finite.any() else 0.0
    if bool((delta > TOL + TOL * s_ref[finite].abs()).any()):
        raise AssertionError(f"{what}: score error {err}")
    near = 0
    for b, j in (i_ref != i_got).nonzero().tolist():
        k = s_ref.shape[1]
        nb = [abs(float(s_ref[b, j] - s_ref[b, jj])) <= TOL
              for jj in (j - 1, j + 1) if 0 <= jj < k]
        at_cut = j == k - 1 and abs(float(s_got[b, j] - s_ref[b, j])) <= TOL
        if not (any(nb) or at_cut):
            raise AssertionError(f"{what}: id mismatch at ({b}, {j}): "
                                 f"{i_ref[b, max(j-1, 0):j+2].tolist()} vs "
                                 f"{i_got[b, max(j-1, 0):j+2].tolist()}")
        near += 1
    return err, near == 0, near


def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi, sms=props.multi_processor_count,
         memory_gb=props.total_memory / 1e9, torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build()
    secs = time.perf_counter() - t0
    for source, report in reports.items():
        for fn in _build.ptxas_summary(report):
            mangled = fn.pop("function")
            name = re.search(r"\d+([a-z][a-z_]*_kernel)", mangled)
            targs = re.search(r"_kernelI(\w+?)EEv", mangled)
            emit("build", source=f"src/repro_torch/csrc/{source}.cu",
                 kernel=(name.group(1) if name else mangled)
                 + (f"<{targs.group(1)}>" if targs else ""), **fn)
    emit("build", seconds=secs, sources=list(reports))


def phase_edge_cases():
    import torch
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import gram, pca_project, topk_score
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    checks = []
    # m = 130 is not a multiple of 16: the chunk kernel's element-wise loader
    # n one row either side of the 512-row chunk, B of one to three 32-query
    # tiles, k either side of the register / shared-memory select, m = 768
    # in two 384-wide query panels
    cases = [(1000, 64, 5, 10), (4097, 384, 32, 100), (3000, 48, 40, 1000),
             (700, 16, 3, 1000), (1536, 384, 33, 10), (1300, 130, 7, 10),
             (2100, 130, 33, 1000), (511, 384, 1, 1), (513, 384, 65, 32),
             (1023, 130, 65, 33), (1025, 16, 33, 1000), (2049, 768, 33, 10)]
    # the chunk kernel is persistent (one CTA per SM and query tile walks
    # chunks, carrying a running list per query): three chunks per SM give
    # every CTA several, and n_valid then masks whole chunks of the walk
    walk = 3 * torch.cuda.get_device_properties(dev).multi_processor_count * 512 + 1
    cases += [(walk, 48, B, k) for B in (1, 33, 65) for k in (1, 32, 33, 100)]
    # k past the old 1024 cap, to n and past it (pads)
    cases += [(3000, 130, 33, 2048), (3000, 48, 7, 3007), (walk, 48, 33, 2048)]
    for n, m, B, k in cases:
        # rows of unit norm, so scores are O(1) as on the main path: the
        # near-tie window TOL is absolute
        D, Q = randn(n, m) / m ** 0.5, randn(B, m)
        # shuffled row ids with a few masked (-1) rows
        row_ids = torch.randperm(n, generator=g, device=dev).to(torch.int32) + 1000
        row_ids[torch.randperm(n, generator=g, device=dev)[:n // 10]] = -1
        for store in ("f32", "bf16", "int8"):
            Dx, Qx = D, Q
            if store == "bf16":
                Dx = D.to(torch.bfloat16)
            elif store == "int8":
                Dx, scale = quantize_int8_per_dim(D)
                Qx = (Q * scale[None, :]).contiguous()
            n_valid = n // 2 + 37 if n == walk else n - 300
            for mode, kw in (("plain", {}), ("n_valid", {"n_valid": n_valid}),
                             ("row_ids", {"row_ids": row_ids})):
                got = topk_score.topk_score_cuda(Dx, Qx, k=k, **kw)
                want = topk_score.topk_score_plain(Dx, Qx, k=k, **kw)
                err, eq, near = compare_topk(*want, *got,
                                             f"topk {store} {mode} n={n} m={m} k={k}")
                checks.append(dict(kernel="topk_score", n=n, m=m, B=B, k=k,
                                   store=store, mode=mode, max_abs_err=err,
                                   ids_equal=eq, near_ties=near))
    # every row tied, across chunks: ids exactly 0..k-1
    row = randn(32)
    D = row[None, :].repeat(2000, 1).contiguous()
    Q = torch.stack([row, 2 * row]).contiguous()
    for k in (10, 100, 1000):
        _, ids = topk_score.topk_score_cuda(D, Q, k=k)
        if not bool((ids.cpu() == torch.arange(k)[None, :]).all()):
            raise AssertionError(f"all-tied rows: ids are not 0..{k - 1}")
        checks.append(dict(kernel="topk_score", case="all_tied", k=k, ids_equal=True))
    # row_ids out of order; the smaller tied id sits in a later chunk
    D = torch.zeros(1500, 16, device=dev)
    D[:, 0] = torch.linspace(0.5, 2.0, 1500, device=dev)
    D[3, 0] = D[1200, 0] = 5.0
    ids = torch.randperm(1500, generator=g, device=dev).to(torch.int32) + 100
    ids[3], ids[1200], ids[10] = 50, 7, -1
    Q = torch.zeros(2, 16, device=dev)
    Q[:, 0] = 1.0
    for k in (1, 10, 100):
        s1, i1 = topk_score.topk_score_cuda(D, Q, k=k, row_ids=ids)
        s2, i2 = topk_score.topk_score_plain(D, Q, k=k, row_ids=ids)
        if int(i1[0, 0]) != 7 or not torch.equal(i1.cpu(), i2.cpu()):
            raise AssertionError("row_ids: min-id tie-break or ids differ")
        checks.append(dict(kernel="topk_score", case="row_ids_tie", k=k,
                           max_abs_err=float((s1 - s2).abs().max()), ids_equal=True))
    # gram and pca_project: ragged shapes, f32 and bf16; n = 10 is one row
    # range (no second pass); the mirrored result is exactly symmetric;
    # n = 129 and d = 16 sit one row past a 128-row tile and on one slab
    for n, d, dtype in [(3001, 200, torch.float32), (5000, 768, torch.bfloat16),
                        (10, 300, torch.float32), (129, 16, torch.float32),
                        (32, 768, torch.float32)]:
        D = randn(n, d).to(dtype)
        got, want = gram.gram_cuda(D), gram.gram_plain(D)
        rel = float((got - want).abs().max() / want.abs().max())
        if rel > 1e-5 or not torch.equal(got, got.T):
            raise AssertionError(f"gram {dtype}: relative error {rel}, or not symmetric")
        checks.append(dict(kernel="gram", n=n, d=d, dtype=str(dtype), rel_err=rel))
        W = randn(d, 130)
        got = pca_project.pca_project_cuda(D, W)
        want = pca_project.pca_project_plain(D, W)
        rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        if rel > (1e-2 if dtype == torch.bfloat16 else 1e-5):
            raise AssertionError(f"pca_project {dtype}: relative error {rel}")
        checks.append(dict(kernel="pca_project", n=n, d=d, m=130, dtype=str(dtype),
                           rel_err=rel))
        if dtype == torch.float32:
            scale = (want.abs().amax(0) / 127.0).contiguous()
            q1 = pca_project.pca_project_quant_cuda(D, W, scale).int()
            q2 = pca_project.pca_project_quant_plain(D, W, scale).int()
            diff = (q1 - q2).abs()
            frac = float((diff != 0).float().mean())
            if int(diff.max()) > 1 or frac > 1e-3:
                raise AssertionError(f"pca_project_quant: {frac} differ")
            checks.append(dict(kernel="pca_project_quant", n=n, d=d, m=130,
                               max_abs_err=int(diff.max()), frac_differ=frac))
    ids_row = paged_edge_cases(dev, randn, checks)
    any_batch_cases(dev, randn, checks)
    torch.cuda.synchronize()
    emit("edge_cases", checks=len(checks),
         near_ties=sum(c.get("near_ties", 0) for c in checks), results=checks)
    return ids_row


def any_batch_cases(dev, randn, checks):
    """B = 65,537 queries, past one launch's 65,535 query rows: the dense
    top-k (f32 and int8 at k = 10 and 100), the paged top-k over the same
    rows in pages of 256, the select alone and DenseIndex.search against
    their plain versions, and the last query's row bitwise equal to a
    one-query call."""
    import torch
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import ref, topk_score
    n, m, B, R = 4096, 64, 65537, 256
    D, Q = randn(n, m) / m ** 0.5, randn(B, m)
    last = B - 1

    def held(what, got, want, one=None):
        err, eq, near = compare_topk(*want, *got, f"B={B} {what}")
        if one is not None and not (torch.equal(got[0][last:], one[0])
                                    and torch.equal(got[1][last:], one[1])):
            raise AssertionError(f"B={B} {what}: the last row differs from a one-query call")
        checks.append(dict(kernel=what.split()[0], case="any_batch", n=n, m=m, B=B,
                           max_abs_err=err, ids_equal=eq, near_ties=near,
                           **({} if one is None else {"last_row_bitwise": True})))

    for store in ("f32", "int8"):
        scale, Dx, Qx = None, D, Q
        if store == "int8":
            Dx, scale = quantize_int8_per_dim(D)
            Qx = (Q * scale[None, :]).contiguous()
        npages = n // R
        pages = (Dx.view(npages, R, m), torch.arange(npages, dtype=torch.int32, device=dev),
                 torch.full((npages,), R, dtype=torch.int32, device=dev),
                 torch.arange(npages, dtype=torch.int32, device=dev) * R)
        ps = None if scale is None else scale[None, :].repeat(npages, 1).contiguous()
        for k in (10, 100):
            held(f"topk_score {store} k={k}", topk_score.topk_score_cuda(Dx, Qx, k=k),
                 topk_score.topk_score_plain(Dx, Qx, k=k),
                 topk_score.topk_score_cuda(Dx, Qx[last:], k=k))
            held(f"topk_score_paged {store} k={k}",
                 topk_score.topk_score_paged_cuda(*pages, 0, npages, Q, k=k, page_scale=ps),
                 topk_score.topk_score_paged_plain(*pages, 0, npages, Q, k=k, page_scale=ps),
                 topk_score.topk_score_paged_cuda(*pages, 0, npages, Q[last:], k=k,
                                                  page_scale=ps))
        index = DenseIndex.build(D, quantize_int8=store == "int8")
        held(f"DenseIndex.search {store}", index.search(Q, k=K),
             topk_score.topk_score_plain(index.vectors, index._dequeries(Q), k=K))
    s = randn(B, 300)
    s[:, ::7] = float("-inf")
    ids = torch.arange(300, device=dev, dtype=torch.int32).expand(B, -1)
    keys = (ref._keys(s, ids) ^ topk_score._SIGN).contiguous()
    got = topk_score.topk_select_cuda(keys, 100)
    want = topk_score.topk_select_plain(keys, 100)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"B={B} topk_select: differs from its plain version")
    held("topk_select k=100", got, want, topk_score.topk_select_cuda(keys[last:], 100))


def make_paged(dev, randn, n, m, R, store):
    """A corpus of n unit-norm rows in pages of R rows over a scrambled
    pool + tail layout (a ragged last page, spare physical pages), with
    per-page int8 scales, and an ids_pool of shuffled ids with a tenth
    masked."""
    import torch
    npages = -(-n // R)
    phys_total = npages + 3
    pool_pages = phys_total // 2
    cap = npages + 5
    D = randn(n, m) / m ** 0.5
    perm = torch.randperm(phys_total, device=dev)[:npages].to(torch.int32)
    pt = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    pt[:npages] = perm
    nv = torch.zeros(cap, dtype=torch.int32, device=dev)
    nv[:npages] = R
    nv[npages - 1] = n - (npages - 1) * R
    off = torch.zeros(cap, dtype=torch.int32, device=dev)
    off[:npages] = torch.arange(npages, device=dev, dtype=torch.int32) * R
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[store]
    pool = torch.zeros((pool_pages, R, m), dtype=dtype, device=dev)
    tail = torch.zeros((phys_total - pool_pages, R, m), dtype=dtype, device=dev)
    scale = None
    if store == "int8":
        scale = torch.zeros((cap, m), device=dev)
    for j in range(npages):
        rows = D[j * R:j * R + int(nv[j])]
        if store == "int8":
            scale[j] = rows.abs().amax(0).clamp_min(1e-12) / 127.0
            rows = torch.clamp(torch.round(rows / scale[j]), -127, 127)
        p = int(pt[j])
        (pool[p] if p < pool_pages else tail[p - pool_pages])[:rows.shape[0]] = rows.to(dtype)
    ids = torch.full((cap, R), -1, dtype=torch.int32, device=dev)
    ids.view(-1)[:npages * R] = (torch.randperm(npages * R, device=dev).to(torch.int32)
                                 + 1000)
    ids.view(-1)[torch.randperm(npages * R, device=dev)[:npages * R // 10]] = -1
    return dict(pool=pool, page_table=pt, page_nvalid=nv, page_offset=off,
                tail=tail, page_scale=scale, npages=npages), ids


def paged_edge_cases(dev, randn, checks):
    """The paged kernel against its plain version: ragged last page, a
    scrambled pool/tail table, k beyond the live rows, lo > 0, a carry
    split (the un-finalized ids, pads included, equal exactly), ids_pool
    out of order with negatives, m = 130, page sizes off and on the
    64-row unit, below and above the 512-row chunk, f32/bf16/int8, k in
    {10, 32, 100, 1000, 2048}, and a walk of more chunks than CTAs.
    Returns the timing row of the ids_pool mode at the first shape."""
    import torch
    from repro_torch.kernels import topk_score
    cuda, plain = topk_score.topk_score_paged_cuda, topk_score.topk_score_paged_plain
    ids_row = None
    # the last two: k past the old cap, and a walk of more chunks than CTAs
    walk = 3 * torch.cuda.get_device_properties(dev).multi_processor_count * 512 + 77
    for n, m, R, B, k in [(5000, 384, 256, 32, 10), (3001, 130, 256, 7, 100),
                          (2600, 64, 512, 33, 1000), (2100, 48, 700, 5, 10),
                          (300, 16, 8, 3, 1000), (3000, 48, 100, 33, 2048),
                          (walk, 48, 100, 33, 32)]:
        Q = randn(B, m)
        for store in ("f32", "bf16", "int8"):
            pg, ids = make_paged(dev, randn, n, m, R, store)
            npages = pg.pop("npages")
            split = npages // 2
            kw = {key: v for key, v in pg.items()
                  if key not in ("pool", "page_table", "page_nvalid", "page_offset")}
            args = (pg["pool"], pg["page_table"], pg["page_nvalid"], pg["page_offset"])
            cases = [("full", 0, npages, {}), ("lo>0", min(3, npages - 1), npages, {}),
                     ("ids_pool", 0, npages, {"ids_pool": ids})]
            for mode, lo, hi, extra in cases:
                got = cuda(*args, lo, hi, Q, k=k, **kw, **extra)
                want = plain(*args, lo, hi, Q, k=k, **kw, **extra)
                err, eq, near = compare_topk(*want, *got, f"paged {store} {mode} "
                                             f"n={n} m={m} R={R} k={k}")
                checks.append(dict(kernel="topk_score_paged", n=n, m=m, R=R, B=B, k=k,
                                   store=store, mode=mode, max_abs_err=err,
                                   ids_equal=eq, near_ties=near))
                if mode == "ids_pool":
                    ids_check = checks[-1]
            # carry split: the un-finalized head (pad ids included, which
            # compare_topk holds exactly), then the finalized chain
            p1 = cuda(*args, 0, split, Q, k=k, **kw, finalize=False)
            w1 = plain(*args, 0, split, Q, k=k, **kw, finalize=False)
            compare_topk(*w1, *p1, f"paged {store} carry head n={n} R={R} k={k}")
            got = cuda(*args, split, npages, Q, k=k, **kw, carry=p1)
            want = plain(*args, split, npages, Q, k=k, **kw, carry=w1)
            err, eq, near = compare_topk(*want, *got, f"paged {store} carry n={n} R={R} k={k}")
            checks.append(dict(kernel="topk_score_paged", n=n, m=m, R=R, B=B, k=k,
                               store=store, mode="carry", max_abs_err=err,
                               ids_equal=eq, near_ties=near))
            if ids_row is None and store == "f32":
                nb = npages * R
                P = pg["pool"].shape[0]
                phys = pg["page_table"][:npages].long()
                pages = torch.where((phys < P)[:, None, None],
                                    pg["pool"][phys.clamp(max=P - 1)],
                                    kw["tail"][(phys - P).clamp(min=0)])
                gathered = pages.reshape(-1, m)
                ids_row = dict(
                    shape=[n, m, R, B, k], max_abs_err=ids_check["max_abs_err"],
                    ids_equal=ids_check["ids_equal"], near_ties=ids_check["near_ties"],
                    ms=cuda_ms(lambda: cuda(*args, 0, npages, Q, k=k, ids_pool=ids, **kw),
                               reps=20),
                    plain_ms=cuda_ms(lambda: plain(*args, 0, npages, Q, k=k, ids_pool=ids,
                                                   **kw), reps=5),
                    library_ms=cuda_ms(lambda: torch.topk(Q @ gathered.T, k), reps=20),
                    library_call="matmul + topk over the gathered rows",
                    bound=bound(4 * nb * m + 4 * nb + 12 * npages + 4 * B * m
                                + 8 * B * k, 2 * B * nb * m))
    return ids_row


def phase_main_path(counters, rows, n_docs):
    """Full-width corpus, fit, prune, int8, search and rescore. Returns the
    indexes, pruner and host queries for the server phase."""
    import numpy as np
    import torch
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.pruning import StaticPruner
    from repro_torch.data.synthetic import corpus_on_device
    from repro_torch.kernels import gram, ops, pca_project, ref, topk_score

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    D = corpus_on_device("tasb", n_docs=n_docs, d=DIM, seed=0, device=dev)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    pruner = StaticPruner(cutoff=CUTOFF).fit(D)               # gram kernel
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    m = pruner.kept_dims
    W, _ = pruner.projection()
    t0 = time.perf_counter()
    pruned = pruner.prune_index(D)                            # pca_project kernel
    torch.cuda.synchronize()
    t_prune = time.perf_counter() - t0
    index_f32 = DenseIndex.build(pruned)
    t0 = time.perf_counter()
    index_int8 = DenseIndex.build(pruned, quantize_int8=True)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = ops.pca_project_quant(D, W, index_int8.scale)     # fused int8 build
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    diff = (fused.view(torch.uint8) != index_int8.vectors.view(torch.uint8))
    frac_fused = float(diff.float().mean())
    del diff

    # queries: perturbed corpus rows, L2-normalised
    g = torch.Generator(device=dev).manual_seed(2)
    nq = SEARCH_BATCHES * BATCH + SERVER_CLOSED + SERVER_OPEN
    rows_q = torch.randint(0, n_docs, (nq,), generator=g, device=dev)
    Qall = D[rows_q] + 0.5 / DIM ** 0.5 * torch.randn(nq, DIM, generator=g, device=dev)
    Qall = Qall / Qall.norm(dim=1, keepdim=True)
    Qs = Qall[:SEARCH_BATCHES * BATCH]

    results = {}
    t0 = time.perf_counter()
    for name, index in (("f32", index_f32), ("int8", index_int8)):
        results[name] = [index.search_projected(Qs[i:i + BATCH], W, k=K)
                         for i in range(0, len(Qs), BATCH)]
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    # exact f32 rescore of one batch's int8 shortlist (row_ids mode)
    qb = Qs[:BATCH]
    _, short = index_int8.search_projected(qb, W, k=SHORTLIST_K)
    short_ids = torch.unique(short[short >= 0]).to(torch.int32)   # ascending
    D_short = index_f32.vectors[short_ids.long()].contiguous()
    qhat = (qb @ W).contiguous()
    rescored = ops.topk_score(D_short, qhat, k=K, row_ids=short_ids)
    torch.cuda.synchronize()
    agree = float((rescored[1].cpu() == results["f32"][0][1].cpu()).float().mean())

    emit("main_path", n=n_docs, d=DIM, m=m, gen_s=t_gen, fit_s=t_fit, prune_s=t_prune,
         quantize_s=t_quant, fused_quant_s=t_fused, search_s=t_search,
         f32_gb=index_f32.nbytes / 1e9, int8_gb=index_int8.nbytes / 1e9,
         fused_vs_two_pass_frac_differ=frac_fused,
         rescore_vs_f32_top10_agree=agree,
         eigenvalue_top3=pruner.state.eigenvalues[:3].tolist())
    if frac_fused > 1e-3:
        raise AssertionError(f"fused int8 build differs on {frac_fused} of entries")

    with counters.uncounted():
        # each kernel against its plain version, and its time, at the shapes
        # this path gave it
        # gram: the plain version run in one fp32 product sums 8.8M rows in
        # one cuBLAS call and is itself off by 2.6e-4 of max |G| (measured,
        # PERF.md). So the kernel is held against the plain version's
        # arithmetic in fp64, over row blocks; the fp32 plain version's own
        # distance from it is printed beside.
        G = gram.gram_cuda(D)
        Gp = gram.gram_plain(D)
        n, d = D.shape
        G64 = torch.zeros((d, d), dtype=torch.float64, device=dev)
        for i in range(0, n, 1 << 20):
            c = D[i:i + (1 << 20)].double()
            G64 += c.T @ c
        del c
        g64 = float(G64.abs().max())
        g_err = float((G.double() - G64).abs().max())
        g_rel = g_err / g64
        plain_rel = float((Gp.double() - G64).abs().max()) / g64
        kernel_vs_plain = float((G - Gp).abs().max()) / float(Gp.abs().max())
        del G64
        emit("gram_check", rel_err_vs_f64=g_rel, plain_f32_rel_err_vs_f64=plain_rel,
             rel_err_vs_plain_f32=kernel_vs_plain, tolerance=GRAM_TOL)
        if g_rel > GRAM_TOL:
            raise AssertionError(f"gram: relative error {g_rel} vs the fp64 Gram")
        # fit_s is the process's first fit, one-time set-up included; a
        # second fit on the same corpus is timed beside it
        t0 = time.perf_counter()
        StaticPruner(cutoff=CUTOFF).fit(D)
        torch.cuda.synchronize()
        emit("fit_again", fit_s=time.perf_counter() - t0)
        before = gram.gram_cuda.cuda_launches
        gram.gram_cuda(D)
        per_call = gram.gram_cuda.cuda_launches - before
        rows["gram"] = dict(
            shape=[n, d], max_abs_err=g_err, rel_err=g_rel,
            plain_f32_rel_err_vs_f64=plain_rel, rel_err_vs_plain_f32=kernel_vs_plain,
            cuda_launches_per_call=per_call,
            ms=cuda_ms(lambda: gram.gram_cuda(D)),
            plain_ms=cuda_ms(lambda: gram.gram_plain(D)),
            library_ms=cuda_ms(lambda: torch.matmul(D.T, D)),
            # G is symmetric: the function needs d (d + 1) / 2 entries of
            # 2 n FLOP each
            bound=bound(4 * n * d + 4 * d * d, n * d * (d + 1)))
        del G, Gp
        # the protocol's shape: G bitwise the in-order sum of one-range
        # launches over its row ranges (each one fp32 chain per entry)
        Dp = D[:PROTOCOL_DOCS]
        n_p = Dp.shape[0]
        G = gram.gram_cuda(Dp)
        ranges = gram._ranges(Dp)
        want = torch.zeros((d, d), device=dev)
        for a, b in ranges:
            want += gram._launch(Dp[a:b].contiguous(), 1)
        if not (torch.equal(G, want) and torch.equal(G, gram.gram_cuda(Dp))
                and torch.equal(G, G.T)):
            raise AssertionError("gram: not bitwise the in-order sum of its row ranges")
        Gp = gram.gram_plain(Dp)
        before = gram.gram_cuda.cuda_launches
        gram.gram_cuda(Dp)
        per_call = gram.gram_cuda.cuda_launches - before
        rows["gram_protocol"] = dict(
            shape=list(Dp.shape), ranges=len(ranges), range_sum_bitwise=True,
            max_abs_err=float((G - Gp).abs().max()),
            rel_err_vs_plain_f32=float((G - Gp).abs().max() / Gp.abs().max()),
            launches_per_call=per_call,
            ms=cuda_ms(lambda: gram.gram_cuda(Dp), reps=10),
            plain_ms=cuda_ms(lambda: gram.gram_plain(Dp), reps=10),
            library_ms=cuda_ms(lambda: torch.matmul(Dp.T, Dp), reps=10),
            bound=bound(4 * n_p * d + 4 * d * d, n_p * d * (d + 1)))
        del G, Gp, want

        blk = D[:262144]                                  # prune_index's block
        Wc = W.contiguous()
        p1 = pca_project.pca_project_cuda(blk, Wc)
        p2 = pca_project.pca_project_plain(blk, Wc)
        p_err = float((p1 - p2).abs().max())
        if not torch.equal(p1, pruned[:262144]) or p_err > 1e-4:
            raise AssertionError(f"pca_project: error {p_err}")
        nb = blk.shape[0]
        rows["pca_project"] = dict(
            shape=[nb, d, m], max_abs_err=p_err,
            ms=cuda_ms(lambda: pca_project.pca_project_cuda(blk, Wc), reps=10),
            plain_ms=cuda_ms(lambda: pca_project.pca_project_plain(blk, Wc), reps=10),
            library_ms=cuda_ms(lambda: torch.matmul(blk, Wc), reps=10),
            bound=bound(4 * nb * d + 4 * d * m + 4 * nb * m, 2 * nb * d * m),
            calls_per_prune=-(-n // 262144))
        # a batch of 32 queries, as transform_queries hands it over
        q32 = Qs[:BATCH].contiguous()
        before = pca_project.pca_project_cuda.launches
        p1 = pca_project.pca_project_cuda(q32, Wc)
        per_call = pca_project.pca_project_cuda.launches - before
        p2 = pca_project.pca_project_plain(q32, Wc)
        p_err = float((p1 - p2).abs().max())
        if p_err > 1e-4:
            raise AssertionError(f"pca_project n=32: error {p_err}")
        rows["pca_project_n32"] = dict(
            shape=[BATCH, d, m], max_abs_err=p_err, launches_per_call=per_call,
            ms=cuda_ms(lambda: pca_project.pca_project_cuda(q32, Wc), reps=50),
            enqueue_ms=enqueue_ms(lambda: pca_project.pca_project_cuda(q32, Wc)),
            plain_ms=cuda_ms(lambda: pca_project.pca_project_plain(q32, Wc), reps=50),
            library_ms=cuda_ms(lambda: torch.matmul(q32, Wc), reps=50),
            bound=bound(4 * BATCH * d + 4 * d * m + 4 * BATCH * m, 2 * BATCH * d * m))

        sc = index_int8.scale
        qp = pca_project.pca_project_quant_plain(D[:1 << 20], Wc, sc)
        qd = (fused[:1 << 20].int() - qp.int()).abs()
        q_frac = float((qd != 0).float().mean())
        q_max = int(qd.max())
        if q_max > 1 or q_frac > 1e-3:
            raise AssertionError(f"pca_project_quant: {q_frac} differ")
        del qp, qd
        rows["pca_project_quant"] = dict(
            shape=[n, d, m], max_abs_err=q_max, frac_differ=q_frac,
            ms=cuda_ms(lambda: pca_project.pca_project_quant_cuda(D, Wc, sc)),
            # the plain version over all n rows in 2^20-row blocks: at once
            # its f32 temporaries would not fit beside the corpus
            plain_ms=cuda_ms(lambda: [pca_project.pca_project_quant_plain(
                D[i:i + (1 << 20)], Wc, sc) for i in range(0, n, 1 << 20)]),
            library_ms=None,
            bound=bound(4 * n * d + 4 * d * m + 4 * m + n * m, 2 * n * d * m))
        del fused

        from repro_torch.core.index import project_queries
        for name, index in (("f32", index_f32), ("int8", index_int8)):
            q = project_queries(qb, Wc, scale=index.scale).contiguous()
            got = results[name][0]
            want = topk_score.topk_score_plain(index.vectors, q, k=K)
            err, eq, near = compare_topk(*want, *got, f"topk {name} main path")
            item = index.vectors.element_size()
            rows[f"topk_score_{name}"] = dict(
                shape=[n, m, BATCH, K], store=name, max_abs_err=err, ids_equal=eq,
                near_ties=near,
                ms=cuda_ms(lambda: topk_score.topk_score_cuda(index.vectors, q, k=K), reps=10),
                plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(index.vectors, q, k=K),
                                 reps=2),
                library_ms=None,
                matmul_topk_ms=(cuda_ms(lambda: torch.topk(q @ index.vectors.T, K), reps=2)
                                if item == 4 else None),
                bound=bound(item * n * m + 4 * BATCH * m + 8 * BATCH * K,
                            2 * BATCH * n * m))
            # the same batch at the protocol's depths and past the old 1024
            # cap: k > 32 lists every key and takes the radix select
            for kk in (100, 1000, 2000, 10000):
                before = topk_score.topk_score_cuda.cuda_launches[name]
                got = topk_score.topk_score_cuda(index.vectors, q, k=kk)
                per_call = topk_score.topk_score_cuda.cuda_launches[name] - before
                want = topk_score.topk_score_plain(index.vectors, q, k=kk)
                err, eq, near = compare_topk(*want, *got, f"topk {name} main path k={kk}")
                del got, want
                rows[f"topk_score_{name}_k{kk}"] = dict(
                    shape=[n, m, BATCH, kk], store=name, max_abs_err=err, ids_equal=eq,
                    near_ties=near, launches_per_call=per_call,
                    ms=cuda_ms(lambda: topk_score.topk_score_cuda(index.vectors, q, k=kk),
                               reps=5),
                    plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(
                        index.vectors, q, k=kk), reps=1),
                    library_ms=None,
                    matmul_topk_ms=(cuda_ms(lambda: torch.topk(q @ index.vectors.T, kk),
                                            reps=2) if item == 4 and kk > 1000 else None),
                    bound=bound(item * n * m + 4 * BATCH * m + 8 * BATCH * kk,
                                2 * BATCH * n * m))
        # the large-k select alone (radix passes, gather, sort, write) on one
        # batch's keys over every row, at the int8 shortlist's k = 100
        q = project_queries(qb, Wc).contiguous()
        keys = ref._keys(q @ index_f32.vectors.T,
                         torch.arange(n, device=dev, dtype=torch.int32).expand(BATCH, -1))
        plain_keys = keys.contiguous()
        keys = (keys ^ topk_score._SIGN).contiguous()
        before = topk_score.topk_select_cuda.cuda_launches["keys"]
        got = topk_score.topk_select_cuda(keys, SHORTLIST_K)
        per_call = topk_score.topk_select_cuda.cuda_launches["keys"] - before
        want = topk_score.topk_select_plain(keys, SHORTLIST_K)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("topk_select: differs from its plain version")
        rows["topk_select"] = dict(
            shape=[BATCH, n, SHORTLIST_K], max_abs_err=0.0, ids_equal=True,
            launches_per_call=per_call,
            ms=cuda_ms(lambda: topk_score.topk_select_cuda(keys, SHORTLIST_K), reps=5),
            plain_ms=cuda_ms(lambda: topk_score.topk_select_plain(keys, SHORTLIST_K), reps=2),
            library_ms=cuda_ms(lambda: torch.topk(plain_keys, SHORTLIST_K), reps=2),
            bound=bound(8 * BATCH * n + 8 * BATCH * SHORTLIST_K, 0))
        del keys, plain_keys, got, want
        want = topk_score.topk_score_plain(D_short, qhat, k=K, row_ids=short_ids)
        err, eq, near = compare_topk(*want, *rescored, "topk row_ids")
        U = D_short.shape[0]
        rows["topk_score_row_ids"] = dict(
            shape=[U, m, BATCH, K], max_abs_err=err, ids_equal=eq, near_ties=near,
            ms=cuda_ms(lambda: topk_score.topk_score_cuda(D_short, qhat, k=K,
                                                          row_ids=short_ids), reps=20),
            enqueue_ms=enqueue_ms(lambda: topk_score.topk_score_cuda(D_short, qhat, k=K,
                                                                     row_ids=short_ids)),
            plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(D_short, qhat, k=K,
                                                                 row_ids=short_ids), reps=20),
            library_ms=cuda_ms(lambda: torch.topk(qhat @ D_short.T, K), reps=20),
            library_call="matmul + topk over the gathered rows",
            bound=bound(4 * U * m + 4 * U + 4 * BATCH * m + 8 * BATCH * K,
                        2 * BATCH * U * m))
    # new documents for the live path (phase 8): perturbed corpus rows
    pick = torch.randint(0, n_docs, (LIVE_DOCS,), generator=g, device=dev)
    fresh = D[pick] + 0.5 / DIM ** 0.5 * torch.randn(LIVE_DOCS, DIM, generator=g, device=dev)
    fresh /= fresh.norm(dim=1, keepdim=True)
    del D, pruned
    torch.cuda.empty_cache()
    emit("main_path_vs_plain", **{k: {kk: vv for kk, vv in v.items()}
                                  for k, v in rows.items()})
    return (index_f32, index_int8, pruner, Qall[SEARCH_BATCHES * BATCH:].cpu().numpy(),
            fresh)


def phase_protocol(n_docs):
    """Tables 1 and 2 of the paper on one dataset: W_m fit in domain, and
    out of domain on the card's OOD corpus of the same encoder (RQ2); each
    checked at cutoff 0.5 against the CPU path with the card's PCA state
    carried across."""
    import numpy as np
    import torch
    from repro_torch.convert import pca_state_from_numpy
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.metrics import evaluate_run, wilcoxon_significant
    from repro_torch.core.pruning import StaticPruner
    from repro_torch.data.synthetic import make_dataset, ood_corpus_on_device

    t0 = time.perf_counter()
    ds = make_dataset("tasb", n_docs=n_docs, d=DIM, seed=0)
    t_data = time.perf_counter() - t0
    metrics = ("nDCG@10", "MRR@10", "AP")

    def run(device, cutoff, state=None, fit_on=None):
        D = torch.as_tensor(ds.docs, device=device)
        pruner = None
        if cutoff is not None:
            pruner = StaticPruner(cutoff=cutoff)
            if state is None:
                pruner.fit(D if fit_on is None else fit_on)
            else:
                pruner.state = state
        fitted[cutoff, fit_on is not None] = pruner
        Dx = pruner.prune_index(D) if pruner else D
        index = DenseIndex.build(Dx)
        out = {}
        for qs, Q in ds.queries.items():
            Qt = torch.as_tensor(Q, device=device)
            Qx = pruner.transform_queries(Qt) if pruner else Qt
            s, ids = index.search(Qx, k=PROTOCOL_DEPTH)
            ids = ids.cpu().numpy()
            out[qs] = (s.cpu(), ids, evaluate_run(
                {i: ids[i].tolist() for i in range(len(ids))}, ds.qrels[qs],
                metrics=metrics))
        return out

    def table_of(systems, base):
        table = {}
        for c in (0.25, 0.5, 0.75):
            for qs in ds.queries:
                for name in metrics:
                    got = systems[c][qs][2][name]
                    sig, p = wilcoxon_significant(base[qs][2][name], got)
                    table[f"{int(c * 100)}%/{qs}/{name}"] = dict(
                        value=float(got.mean()), baseline=float(base[qs][2][name].mean()),
                        delta=float(got.mean() - base[qs][2][name].mean()),
                        significant=sig)
        return table

    def cpu_check(card, state, what):
        """The protocol at cutoff 0.5 on the CPU path (plain versions), with
        the card's fitted PCA carried across: eigenvectors of near-equal
        eigenvalues are not unique, so two fits may keep different
        subspaces."""
        t0 = time.perf_counter()
        cpu = run("cpu", 0.5, state=pca_state_from_numpy(
            state.components.cpu().numpy(), state.eigenvalues.cpu().numpy(),
            state.mean.cpu().numpy(), state.n_samples, state.centered, device="cpu"))
        worst = {}
        for qs in ds.queries:
            s_c, i_c, m_c = cpu[qs]
            s_g, i_g, m_g = card[qs]
            compare_topk(s_c[:, :K], torch.as_tensor(i_c[:, :K]),
                         s_g[:, :K], torch.as_tensor(i_g[:, :K]), f"{what} {qs}")
            for name in metrics:
                worst[name] = max(worst.get(name, 0.0),
                                  float(np.abs(m_c[name] - m_g[name]).max()))
        return worst, time.perf_counter() - t0

    fitted = {}
    t0 = time.perf_counter()
    systems = {c: run("cuda", c) for c in (None, 0.25, 0.5, 0.75)}
    t_card = time.perf_counter() - t0
    worst, t_cpu = cpu_check(systems[0.5], fitted[0.5, False].state, "protocol")
    emit("protocol", n_docs=n_docs, d=DIM, depth=PROTOCOL_DEPTH,
         data_s=t_data, card_s=t_card, cpu_check_s=t_cpu,
         card_vs_cpu_max_metric_diff=worst, table=table_of(systems, systems[None]))
    # Table 2 (RQ2): W_m fit on an out-of-domain corpus of the same encoder,
    # drawn on the card, then the in-domain query sets searched
    t0 = time.perf_counter()
    ood = ood_corpus_on_device("tasb", n_docs=n_docs, d=DIM, device="cuda")
    ood_systems = {c: run("cuda", c, fit_on=ood) for c in (0.25, 0.5, 0.75)}
    t_card = time.perf_counter() - t0
    del ood
    worst, t_cpu = cpu_check(ood_systems[0.5], fitted[0.5, True].state, "protocol_ood")
    emit("protocol_ood", n_docs=n_docs, d=DIM, depth=PROTOCOL_DEPTH, fit_corpus="ood",
         card_s=t_card, cpu_check_s=t_cpu, card_vs_cpu_max_metric_diff=worst,
         table=table_of(ood_systems, systems[None]))


def tape_qps(n, rate, seed=0):
    """The rate of an open-loop tape itself: n over the span of the Poisson
    arrivals that ``_drive_open`` draws for it (the same generator and
    seed). Its ``achieved_qps`` (n over arrivals plus the last reply's
    drain) cannot exceed this, however fast the server."""
    import numpy as np
    gaps = np.random.default_rng(seed).exponential(1.0 / rate, size=n)
    return float(n / gaps.sum())


def phase_server(counters, index_f32, index_int8, pruner, Q):
    import numpy as np
    import torch
    from repro_torch.launch.serve import RetrievalServer, _drive, _drive_open, _lat_summary
    W, mean = pruner.projection()
    for name, index in (("int8", index_int8), ("f32", index_f32)):
        server = RetrievalServer(index, pruner, k=K, max_batch=BATCH, pipeline_depth=3)
        try:
            server.warmup()
            wall, lat = _drive(server, Q[:SERVER_CLOSED])
            closed = dict(qps=SERVER_CLOSED / wall, **_lat_summary(lat),
                          **server.worker_stats())
            rate = 2000.0
            res = _drive_open(server, Q[SERVER_CLOSED:], rate=rate, collect=True)
            opened = {k: v for k, v in res.items() if k != "results"}
            opened["tape_qps"] = tape_qps(res["n"], rate)
            opened.update(server.worker_stats())
        finally:
            server.close()
        # replies vs direct search_projected on the same 32-row batches
        tape = Q[SERVER_CLOSED:]
        mismatch = off_scores = 0
        with counters.uncounted():
            for i in range(0, len(tape), BATCH):
                q = torch.as_tensor(tape[i:i + BATCH], device="cuda")
                pad = BATCH - q.shape[0]
                if pad:
                    q = torch.cat([q, q.new_zeros(pad, q.shape[1])])
                s, ids = index.search_projected(q, W, k=K, mean=mean)
                s, ids = s.cpu(), ids.cpu()
                for j, (rs, ri) in enumerate(res["results"][i:i + BATCH]):
                    if not np.array_equal(ri, ids[j].numpy()):
                        mismatch += 1
                    if not np.allclose(rs, s[j].numpy(), rtol=TOL, atol=TOL):
                        off_scores += 1
        if mismatch or off_scores:
            raise AssertionError(f"server {name}: {mismatch} replies' ids and "
                                 f"{off_scores} replies' scores differ from "
                                 f"direct search_projected")
        emit("server", index=name, pipeline_depth=3, batch=BATCH, k=K,
             closed_loop=closed, open_loop=opened, replies_checked=len(tape))


def plain_search(pg, q, k):
    """``pg``'s search through the plain paged version: each device run over
    the tiers in place, each host run as one stack of its pages on the
    card, chained through the carry as the index chains them."""
    import torch
    from repro_torch.kernels.topk_score import topk_score_paged_plain
    st = pg.storage
    runs = pg._runs()
    out = None
    for i, (lo, hi, on_dev) in enumerate(runs):
        fin = i == len(runs) - 1
        if on_dev:
            out = topk_score_paged_plain(
                st.pool, st.page_table, st.page_nvalid, st.page_offset, lo, hi, q,
                k=k, tail=st.tail, page_scale=st.page_scale, carry=out, finalize=fin)
        else:
            dev = q.device
            pages = torch.stack([st.host_pages[s] for s in range(lo, hi)]).to(dev)
            n = hi - lo
            out = topk_score_paged_plain(
                pages, torch.arange(n, dtype=torch.int32, device=dev),
                torch.as_tensor(st.nvalid_host[lo:hi], device=dev),
                torch.as_tensor(st.offset_host[lo:hi], device=dev), 0, n, q, k=k,
                page_scale=(None if st.scale_host is None
                            else torch.as_tensor(st.scale_host[lo:hi], device=dev)),
                carry=out, finalize=fin)
    return out


def phase_paged(counters, index_f32, index_int8, pruner, Q, rows):
    """Phase 7: the full-size f32 and int8 indexes paged (256-row pages),
    searched against the dense index, taken through a lifecycle (appends
    with a widening block, promote, compact, evict to pinned host memory)
    and served by a depth-3 server that swaps those versions in under
    load. Returns the int8 server's reply count."""
    import threading
    import numpy as np
    import torch
    from repro_torch.core.index import (DenseIndex, _project_nofold, _topk_merge,
                                        project_queries)
    from repro_torch.core.paged import PagedIndex
    from repro_torch.kernels import topk_score
    from repro_torch.launch.serve import RetrievalServer, _drive, _drive_open, _lat_summary

    dev = torch.device("cuda")
    W, mean = pruner.projection()
    Qs = torch.as_tensor(Q[:SEARCH_BATCHES * BATCH], device=dev)
    batches = [Qs[i:i + BATCH] for i in range(0, len(Qs), BATCH)]
    t0 = time.perf_counter()
    paged = {name: PagedIndex.from_index(index, page_rows=PAGE_ROWS, depth=3,
                                         wave_pages=WAVE_PAGES)
             for name, index in (("f32", index_f32), ("int8", index_int8))}
    torch.cuda.synchronize()
    emit("paged_build", seconds=time.perf_counter() - t0, page_rows=PAGE_ROWS,
         pages={k: v.total_pages for k, v in paged.items()},
         pool_gb={k: v.nbytes / 1e9 for k, v in paged.items()},
         allocated_gb=torch.cuda.memory_allocated() / 1e9)

    # (a) paged search against the dense index on the same contents
    for name, index in (("f32", index_f32), ("int8", index_int8)):
        pg = paged[name]
        pg.search_projected(batches[0], W, k=K, mean=mean)     # first launches load
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [pg.search_projected(b, W, k=K, mean=mean) for b in batches]
        torch.cuda.synchronize()
        t_paged = time.perf_counter() - t0
        with counters.uncounted():
            t0 = time.perf_counter()
            want = [index.search_projected(b, W, k=K, mean=mean) for b in batches]
            torch.cuda.synchronize()
            t_dense = time.perf_counter() - t0
            bitwise = all(torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
                          for g, w in zip(got, want))
            worst = max(compare_topk(*w, *g, f"paged {name} vs dense")[0]
                        for g, w in zip(got, want))
            if not bitwise:
                raise AssertionError(f"paged {name}: not bitwise equal to the dense "
                                     f"index (max abs err {worst})")
            # deeper k: the radix select path, paged and dense alike
            for kk in (100, 1000, 2000):
                gp = pg.search_projected(batches[0], W, k=kk, mean=mean)
                gd = index.search_projected(batches[0], W, k=kk, mean=mean)
                if not (torch.equal(gp[0], gd[0]) and torch.equal(gp[1], gd[1])):
                    raise AssertionError(f"paged {name}: not bitwise equal to the dense "
                                         f"index at k = {kk}")
            del gp, gd
            # the kernel against its plain version and the timings, at the
            # shapes of this path
            st = pg.storage
            q = _project_nofold(batches[0], W, mean).contiguous()
            args = (st.pool, st.page_table, st.page_nvalid, st.page_offset, 0,
                    st.n_slots, q)
            kw = dict(k=K, tail=st.tail, page_scale=st.page_scale)
            before = dict(topk_score.topk_score_paged_cuda.cuda_launches)
            g1 = topk_score.topk_score_paged_cuda(*args, **kw)
            per_call = sum(topk_score.topk_score_paged_cuda.cuda_launches.values()) \
                - sum(before.values())
            w1 = topk_score.topk_score_paged_plain(*args, **kw)
            err, eq, near = compare_topk(*w1, *g1, f"paged {name} kernel vs plain")
            qd = project_queries(batches[0], W, scale=index.scale, mean=mean).contiguous()
            item = st.pool.element_size()
            npages, R, m = st.n_slots, st.page_rows, st.dim
            scale_bytes = 0 if st.page_scale is None else 4 * npages * m
            rows[f"topk_score_paged_{name}"] = dict(
                shape=[index.n, m, BATCH, K], page_rows=R, pages=npages, store=name,
                max_abs_err=err, ids_equal=eq, near_ties=near,
                cuda_launches_per_call=per_call,
                ms=cuda_ms(lambda: topk_score.topk_score_paged_cuda(*args, **kw), reps=10),
                plain_ms=cuda_ms(lambda: topk_score.topk_score_paged_plain(*args, **kw),
                                 reps=2),
                dense_ms=cuda_ms(lambda: topk_score.topk_score_cuda(index.vectors, qd, k=K),
                                 reps=10),
                library_ms=None,
                matmul_topk_ms=(cuda_ms(lambda: torch.topk(qd @ index.vectors.T, K), reps=2)
                                if item == 4 else None),
                bound=bound(item * npages * R * m + 12 * npages + scale_bytes
                            + 4 * BATCH * m + 8 * BATCH * K, 2 * BATCH * npages * R * m))
            for kk in (2000, 10000):
                before = sum(topk_score.topk_score_paged_cuda.cuda_launches.values())
                g1 = topk_score.topk_score_paged_cuda(*args, **{**kw, "k": kk})
                per = sum(topk_score.topk_score_paged_cuda.cuda_launches.values()) - before
                w1 = topk_score.topk_score_paged_plain(*args, **{**kw, "k": kk})
                e2, eq2, near2 = compare_topk(*w1, *g1, f"paged {name} kernel vs plain k={kk}")
                del g1, w1
                rows[f"topk_score_paged_{name}_k{kk}"] = dict(
                    shape=[index.n, m, BATCH, kk], page_rows=R, pages=npages, store=name,
                    max_abs_err=e2, ids_equal=eq2, near_ties=near2, launches_per_call=per,
                    ms=cuda_ms(lambda: topk_score.topk_score_paged_cuda(*args, **{**kw, "k": kk}),
                               reps=3),
                    plain_ms=cuda_ms(lambda: topk_score.topk_score_paged_plain(
                        *args, **{**kw, "k": kk}), reps=1),
                    dense_ms=cuda_ms(lambda: topk_score.topk_score_cuda(index.vectors, qd, k=kk),
                                     reps=3),
                    library_ms=None,
                    bound=bound(item * npages * R * m + 12 * npages + scale_bytes
                                + 4 * BATCH * m + 8 * BATCH * kk, 2 * BATCH * npages * R * m))
        emit("paged_search", index=name, batches=len(batches), bitwise_vs_dense=bitwise,
             max_abs_err_vs_dense=worst, paged_s=t_paged, dense_s=t_dense,
             kernel_vs_plain=dict(max_abs_err=err, ids_equal=eq, near_ties=near))

    # (b) the lifecycle, each step against the plain version; promote,
    # compact and evict must leave results bitwise unchanged
    g = torch.Generator(device=dev).manual_seed(3)
    src = index_f32.vectors

    def new_rows(n, mag=1.0):
        pick = torch.randint(0, src.shape[0], (n,), generator=g, device=dev)
        r = src[pick] + 0.01 * torch.randn(n, src.shape[1], generator=g, device=dev)
        return (mag * r).cpu().numpy()

    blocks = [new_rows(300), new_rows(200, 9.0), new_rows(5000)]
    qb = batches[0]
    qn = _project_nofold(qb, W, mean).contiguous()
    versions = {}
    for name in ("f32", "int8"):
        pg = paged[name]
        steps = {}

        def check(step, pg=pg):
            got = pg.search_projected(qb, W, k=K, mean=mean)
            with counters.uncounted():
                want = plain_search(pg, qn, K)
            err, eq, near = compare_topk(*want, *got, f"paged {name} lifecycle {step}")
            steps[step] = dict(max_abs_err=err, ids_equal=eq, near_ties=near,
                               pages=pg.total_pages, delta_pages=pg.delta_pages,
                               host_pages=pg.storage.n_host_pages)
            return got

        widened = 0
        for i, bl in enumerate(blocks):
            t0 = time.perf_counter()
            pg, ops_ = pg.append_with_ops(bl)
            steps[f"append_{i}_s"] = time.perf_counter() - t0
            widened += sum(op[0] == "widen" for op in ops_)
            check(f"append_{i}", pg)
        ref = check("appended", pg)
        if name == "f32":
            # an answer that does not read the paged metadata: the dense base
            # and a dense index over the appended rows, ids offset by n
            with counters.uncounted():
                extra = DenseIndex(torch.as_tensor(np.concatenate(blocks), device=dev))
                bs, bi = index_f32.search_projected(qb, W, k=K, mean=mean)
                es, ei = extra.search_projected(qb, W, k=K, mean=mean)
                want = _topk_merge(torch.cat([bs, es], 1),
                                   torch.cat([bi, ei + index_f32.n], 1), K)
            err, eq, near = compare_topk(*want, *ref, "paged f32 appended vs dense")
            steps["appended_vs_dense"] = dict(max_abs_err=err, ids_equal=eq,
                                              near_ties=near)
            del extra
        if pg.quantized and not widened:
            raise AssertionError("paged int8: the x9 block did not widen a scale")
        v_append = pg
        for step, fn in (("promote", lambda p: p.promote()),
                         ("compact", lambda p: p.compact_pages()),
                         ("evict", lambda p: p.evict(EVICT_PAGES))):
            t0 = time.perf_counter()
            pg, info = fn(pg)
            torch.cuda.synchronize()
            steps[f"{step}_s"] = time.perf_counter() - t0
            steps[f"{step}_info"] = info
            got = check(step, pg)
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError(f"paged {name}: {step} changed the results")
            if step == "compact":
                v_compact = pg
        # the oversubscribed search: host pages stream in waves; the host's
        # share (gathering waves into pinned buffers, queueing the copies)
        # is timed apart
        stage_s = [0.0]
        stage = PagedIndex._stage_wave

        def timed_stage(self, slots, buf):
            t = time.perf_counter()
            try:
                return stage(self, slots, buf)
            finally:
                stage_s[0] += time.perf_counter() - t

        PagedIndex._stage_wave = timed_stage
        try:
            t0 = time.perf_counter()
            for b in batches:
                pg.search_projected(b, W, k=K, mean=mean)
            torch.cuda.synchronize()
            t_over = time.perf_counter() - t0
        finally:
            PagedIndex._stage_wave = stage
        st = pg.storage
        h2d = st.n_host_pages * (st.page_rows * st.dim * st.pool.element_size()
                                 + 8 + (0 if st.scale_host is None else 4 * st.dim))
        emit("paged_lifecycle", index=name, steps=steps, extents=len(st.extents),
             widen_ops=widened, host_pages=st.n_host_pages,
             oversubscribed_ms_per_batch=t_over / len(batches) * 1e3,
             wave_staging_ms_per_batch=stage_s[0] / len(batches) * 1e3,
             h2d_bytes_per_batch=h2d, waves_per_batch=-(-st.n_host_pages // WAVE_PAGES))
        if name == "int8":
            versions = dict(append=v_append, compact=v_compact, evict=pg)
        del pg, v_append, v_compact, st
        torch.cuda.empty_cache()

    # (c) a depth-3 server over the paged int8 index: closed loop, then open
    # loop while swap_index installs the append, the compaction and the
    # eviction; a background client keeps traffic on across the swaps
    v0 = paged["int8"]
    server = RetrievalServer(v0, pruner, k=K, max_batch=BATCH, pipeline_depth=3)
    tape = Q[SERVER_CLOSED:]
    segs = np.array_split(tape, 4)
    bg = dict(ok=0, failed=[])
    stop = threading.Event()

    def background():
        i = 0
        while not stop.is_set():
            try:
                server.query(Q[i % SERVER_CLOSED], timeout=60.0)
                bg["ok"] += 1
            except Exception as e:  # noqa: BLE001 — counted and reported
                bg["failed"].append(repr(e))
            i += 1

    out = {}
    try:
        server.warmup()
        wall, lat = _drive(server, Q[:SERVER_CLOSED])
        out["closed_loop"] = dict(qps=SERVER_CLOSED / wall, **_lat_summary(lat),
                                  **server.worker_stats())
        th = threading.Thread(target=background, daemon=True)
        th.start()
        served = []
        for name, v, seg in zip(("base", "append", "compact", "evict"),
                                (v0, versions["append"], versions["compact"],
                                 versions["evict"]), segs):
            if v is not v0:
                server.swap_index(v)
            res = _drive_open(server, seg, rate=2000.0, collect=True)
            if res["errors"] or res["n_ok"] != len(seg):
                raise AssertionError(f"paged server {name}: {res['errors']} errors, "
                                     f"{res['n_ok']} of {len(seg)} replies")
            out[f"open_loop_{name}"] = {k: v_ for k, v_ in res.items() if k != "results"}
            out[f"open_loop_{name}"]["tape_qps"] = tape_qps(res["n"], 2000.0)
            served.append((name, v, seg, res["results"]))
        stop.set()
        th.join(timeout=120.0)
        if th.is_alive() or bg["failed"]:
            raise AssertionError(f"paged server background client: {bg['failed'][:3]}")
        out["swaps"] = server.swap_count
    finally:
        stop.set()
        server.close()
    mismatch = off_scores = checked = 0
    with counters.uncounted():
        for name, v, seg, results in served:
            for i in range(0, len(seg), BATCH):
                q = torch.as_tensor(seg[i:i + BATCH], device=dev)
                s, ids = v.search_projected(q, W, k=K, mean=mean)
                s, ids = s.cpu().numpy(), ids.cpu().numpy()
                for j, (rs, ri) in enumerate(results[i:i + BATCH]):
                    checked += 1
                    mismatch += not np.array_equal(ri, ids[j])
                    off_scores += not np.allclose(rs, s[j], rtol=TOL, atol=TOL)
    if mismatch or off_scores:
        raise AssertionError(f"paged server: {mismatch} replies' ids and {off_scores} "
                             f"replies' scores differ from direct search_projected")
    emit("paged_server", index="int8", pipeline_depth=3, batch=BATCH, k=K,
         background_replies=bg["ok"], replies_checked=checked, **out)


def wall_ms(fn, reps=10):
    """Mean host time of ``fn`` (host work and device work both: it ends in
    a synchronise) over ``reps`` calls after one warmup."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_live(counters, index_f32, index_int8, pruner, Q, fresh, rows):
    """Phase 8: the live index at full width. (a) both indexes wrapped as
    SegmentedIndex and grown by 10,000 documents in 64-row add_documents
    blocks (one x9, so an int8 delta widens), searched at k = 10 and 1000;
    (b) PagedIndex.from_segmented of both; (c) an IndexUpdater behind a
    depth-3 server under appends and queries, then compact_async under that
    traffic; (d) a paged IndexUpdater: appends with a widen, then compact."""
    import gc
    import threading
    import numpy as np
    import torch
    from repro_torch.core import IndexUpdater, SegmentedIndex
    from repro_torch.core.index import DenseIndex, _project_nofold, _topk_merge
    from repro_torch.core.paged import PagedIndex
    from repro_torch.kernels import pca_project, topk_score
    from repro_torch.launch.serve import RetrievalServer, _drive, _drive_open, _lat_summary

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    W, mean = pruner.projection()
    Qs = torch.as_tensor(Q[:SEARCH_BATCHES * BATCH], device=dev)
    batches = [Qs[i:i + BATCH] for i in range(0, len(Qs), BATCH)]
    qn = [_project_nofold(b, W, mean).contiguous() for b in batches]
    n = index_f32.n
    emit("live_start", allocated_gb=torch.cuda.memory_allocated() / 1e9)

    def block(i, hi=None):
        """New documents [i, i + 64) of the fresh pool (cut at ``hi``), x9
        for the block that must widen an int8 scale."""
        j = i % LIVE_DOCS
        blk = fresh[j:j + min(APPEND_BLOCK, (hi or i + APPEND_BLOCK) - i)]
        return blk * 9.0 if i == WIDEN_AT else blk

    def open_scale(idx):
        if isinstance(idx, SegmentedIndex):
            return idx.deltas[-1].scale.cpu()
        return torch.as_tensor(idx.storage.extents[-1].scale)

    def widen_checked(up, i, hi):
        """add_documents of block i; returns its seconds. Across the x9
        block an int8 index's open delta must widen its scale."""
        widen = i == WIDEN_AT and up.index.quantized
        before = open_scale(up.index) if widen else None
        t0 = time.perf_counter()
        up.add_documents(block(i, hi))
        dt = time.perf_counter() - t0
        if widen and torch.equal(before, open_scale(up.index)):
            raise AssertionError("live int8: the x9 block did not widen a scale")
        return dt

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def f32_rows(index, tails=(), n_rows=None):
        """One f32 buffer of ``n_rows``: an int8 index dequantised in 2^20-row
        blocks (an f32 multiply each), then the ``tails`` tensors in order."""
        n_rows = n_rows or index.n + sum(t.shape[0] for t in tails)
        out = torch.empty((n_rows, index.dim), device=dev)
        for i in range(0, index.n, 1 << 20):
            blk = index.vectors[i:i + (1 << 20)]
            out[i:i + blk.shape[0]] = blk.float() * index.scale[None, :]
        pos = index.n
        for t in tails:
            take = min(t.shape[0], n_rows - pos)
            out[pos:pos + take] = t[:take]
            pos += take
        return out

    # (a) appends through IndexUpdater.add_documents, searches vs oracles
    segs, out = {}, {}
    for name, index in (("f32", index_f32), ("int8", index_int8)):
        up = IndexUpdater(pruner=pruner, index=index, delta_capacity=DELTA_CAPACITY)
        t_add, versions = [], {0: up.index}
        for i in range(0, LIVE_APPEND, APPEND_BLOCK):
            t_add.append(widen_checked(up, i, LIVE_APPEND))
            versions.setdefault(len(up.index.deltas), up.index)
        seg = segs[name] = up.index
        if [d.n_real for d in seg.deltas] != LIVE_DELTAS:
            raise AssertionError(f"live {name}: deltas {[d.n_real for d in seg.deltas]}")
        res = {k: [seg.search_projected(b, W, k=k, mean=mean) for b in batches]
               for k in (K, 1000)}
        with counters.uncounted():
            if name == "f32":
                # the fixed fmaf order makes the segmented search bitwise the
                # merge of a dense search of the base and one of the rows
                extra = DenseIndex(torch.as_tensor(np.concatenate([d.raw for d in seg.deltas]),
                                                   device=dev))
                for k, got in res.items():
                    for b, g in zip(batches, got):
                        bs, bi = index.search_projected(b, W, k=k, mean=mean)
                        es, ei = extra.search_projected(b, W, k=k, mean=mean)
                        if not same(g, _topk_merge(torch.cat([bs, es], 1),
                                                   torch.cat([bi, ei + n], 1), k)):
                            raise AssertionError(f"live f32 k={k}: not bitwise the "
                                                 f"merged dense search")
                check = dict(bitwise_vs_merged_dense=True)
                del extra
            else:
                # mixed scales: the f32 search over each segment's dequantised rows
                deq = DenseIndex(f32_rows(index))
                dq = DenseIndex(torch.cat([d.vectors[:d.n_real].float() * d.scale[None, :]
                                           for d in seg.deltas]))
                worst = near = 0
                for k, got in res.items():
                    for q, g in zip(qn, got):
                        bs, bi = deq.search(q, k=k)
                        es, ei = dq.search(q, k=k)
                        want = _topk_merge(torch.cat([bs, es], 1),
                                           torch.cat([bi, ei + n], 1), k)
                        e, _, nt = compare_topk(*want, *g, f"live int8 k={k} vs f32 oracle")
                        worst, near = max(worst, e), near + nt
                check = dict(max_abs_err_vs_f32_oracle=worst, near_ties=near)
                del deq, dq
            # each delta's top-k against its plain version
            for d in seg.deltas:
                qf = (qn[0] * d.scale[None, :] if d.scale is not None else qn[0]).contiguous()
                for k in (K, 1000):
                    compare_topk(*topk_score.topk_score_plain(d.vectors, qf, k=k,
                                                              n_valid=d.n_real),
                                 *topk_score.topk_score_cuda(d.vectors, qf, k=k,
                                                             n_valid=d.n_real),
                                 f"live {name} delta n_valid={d.n_real} k={k}")
            # a batch at 0, 1 and 3 deltas against the dense index
            batch_ms = {f"deltas_{len(v.deltas)}": wall_ms(
                lambda v=v: v.search_projected(batches[0], W, k=K, mean=mean), reps=20)
                for nd, v in versions.items() if nd in (0, 1, 3)}
            batch_ms["dense"] = wall_ms(
                lambda: index.search_projected(batches[0], W, k=K, mean=mean), reps=20)
            # the open delta's kernel at its shape (n = 4,096, n_valid below)
            d = seg.deltas[-1]
            qf = (qn[0] * d.scale[None, :] if d.scale is not None else qn[0]).contiguous()
            got = topk_score.topk_score_cuda(d.vectors, qf, k=K, n_valid=d.n_real)
            err, eq, nt = compare_topk(*topk_score.topk_score_plain(
                d.vectors, qf, k=K, n_valid=d.n_real), *got, f"live {name} delta row")
            live_rows = d.vectors[:d.n_real]
            item = d.vectors.element_size()
            rows[f"topk_score_delta_{name}"] = dict(
                shape=[d.capacity, d.dim, BATCH, K], n_valid=d.n_real, store=name,
                max_abs_err=err, ids_equal=eq, near_ties=nt,
                ms=cuda_ms(lambda: topk_score.topk_score_cuda(d.vectors, qf, k=K,
                                                              n_valid=d.n_real), reps=50),
                enqueue_ms=enqueue_ms(lambda: topk_score.topk_score_cuda(
                    d.vectors, qf, k=K, n_valid=d.n_real)),
                plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(
                    d.vectors, qf, k=K, n_valid=d.n_real), reps=50),
                library_ms=cuda_ms(lambda: torch.topk(qf @ live_rows.float().T, K), reps=50),
                bound=bound(item * d.n_real * d.dim + 4 * BATCH * d.dim + 8 * BATCH * K,
                            2 * BATCH * d.n_real * d.dim))
        out[name] = dict(deltas=[d.n_real for d in seg.deltas],
                         add_documents_ms_median=float(np.median(t_add) * 1e3),
                         add_documents_ms_p90=float(np.percentile(t_add, 90) * 1e3),
                         batch_ms=batch_ms, per_delta_ms=(batch_ms["deltas_3"]
                                                          - batch_ms["deltas_0"]) / 3,
                         **check)
        del versions
    emit("live_segmented", appended=LIVE_APPEND, block=APPEND_BLOCK,
         delta_capacity=DELTA_CAPACITY, k=[K, 1000], batches=len(batches), **out)
    # pca_project at the append block's shape
    with counters.uncounted():
        Wc = W.contiguous()
        blk = fresh[:APPEND_BLOCK].contiguous()
        p1 = pca_project.pca_project_cuda(blk, Wc)
        p_err = float((p1 - pca_project.pca_project_plain(blk, Wc)).abs().max())
        if p_err > 1e-4:
            raise AssertionError(f"pca_project n=64: error {p_err}")
        d_, m_ = Wc.shape
        rows["pca_project_n64"] = dict(
            shape=[APPEND_BLOCK, d_, m_], max_abs_err=p_err,
            ms=cuda_ms(lambda: pca_project.pca_project_cuda(blk, Wc), reps=50),
            enqueue_ms=enqueue_ms(lambda: pca_project.pca_project_cuda(blk, Wc)),
            plain_ms=cuda_ms(lambda: pca_project.pca_project_plain(blk, Wc), reps=50),
            library_ms=cuda_ms(lambda: torch.matmul(blk, Wc), reps=50),
            bound=bound(4 * APPEND_BLOCK * d_ + 4 * d_ * m_ + 4 * APPEND_BLOCK * m_,
                        2 * APPEND_BLOCK * d_ * m_))

    # (b) the live indexes paged, byte for byte
    for name, seg in segs.items():
        t0 = time.perf_counter()
        pg = PagedIndex.from_segmented(seg, page_rows=PAGE_ROWS)
        torch.cuda.synchronize()
        t_page = time.perf_counter() - t0
        for k in (K, 1000):
            for b in batches:
                if not same(pg.search_projected(b, W, k=k, mean=mean),
                            seg.search_projected(b, W, k=k, mean=mean)):
                    raise AssertionError(f"from_segmented {name} k={k}: not bitwise "
                                         f"the segmented search")
        emit("live_from_segmented", index=name, seconds=t_page, pages=pg.total_pages,
             delta_pages=pg.delta_pages, bitwise_vs_segmented=True)
        del pg
    del segs["f32"]
    torch.cuda.empty_cache()

    # (c) an updater behind a depth-3 server: appends at LIVE_RATE rows/s
    # during a closed and an open loop, then compact_async under that traffic
    seg0 = segs.pop("int8")
    server = RetrievalServer(seg0, pruner, k=K, max_batch=BATCH, pipeline_depth=3)
    up = IndexUpdater(pruner=pruner, index=seg0, server=server,
                      delta_capacity=DELTA_CAPACITY)
    stop_app, stop_bg = threading.Event(), threading.Event()
    appended, t_add, bg = [], [], dict(ok=0, failed=[])

    def appender():
        i = LIVE_APPEND
        while not stop_app.is_set():
            blk = block(i)
            t0 = time.perf_counter()
            up.add_documents(blk)
            dt = time.perf_counter() - t0
            appended.append(blk)
            t_add.append(dt)
            i += APPEND_BLOCK
            stop_app.wait(max(0.0, APPEND_BLOCK / LIVE_RATE - dt))

    def background():
        i = 0
        while not stop_bg.is_set():
            try:
                server.query(Q[i % SERVER_CLOSED], timeout=60.0)
                bg["ok"] += 1
            except Exception as e:  # noqa: BLE001 — counted and reported
                bg["failed"].append(repr(e))
            i += 1

    def settled(cond, timeout=60.0):
        t_end = time.perf_counter() + timeout
        while not cond():
            if time.perf_counter() > t_end or bg["failed"]:
                raise AssertionError(f"live server background client: {bg['failed'][:3]}")
            time.sleep(0.01)

    res_out = {}
    app = threading.Thread(target=appender, daemon=True)
    th_bg = threading.Thread(target=background, daemon=True)
    try:
        server.warmup()
        app.start()
        wall, lat = _drive(server, Q[:SERVER_CLOSED])
        res_out["closed_loop"] = dict(qps=SERVER_CLOSED / wall, **_lat_summary(lat),
                                      **server.worker_stats())
        res = _drive_open(server, Q[SERVER_CLOSED:], rate=2000.0)
        if res["errors"] or res["n_ok"] != res["n"]:
            raise AssertionError(f"live server: {res['errors']} errors, "
                                 f"{res['n_ok']} of {res['n']} replies")
        res_out["open_loop"] = dict(res, tape_qps=tape_qps(res["n"], 2000.0),
                                    **server.worker_stats())
        th_bg.start()
        settled(lambda: bg["ok"] >= 20)           # traffic flows before the compaction
        swaps0 = server.swap_count
        t0 = time.perf_counter()
        th = up.compact_async()
        th.join(timeout=300.0)
        t_compact = time.perf_counter() - t0
        if th.is_alive():
            raise AssertionError("live compaction did not finish")
        ok0 = bg["ok"]
        settled(lambda: bg["ok"] >= ok0 + 20)     # ... and after its swap
        stop_app.set()
        app.join(timeout=60.0)
        stop_bg.set()
        th_bg.join(timeout=120.0)
        if app.is_alive() or th_bg.is_alive() or bg["failed"]:
            raise AssertionError(f"live server clients: {bg['failed'][:3]}")
        health = up.health()
        if server.error is not None or not health["ok"] or up.compactions != 1:
            raise AssertionError(f"live server: error {server.error!r}, health {health}")
        final = up.index
        swaps = server.swap_count
        # replies after the last swap equal a direct search of the final index
        tape = Q[SERVER_CLOSED:SERVER_CLOSED + 256]
        res = _drive_open(server, tape, rate=2000.0, collect=True)
        if server.swap_count != swaps or res["errors"] or res["n_ok"] != len(tape):
            raise AssertionError("live server: replies lost or a swap after the last one")
    finally:
        stop_app.set()
        stop_bg.set()
        server.close()
    mismatch = off_scores = 0
    with counters.uncounted():
        for i in range(0, len(tape), BATCH):
            s_, ids = final.search_projected(torch.as_tensor(tape[i:i + BATCH], device=dev),
                                             W, k=K, mean=mean)
            s_, ids = s_.cpu().numpy(), ids.cpu().numpy()
            for j, (rs, ri) in enumerate(res["results"][i:i + BATCH]):
                mismatch += not np.array_equal(ri, ids[j])
                off_scores += not np.allclose(rs, s_[j], rtol=TOL, atol=TOL)
        if mismatch or off_scores:
            raise AssertionError(f"live server: {mismatch} replies' ids and {off_scores} "
                                 f"replies' scores differ from the final index")
        # the compacted base, rebuilt once more: the dequantised base, the
        # deltas' staging and every append pruned again, cut at the base's n
        nb = final.base.n
        tails = [torch.as_tensor(d.raw, device=dev) for d in seg0.deltas]
        tails += [pruner.prune_index(b) for b in appended]
        want = DenseIndex.build(f32_rows(index_int8, tails, nb), quantize_int8=True)
        if not (torch.equal(want.vectors, final.base.vectors)
                and torch.equal(want.scale, final.base.scale)):
            raise AssertionError("live compaction: the base is not bitwise its rebuild")
        if final.n != n + LIVE_APPEND + sum(b.shape[0] for b in appended):
            raise AssertionError(f"live server: {final.n} rows after the appends")
        del want
    emit("live_server", index="int8", pipeline_depth=3, batch=BATCH, k=K,
         append_rate=LIVE_RATE, appended_rows=up.appended_rows, swaps=swaps,
         swaps_during_compaction=swaps - swaps0,
         add_documents_ms_median=float(np.median(t_add) * 1e3),
         add_documents_ms_p90=float(np.percentile(t_add, 90) * 1e3),
         compact_s=t_compact, last_compaction=up.last_compaction,
         deltas_after=[d.n_real for d in final.deltas], background_replies=bg["ok"],
         replies_checked=len(tape), compacted_base_bitwise_rebuild=True,
         health_ok=health["ok"], **res_out)
    del server, up, final, seg0
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a paged updater over the same base: appends (one widens), then
    # compact by pointer swaps; each step against the plain version
    pg = PagedIndex.from_index(index_int8, page_rows=PAGE_ROWS, seal_rows=DELTA_CAPACITY,
                               depth=3, wave_pages=WAVE_PAGES)
    up = IndexUpdater(pruner=pruner, index=pg, delta_capacity=DELTA_CAPACITY)
    t_add, steps = [], {}

    def check(step):
        got = up.index.search_projected(batches[0], W, k=K, mean=mean)
        with counters.uncounted():
            want = plain_search(up.index, qn[0], K)
        err, eq, nt = compare_topk(*want, *got, f"live paged {step}")
        steps[step] = dict(max_abs_err=err, ids_equal=eq, near_ties=nt,
                           delta_pages=up.index.delta_pages)
        return got

    for i in range(WIDEN_AT - PAGED_APPEND // 2, WIDEN_AT + PAGED_APPEND // 2, APPEND_BLOCK):
        t_add.append(widen_checked(up, i, None))
    ref = check("appended")
    t0 = time.perf_counter()
    up.compact()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    got = check("compacted")
    if not same(got, ref):
        raise AssertionError("live paged: compact changed the results")
    emit("live_paged", appended=PAGED_APPEND, block=APPEND_BLOCK,
         add_documents_ms_median=float(np.median(t_add) * 1e3),
         add_documents_ms_p90=float(np.percentile(t_add, 90) * 1e3),
         compact_s=t_compact, last_compaction=up.last_compaction, steps=steps,
         peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del up, pg


def phase_store(counters, index_f32, index_int8, pruner, Q, fresh, n_docs, protocol_docs):
    """Phase 9: the durable artifact at full width, under build/store_smoke/.
    (a) the full-corpus int8 build (build_index_to over card-resident blocks
    of the regenerated corpus) bitwise equal to phase 4's int8 index; (b)
    the fit inside the build (gram) at the protocol size against the CPU
    build; (c) the cold start from (a)'s artifact, page cache cold and
    warm, against a pinned host-to-device copy; (e) durable appends through
    IndexUpdater.from_store, the reload, and the store-backed compact
    against the store-less one; (d) the f32 round trip; (f) a paged store
    with host-tier pages. Each artifact is removed when its checks are
    done; each step prints one line with the bytes it wrote and the free
    disk."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.core import IndexStore, IndexUpdater, SegmentedIndex, save_index
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.paged import PagedIndex
    from repro_torch.core.pruning import StaticPruner
    from repro_torch.data.synthetic import corpus_on_device
    from repro_torch.launch.serve import RetrievalServer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    root = os.path.join(HERE, "build", "store_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    W, mean = pruner.projection()
    m = pruner.kept_dims
    n = index_int8.n
    Qs = torch.as_tensor(Q[:SEARCH_BATCHES * BATCH], device=dev)
    batches = [Qs[i:i + BATCH] for i in range(0, len(Qs), BATCH)]
    summary = {}

    def du(path):
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(path) for f in fs)

    def step(name, written, **fields):
        emit("store", step=name, bytes_written=int(written),
             disk_free_gb=shutil.disk_usage(root).free / 1e9, **fields)

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def searches_equal(got, want, what):
        for k in (K, 1000):
            for b in batches:
                if not same(got.search_projected(b, W, k=k, mean=mean),
                            want.search_projected(b, W, k=k, mean=mean)):
                    raise AssertionError(f"store {what}: search at k={k} not bitwise equal")

    def block(i):
        """Documents [i, i + 64) of phase 4's fresh pool, x9 for the block
        that must widen an int8 delta scale."""
        j = i % LIVE_DOCS
        blk = fresh[j:j + APPEND_BLOCK]
        return blk * 9.0 if i == WIDEN_AT else blk

    # (a) the full-corpus int8 build from card-resident blocks
    t0 = time.perf_counter()
    D = corpus_on_device("tasb", n_docs=n_docs, d=DIM, seed=0, device=dev)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    with counters.uncounted():
        if not torch.equal(pruner.prune_index(D[:BUILD_BLOCK]),
                           index_f32.vectors[:BUILD_BLOCK]):
            raise AssertionError("store: the regenerated corpus is not phase 4's")
    path_a = os.path.join(root, "int8")
    free0 = shutil.disk_usage(root).free
    t0 = time.perf_counter()
    st = pruner.build_index_to(
        path_a, lambda: (D[i:i + BUILD_BLOCK] for i in range(0, n_docs, BUILD_BLOCK)),
        quantize_int8=True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    pos = 0
    for c in st.iter_chunks():
        got = torch.from_numpy(np.array(c)).to(dev)
        if not torch.equal(got, index_int8.vectors[pos:pos + c.shape[0]]):
            raise AssertionError(f"store (a): chunk at row {pos} differs from phase 4's int8")
        pos += c.shape[0]
    if pos != n or not np.array_equal(st.scale(), index_int8.scale.cpu().numpy()):
        raise AssertionError("store (a): rows or scale differ from phase 4's int8 index")
    # the host's (the reference's) arithmetic on the same f32 rows: numpy's
    # divide for the scale, then the first block quantised on the host
    absmax = index_f32.vectors.abs().amax(0).cpu().numpy()
    host_scale = np.maximum(absmax, np.float32(1e-12)) / np.float32(127.0)
    head = index_f32.vectors[:BUILD_BLOCK].cpu().numpy()
    host_q = np.clip(np.round(head / host_scale[None, :]), -127, 127).astype(np.int8)
    if not (np.array_equal(st.scale(), host_scale)
            and np.array_equal(host_q, np.asarray(next(st.iter_chunks())))):
        raise AssertionError("store (a): scale or bytes differ from the host's arithmetic")
    art_a = du(path_a)
    summary["build_s"] = t_build
    step("a_full_corpus_int8_build", art_a + st.meta["spill_bytes"], rows=n,
         blocks=-(-n_docs // BUILD_BLOCK), block_rows=BUILD_BLOCK, gen_s=t_gen,
         build_s=t_build, artifact_bytes=art_a, spill_bytes=st.meta["spill_bytes"],
         requant_blocks=st.meta["requant_blocks"], chunks=len(st.manifest["chunks"]),
         bitwise_vs_phase4_int8=True, scale_and_first_block_bitwise_vs_host=True,
         disk_free_before_gb=free0 / 1e9)

    # (b) the fit inside the build (fit_streaming -> gram) at the protocol
    # size, against the same build on the CPU from the same blocks
    Dp = D[:protocol_docs]
    blocks_dev = [Dp[i:i + FIT_BLOCK] for i in range(0, Dp.shape[0], FIT_BLOCK)]
    blocks_cpu = [b.cpu() for b in blocks_dev]
    t0 = time.perf_counter()
    sb = StaticPruner(cutoff=CUTOFF).build_index_to(os.path.join(root, "fit_card"),
                                                    blocks_dev, quantize_int8=True)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh = StaticPruner(cutoff=CUTOFF).build_index_to(os.path.join(root, "fit_cpu"),
                                                    blocks_cpu, quantize_int8=True,
                                                    device="cpu")
    t_cpu = time.perf_counter() - t0
    # the card's rotation carried to the CPU: the projection alone differs
    same_rot = StaticPruner(cutoff=CUTOFF)
    same_rot.state = sb.load_pca(device="cpu")
    ss = same_rot.build_index_to(os.path.join(root, "fit_cpu_same"), blocks_cpu,
                                 quantize_int8=True)
    pc, ph = sb.load_pca(device="cpu"), sh.load_pca(device="cpu")
    Wc, Wh = pc.components[:, :m], ph.components[:, :m]
    signs = torch.sign((Wc * Wh).sum(0))
    col_err = (Wc * signs[None, :] - Wh).abs().amax(0)
    # an fp32 eigensolver's column i is good to about eps * lambda_1 / gap_i
    # (gap_i to the nearest other eigenvalue); columns of a near-degenerate
    # pair are defined only up to a rotation within it, so "equal up to
    # sign" is held where that bound is small, and the kept subspace as a
    # whole through its projector
    lam = pc.eigenvalues.double()
    gaps = (lam[:-1] - lam[1:]).abs()
    near = torch.minimum(torch.cat([gaps[:1], gaps]), torch.cat([gaps, gaps[-1:]]))[:m]
    conditioned = (6e-8 * lam[0] / near.clamp_min(1e-30)) < 1e-4
    proj_err = float((Wc @ Wc.T - Wh @ Wh.T).abs().max())
    eig_err = float((pc.eigenvalues - ph.eigenvalues).abs().max() / pc.eigenvalues[0])
    rc = sb.read_rows(0, sb.n, device="cpu").int()
    d_same = (rc - ss.read_rows(0, ss.n, device="cpu").int()).abs()
    d_ind = (rc * signs.int()[None, :] - sh.read_rows(0, sh.n, device="cpu").int()).abs()
    fit = dict(rows=int(Dp.shape[0]), card_s=t_card, cpu_s=t_cpu,
               eigenvalues_max_rel_err=eig_err,
               kept_subspace_projector_max_abs_err=proj_err,
               conditioned_columns=int(conditioned.sum()),
               conditioned_max_abs_err_up_to_sign=(float(col_err[conditioned].max())
                                                   if bool(conditioned.any()) else 0.0),
               all_columns_max_abs_err_up_to_sign=float(col_err.max()),
               components_tol=COMP_TOL,
               same_rotation_max_diff=int(d_same.max()),
               same_rotation_frac_differ=float((d_same > 0).float().mean()),
               independent_max_diff=int(d_ind.max()),
               independent_frac_differ=float((d_ind > 0).float().mean()))
    written = sum(du(os.path.join(root, p)) for p in ("fit_card", "fit_cpu", "fit_cpu_same"))
    step("b_fit_inside_build", written, **fit)
    if (eig_err > 1e-5 or proj_err > COMP_TOL
            or fit["conditioned_max_abs_err_up_to_sign"] > COMP_TOL):
        raise AssertionError(f"store (b): the card's fit differs from the CPU's: {fit}")
    # the parity contract's int8 bar: the same rotation, projected by the
    # kernel and by the plain version. The independent fit's bytes follow
    # its rotation within near-degenerate pairs and are reported only
    if fit["same_rotation_max_diff"] > 1 or fit["same_rotation_frac_differ"] > 1e-3:
        raise AssertionError(f"store (b): same-rotation int8 bytes differ: {fit}")
    for p in ("fit_card", "fit_cpu", "fit_cpu_same"):
        shutil.rmtree(os.path.join(root, p))
    del D, Dp, blocks_dev, blocks_cpu, rc, d_same, d_ind, head
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the cold start from (a)'s artifact: open + validate, load, first
    # answered query through RetrievalServer; page cache dropped first
    def drop_page_cache(path):
        for f in os.listdir(path):
            fd = os.open(os.path.join(path, f), os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)

    def cold_start(cold):
        if cold:
            drop_page_cache(path_a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store = IndexStore.open(path_a)
        t1 = time.perf_counter()
        idx = DenseIndex.load(store)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        server = RetrievalServer(idx, store.load_pruner(), k=K, max_batch=BATCH,
                                 pipeline_depth=3)
        try:
            server.query(Q[0], timeout=600.0)
            t3 = time.perf_counter()
        finally:
            server.close()
        return idx, dict(open_validate_ms=(t1 - t0) * 1e3, load_ms=(t2 - t1) * 1e3,
                         first_query_ms=(t3 - t2) * 1e3, cold_start_ms=(t3 - t0) * 1e3,
                         load_gb_per_s=store.nbytes / (t2 - t1) / 1e9)

    can_drop = hasattr(os, "posix_fadvise")
    starts = {}
    if can_drop:
        loaded, starts["cold"] = cold_start(True)
        del loaded
    loaded, starts["warm"] = cold_start(False)
    searches_equal(loaded, index_int8, "(c) int8 reload")
    host = torch.empty(1 << 30, dtype=torch.uint8, pin_memory=True)
    dbuf = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    pinned_ms = cuda_ms(lambda: dbuf.copy_(host, non_blocking=True), reps=5)
    del host, dbuf, loaded
    summary["cold_start"] = starts
    summary["pinned_h2d_gb_per_s"] = (1 << 30) / pinned_ms / 1e6
    step("c_cold_start", 0, artifact_bytes=art_a, page_cache_dropped=can_drop,
         bitwise_k10_k1000=True, pinned_h2d_1gb_ms=pinned_ms,
         pinned_h2d_gb_per_s=summary["pinned_h2d_gb_per_s"], **starts)

    # (e) the live store: durable appends through IndexUpdater.from_store,
    # in turns with a store-less updater over the same base
    fsync_ms = []
    probe = os.path.join(root, "fsync_probe")
    for _ in range(20):
        with open(probe, "wb") as f:
            f.write(b"\0" * 4096)
            f.flush()
            t0 = time.perf_counter()
            os.fsync(f.fileno())
            fsync_ms.append((time.perf_counter() - t0) * 1e3)
    os.remove(probe)
    t0 = time.perf_counter()
    up = IndexUpdater.from_store(path_a, delta_capacity=DELTA_CAPACITY)
    torch.cuda.synchronize()
    t_from = time.perf_counter() - t0
    plain = IndexUpdater(pruner=pruner, index=index_int8, delta_capacity=DELTA_CAPACITY)
    t_dur, t_mem = [], []
    before = None
    for i in range(0, STORE_APPEND, APPEND_BLOCK):
        blk = block(i)[:STORE_APPEND - i]
        if i == WIDEN_AT:
            before = up.index.deltas[-1].scale.cpu()
        t0 = time.perf_counter()
        plain.add_documents(blk)
        t_mem.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        up.add_documents(blk)
        t_dur.append(time.perf_counter() - t0)
        if i == WIDEN_AT and torch.equal(before, up.index.deltas[-1].scale.cpu()):
            raise AssertionError("store (e): the x9 block did not widen a scale")
    if [d.n_real for d in up.index.deltas] != LIVE_DELTAS:
        raise AssertionError(f"store (e): deltas {[d.n_real for d in up.index.deltas]}")
    searches_equal(up.index, plain.index, "(e) durable vs store-less appends")
    reloaded = SegmentedIndex.load(path_a, delta_capacity=DELTA_CAPACITY)
    searches_equal(reloaded, up.index, "(e) SegmentedIndex.load of the live store")
    del reloaded
    twin = IndexUpdater(pruner=pruner, index=up.index, delta_capacity=DELTA_CAPACITY)
    t0 = time.perf_counter()
    twin.compact()
    torch.cuda.synchronize()
    t_plain_compact = time.perf_counter() - t0
    free_before = shutil.disk_usage(root).free
    t0 = time.perf_counter()
    up.compact()
    torch.cuda.synchronize()
    t_store_compact = time.perf_counter() - t0
    a, b = up.index.base, twin.index.base
    if not (torch.equal(a.vectors, b.vectors) and torch.equal(a.scale, b.scale)):
        raise AssertionError("store (e): store-backed compact differs from the store-less one")
    re = IndexStore.open(path_a)
    if re.n != n + STORE_APPEND or len(re.segments()) != 1:
        raise AssertionError(f"store (e): compacted artifact holds {re.n} rows")
    durable = dict(median_ms=float(np.median(t_dur) * 1e3),
                   p90_ms=float(np.percentile(t_dur, 90) * 1e3),
                   max_ms=float(np.max(t_dur) * 1e3))
    storeless = dict(median_ms=float(np.median(t_mem) * 1e3),
                     p90_ms=float(np.percentile(t_mem, 90) * 1e3))
    summary["durable_append"] = durable
    summary["storeless_append"] = storeless
    summary["store_compact_s"] = t_store_compact
    summary["storeless_compact_s"] = t_plain_compact
    step("e_live_store", du(path_a), from_store_s=t_from, appended=STORE_APPEND,
         block=APPEND_BLOCK, deltas=LIVE_DELTAS, durable_add_documents=durable,
         storeless_add_documents=storeless,
         fsync_4k_ms_median=float(np.median(fsync_ms)),
         reload_bitwise_k10_k1000=True, store_compact_s=t_store_compact,
         storeless_compact_s=t_plain_compact, compact_base_bitwise_storeless=True,
         compact_disk_used_gb=(free_before - shutil.disk_usage(root).free) / 1e9,
         compacted_rows=re.n)
    del up, plain, twin, a, b
    shutil.rmtree(path_a)
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the f32 round trip, at the largest row count the disk holds
    path_d = os.path.join(root, "f32")
    free = shutil.disk_usage(root).free
    rows_d = n if free >= 4 * m * n + DISK_MARGIN else \
        (free - DISK_MARGIN) // (4 * m) // BUILD_BLOCK * BUILD_BLOCK
    if rows_d < BUILD_BLOCK:
        raise AssertionError(f"store (d): {free / 1e9:.1f} GB free holds no f32 block")
    src = index_f32 if rows_d == n else DenseIndex(index_f32.vectors[:rows_d])
    t0 = time.perf_counter()
    st = save_index(path_d, src, pruner=pruner)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    ld = DenseIndex.load(st)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if not torch.equal(ld.vectors, src.vectors):
        raise AssertionError("store (d): f32 vectors differ after the round trip")
    searches_equal(ld, src, "(d) f32 round trip")
    step("d_f32_round_trip", du(path_d), rows=int(rows_d), cut=rows_d < n,
         full_rows=n, save_s=t_save, load_s=t_load,
         load_gb_per_s=st.nbytes / t_load / 1e9, bitwise=True)
    summary["f32_round_trip"] = dict(rows=int(rows_d), cut=rows_d < n, save_s=t_save,
                                     load_s=t_load)
    del ld, src
    shutil.rmtree(path_d)
    gc.collect()
    torch.cuda.empty_cache()

    # (f) a paged store: phase 7's int8 index with 2,048 host-tier pages,
    # a few appended blocks (one widens), saved and paged back
    path_f = os.path.join(root, "paged")
    npages = -(-n // PAGE_ROWS)
    pool = max(npages - EVICT_PAGES, npages // 2)
    pg = PagedIndex.from_index(index_int8, page_rows=PAGE_ROWS, pool_pages=pool,
                               seal_rows=DELTA_CAPACITY, depth=3, wave_pages=WAVE_PAGES)
    for i in range(WIDEN_AT - PAGED_STORE_APPEND // 2, WIDEN_AT + PAGED_STORE_APPEND // 2,
                   APPEND_BLOCK):
        pg = pg.append(pruner.prune_index(block(i)))
    t0 = time.perf_counter()
    pg.save(path_f, pruner=pruner)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    pl = PagedIndex.load(path_f, pool_pages=pool, depth=3, wave_pages=WAVE_PAGES)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    a, b = pg.storage, pl.storage
    if (b.n_host_pages != a.n_host_pages
            or [(e.kind, e.sealed, e.n_rows) for e in a.extents]
            != [(e.kind, e.sealed, e.n_rows) for e in b.extents]):
        raise AssertionError("store (f): paged geometry or lifecycle differs after the load")
    for ei, e in enumerate(a.extents):
        for lo in range(0, e.n_rows, BUILD_BLOCK):
            hi = min(lo + BUILD_BLOCK, e.n_rows)
            if not torch.equal(a.extent_rows(ei, lo, hi), b.extent_rows(ei, lo, hi)):
                raise AssertionError(f"store (f): extent {ei} rows [{lo}, {hi}) differ")
    searches_equal(pl, pg, "(f) paged reload")
    summary["paged"] = dict(save_s=t_save, load_s=t_load)
    step("f_paged_store", du(path_f), pages=npages, host_pages=a.n_host_pages,
         extents=len(a.extents), appended=PAGED_STORE_APPEND, save_s=t_save,
         load_s=t_load, bitwise_search_and_extent_rows=True)
    del pg, pl, a, b
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()
    emit("store_summary", peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         **summary)


def cascade_split(cas, qb, W, mean, k, keys=None):
    """One batch of ``cas`` timed whole and in its parts: projection,
    coarse scan (the list-mode chunk kernel and the select together for
    N·k > 32), shortlist, gather of the full rows, the ``row_ids`` rescore
    kernel; ``keys`` (the coarse scan's listed keys) times the select
    alone, so the list-mode scan is the coarse scan less it."""
    import torch
    from repro_torch.core.cascade import _shortlist
    from repro_torch.core.index import _project_nofold
    from repro_torch.kernels import ops, topk_score
    nk = min(cas.n_factor * k, cas.n)
    qf = _project_nofold(qb, W, mean)
    _, cids = cas.coarse_topk(qf, nk)
    uids = _shortlist(cids)
    full = cas.full
    q = (qf if full.scale is None else qf * full.scale[None, :]).contiguous()
    rows_ = full.vectors[uids.long().clamp_min(0)]
    out = dict(
        total_ms=cuda_ms(lambda: cas.search_projected(qb, W, k=k, mean=mean), reps=10),
        projection_ms=cuda_ms(lambda: _project_nofold(qb, W, mean), reps=20),
        coarse_ms=cuda_ms(lambda: cas.coarse_topk(qf, nk), reps=10),
        shortlist_ms=cuda_ms(lambda: _shortlist(cids), reps=20),
        gather_ms=cuda_ms(lambda: full.vectors[uids.long().clamp_min(0)], reps=20),
        rescore_ms=cuda_ms(lambda: ops.topk_score(rows_, q, k=k, row_ids=uids), reps=20),
        U=int((uids >= 0).sum()), nk=nk)
    if keys is not None:
        out["select_ms"] = cuda_ms(lambda: topk_score.topk_select_cuda(keys, nk), reps=5)
        out["list_scan_ms"] = out["coarse_ms"] - out["select_ms"]
    return out


def coarse_keys(coarse, qf):
    """The keys the list-mode chunk kernel writes for a coarse scan (each
    row's score and id, top bit flipped), for timing the select alone."""
    import torch
    from repro_torch.kernels import ref, topk_score
    qc = (qf[:, :coarse.dim] * coarse.scale[None, :]).contiguous()
    s = qc @ coarse.vectors.float().T
    ids = torch.arange(coarse.n, device=s.device, dtype=torch.int32).expand(s.shape[0], -1)
    return (ref._keys(s, ids) ^ topk_score._SIGN).contiguous()


def phase_cascade(counters, index_f32, index_int8, pruner, Q, fresh, rows):
    """Phase 10: the cascade at full width over phase 4's f32 pruned rows.
    (a) each kernel at the cascade's shapes against its plain version: the
    coarse int8 scan (m 64, k 80; m 128, k 160), the row_ids rescore on a
    real shortlist, the paged coarse scan; (b) the anchor, bitwise on a
    100,000-row prefix with N = ceil(n / k): dense, segmented with deltas
    and paged, f32 and int8; (c) recall@10 against the full f32 search and
    the batch time split at 64:8, 128:16 and 128:32, beside the
    single-resolution batch; (d) a segmented int8 cascade grown by 10,000
    rows in 64-row blocks while a depth-3 server serves it open loop, then
    paged and held bitwise to the segmented one, resident and with 2,048
    of the full side's pages on the host tier; (e) its store round trip,
    coarse deltas bitwise, segmented and paged."""
    import dataclasses
    import gc
    import shutil
    import threading
    import numpy as np
    import torch
    from repro_torch.core import CascadeIndex, save_index
    from repro_torch.core.cascade import _shortlist
    from repro_torch.core.index import _project_nofold
    from repro_torch.core.paged import PagedIndex
    from repro_torch.kernels import topk_score
    from repro_torch.launch.serve import RetrievalServer, _drive_open

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    W, mean = pruner.projection()
    pruned = index_f32.vectors
    n, m = pruned.shape
    Qs = torch.as_tensor(Q[:SEARCH_BATCHES * BATCH], device=dev)
    batches = [Qs[i:i + BATCH] for i in range(0, len(Qs), BATCH)]
    qb = batches[0]
    summary = {}

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    # the two configurations of 64:8: the full resolution f32 and int8
    t0 = time.perf_counter()
    cas_f32 = CascadeIndex.build(pruned, m_coarse=CASCADE_M, n_factor=CASCADE_N)
    cas_int8 = CascadeIndex.build(pruned, m_coarse=CASCADE_M, n_factor=CASCADE_N,
                                  quantize_int8=True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if not (cas_f32.full.vectors.data_ptr() == pruned.data_ptr()
            and torch.equal(cas_int8.full.vectors, index_int8.vectors)
            and torch.equal(cas_int8.full.scale, index_int8.scale)
            and torch.equal(cas_f32.coarse.vectors, cas_int8.coarse.vectors)):
        raise AssertionError("cascade build: the full sides are not phase 4's indexes")
    # one copy of each side: the int8 configuration shares phase 4's index
    cas_int8 = dataclasses.replace(cas_int8, full=index_int8, coarse=cas_f32.coarse)
    coarse64 = cas_f32.coarse
    # from_index on phase 4's int8 index: dequantised by an f32 multiply,
    # requantised with its own scale by a true division (held to numpy)
    cas_fi = CascadeIndex.from_index(index_int8, m_coarse=CASCADE_M, n_factor=CASCADE_N)
    deq = (index_int8.vectors[:, :CASCADE_M].cpu().numpy().astype(np.float32)
           * index_int8.scale[:CASCADE_M].cpu().numpy()[None, :])
    want_scale = (np.maximum(np.abs(deq).max(axis=0), 1e-12) / np.float32(127.0)).astype(
        np.float32)
    head = np.clip(np.round(deq[:BUILD_BLOCK] / want_scale[None, :]), -127, 127).astype(np.int8)
    fi_ok = (np.array_equal(cas_fi.coarse.scale.cpu().numpy(), want_scale)
             and np.array_equal(cas_fi.coarse.vectors[:BUILD_BLOCK].cpu().numpy(), head))
    del deq, head
    if not fi_ok:
        raise AssertionError("from_index: the coarse int8 scale or bytes differ from numpy's")
    emit("cascade_build", m_coarse=CASCADE_M, n_factor=CASCADE_N, build_s=t_build,
         coarse_gb=coarse64.nbytes / 1e9, from_index_bitwise_numpy=True)

    with counters.uncounted():
        # (a) each kernel at the cascade's shapes against its plain version
        wide_m, wide_n = CASCADE_CONFIGS[1]
        cas_wide = CascadeIndex.build(pruned, m_coarse=wide_m, n_factor=wide_n)
        qf = _project_nofold(qb, W, mean)
        for coarse, kk in ((coarse64, CASCADE_N * K), (cas_wide.coarse, wide_n * K)):
            name = f"cascade_coarse_m{coarse.dim}_k{kk}"
            qc = (qf[:, :coarse.dim] * coarse.scale[None, :]).contiguous()
            before = topk_score.topk_score_cuda.cuda_launches["int8"]
            got = topk_score.topk_score_cuda(coarse.vectors, qc, k=kk)
            per_call = topk_score.topk_score_cuda.cuda_launches["int8"] - before
            want = topk_score.topk_score_plain(coarse.vectors, qc, k=kk)
            err, eq, near = compare_topk(*want, *got, name)
            mc = coarse.dim
            rows[name] = dict(
                shape=[n, mc, BATCH, kk], store="int8", max_abs_err=err, ids_equal=eq,
                near_ties=near, launches_per_call=per_call,
                ms=cuda_ms(lambda: topk_score.topk_score_cuda(coarse.vectors, qc, k=kk),
                           reps=10),
                plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(coarse.vectors, qc,
                                                                     k=kk), reps=2),
                library_ms=cuda_ms(lambda: torch.topk(qc @ coarse.vectors.T.float(), kk),
                                   reps=3),
                library_call="matmul + topk",
                bound=bound(n * mc + 4 * BATCH * mc + 8 * BATCH * kk, 2 * BATCH * n * mc))
            del got, want
        # the row_ids rescore on this batch's real shortlist, full f32 and int8
        _, cids = cas_f32.coarse_topk(qf, CASCADE_N * K)
        uids = _shortlist(cids)
        for name, full in (("cascade_rescore_f32", index_f32),
                           ("cascade_rescore_int8", index_int8)):
            rws = full.vectors[uids.long().clamp_min(0)]
            q = (qf if full.scale is None else qf * full.scale[None, :]).contiguous()
            got = topk_score.topk_score_cuda(rws, q, k=K, row_ids=uids)
            want = topk_score.topk_score_plain(rws, q, k=K, row_ids=uids)
            err, eq, near = compare_topk(*want, *got, name)
            U, item = rws.shape[0], rws.element_size()
            live = rws[uids >= 0].float()
            rows[name] = dict(
                shape=[U, m, BATCH, K], store=str(full.vectors.dtype).split(".")[1],
                U_live=int((uids >= 0).sum()), max_abs_err=err, ids_equal=eq,
                near_ties=near,
                ms=cuda_ms(lambda: topk_score.topk_score_cuda(rws, q, k=K, row_ids=uids),
                           reps=20),
                plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(rws, q, k=K,
                                                                     row_ids=uids), reps=20),
                library_ms=cuda_ms(lambda: torch.topk(q @ live.T, K), reps=20),
                library_call="matmul + topk over the live rows",
                bound=bound(item * U * m + 4 * U + 4 * BATCH * m + 8 * BATCH * K,
                            2 * BATCH * U * m))
        # the paged coarse scan (256-row pages, per-page scale)
        pc = PagedIndex.from_index(coarse64, page_rows=PAGE_ROWS)
        st = pc.storage
        npg = st.n_slots
        qc = qf[:, :CASCADE_M].contiguous()
        pargs = (st.pool, st.page_table, st.page_nvalid, st.page_offset, 0, npg, qc)
        pkw = dict(k=CASCADE_N * K, tail=st.tail, page_scale=st.page_scale)
        got = pc._search_qf(qc, CASCADE_N * K)
        want = topk_score.topk_score_paged_plain(*pargs, **pkw)
        err, eq, near = compare_topk(*want, *got, "cascade paged coarse")
        dense_s = coarse64.search(qc, k=CASCADE_N * K)
        if not same(got, dense_s):
            raise AssertionError("cascade: paged coarse scan not bitwise the dense one")
        rows["cascade_paged_coarse"] = dict(
            shape=[npg, PAGE_ROWS, CASCADE_M, BATCH, CASCADE_N * K], store="int8",
            max_abs_err=err, ids_equal=eq, near_ties=near, pages=npg,
            ms=cuda_ms(lambda: topk_score.topk_score_paged_cuda(*pargs, **pkw), reps=10),
            plain_ms=cuda_ms(lambda: topk_score.topk_score_paged_plain(*pargs, **pkw),
                             reps=1),
            library_ms=rows[f"cascade_coarse_m{CASCADE_M}_k{CASCADE_N * K}"]["library_ms"],
            library_call="matmul + topk (dense rows)",
            dense_ms=rows[f"cascade_coarse_m{CASCADE_M}_k{CASCADE_N * K}"]["ms"],
            bound=bound(npg * PAGE_ROWS * CASCADE_M + 4 * npg * (CASCADE_M + 3)
                        + 4 * BATCH * CASCADE_M + 8 * BATCH * CASCADE_N * K,
                        2 * BATCH * npg * PAGE_ROWS * CASCADE_M))
        del pc, st, pargs, got, want, dense_s
    emit("cascade_kernels", **{k: v for k, v in rows.items() if k.startswith("cascade_")})

    # (b) the anchor: N·k >= n makes the cascade bitwise the full search
    prefix = pruned[:ANCHOR_DOCS]
    grow = pruner.prune_index(fresh[:LIVE_APPEND]).cpu().numpy()
    anchor = {}
    for quant in (False, True):
        na = ANCHOR_DOCS
        dense = CascadeIndex.build(prefix, m_coarse=CASCADE_M, n_factor=-(-na // K),
                                   quantize_int8=quant)
        seg = CascadeIndex.build(prefix, m_coarse=CASCADE_M,
                                 n_factor=-(-(na + LIVE_APPEND) // K), quantize_int8=quant
                                 ).segmented(delta_capacity=DELTA_CAPACITY).append(grow)
        paged = seg.paged(page_rows=PAGE_ROWS, seal_rows=DELTA_CAPACITY)
        for b in batches[:2]:
            if not same(dense.search_projected(b, W, k=K, mean=mean),
                        dense.full.search_projected(b, W, k=K, mean=mean)):
                raise AssertionError(f"cascade anchor: dense {quant} not bitwise")
            want = seg.full.search_projected(b, W, k=K, mean=mean)
            if not same(seg.search_projected(b, W, k=K, mean=mean), want):
                raise AssertionError(f"cascade anchor: segmented {quant} not bitwise")
            if not same(paged.search_projected(b, W, k=K, mean=mean), want):
                raise AssertionError(f"cascade anchor: paged {quant} not bitwise")
        anchor["int8" if quant else "f32"] = dict(
            dense_nk=min(dense.n_factor * K, na), segmented_nk=seg.n,
            deltas=len(seg.full.deltas), bitwise=True)
        del dense, seg, paged
    emit("cascade_anchor", n=ANCHOR_DOCS, appended=LIVE_APPEND, batches=2, **anchor)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) recall@10 against the full f32 search and the batch time split
    with counters.uncounted():
        truth = [index_f32.search_projected(b, W, k=K, mean=mean)[1] for b in batches]
        single = dict(f32_ms=cuda_ms(lambda: index_f32.search_projected(qb, W, k=K,
                                                                       mean=mean), reps=10),
                      int8_ms=cuda_ms(lambda: index_int8.search_projected(qb, W, k=K,
                                                                        mean=mean), reps=10))

        def recall10(index):
            """Mean top-10 overlap with the full f32 search over the batches."""
            got = [index.search_projected(b, W, k=K, mean=mean)[1] for b in batches]
            return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                                  for t, g in zip(truth, got)
                                  for a, b in zip(t.cpu(), g.cpu())]))

        single["int8_recall10"] = recall10(index_int8)
        coarse_of = {CASCADE_M: coarse64, wide_m: cas_wide.coarse}
        for mc, nf in CASCADE_CONFIGS:
            coarse = coarse_of[mc]
            keys = coarse_keys(coarse, _project_nofold(qb, W, mean))
            for full_name, full in (("f32", index_f32), ("int8", index_int8)):
                cas = CascadeIndex(coarse=coarse, full=full, n_factor=nf)
                rec = recall10(cas)
                split = cascade_split(cas, qb, W, mean, K, keys)
                emit("cascade_point", config=f"{mc}:{nf}", full=full_name, recall10=rec,
                     **split, single_f32_ms=single["f32_ms"], single_int8_ms=single["int8_ms"])
            del keys
        summary["single"] = single
    del cas_wide
    gc.collect()
    torch.cuda.empty_cache()

    # (d) growth under open-loop traffic: 10,000 rows in 64-row blocks
    live = cas_int8.segmented(delta_capacity=DELTA_CAPACITY)
    server = RetrievalServer(live, pruner, k=K, max_batch=BATCH, pipeline_depth=3)
    state = {"index": live, "ms": []}

    def appender():
        cas = state["index"]
        for i in range(0, LIVE_APPEND, APPEND_BLOCK):
            t = time.perf_counter()
            cas = cas.append(pruner.prune_index(fresh[i:min(i + APPEND_BLOCK, LIVE_APPEND)]))
            server.swap_index(cas)
            state["ms"].append((time.perf_counter() - t) * 1e3)
        state["index"] = cas

    tape = np.tile(Q, (-(-CASCADE_TAPE // len(Q)), 1))[:CASCADE_TAPE]
    try:
        server.warmup()
        th = threading.Thread(target=appender, daemon=True)
        th.start()
        res = _drive_open(server, tape, rate=CASCADE_RATE, collect=True)
        th.join(timeout=120.0)
        if th.is_alive():
            raise AssertionError("cascade (d): the appender did not finish")
        stats = server.worker_stats()
    finally:
        server.close()
    final = state["index"]
    bad = sum(1 for r in res["results"] if not isinstance(r, tuple)
              or not bool(((r[1] >= 0) & (r[1] < final.n)).all()))
    if server.error is not None or res["n_ok"] != res["n"] or res["errors"] or bad:
        raise AssertionError(f"cascade (d): {res['n'] - res['n_ok']} replies lost, "
                             f"{bad} malformed, server error {server.error!r}")
    if final.n != n + LIVE_APPEND or final.coarse.n != final.full.n:
        raise AssertionError(f"cascade (d): grew to {final.n} rows")
    paged = final.paged(page_rows=PAGE_ROWS, seal_rows=DELTA_CAPACITY)
    for b in batches:
        if not same(paged.search_projected(b, W, k=K, mean=mean),
                    final.search_projected(b, W, k=K, mean=mean)):
            raise AssertionError("cascade (d): the paged cascade differs from the segmented")
    # the same with EVICT_PAGES of the full side's base pages on the host
    # tier (its suffix), so the rescore gathers shortlist rows off host pages
    base_pages = -(-final.full.base.n // PAGE_ROWS)
    capped = final.paged(page_rows=PAGE_ROWS, seal_rows=DELTA_CAPACITY,
                         pool_pages=base_pages - EVICT_PAGES)
    if capped.full.storage.n_host_pages != EVICT_PAGES:
        raise AssertionError(f"cascade (d): {capped.full.storage.n_host_pages} host pages")
    host_lo = (base_pages - EVICT_PAGES) * PAGE_ROWS
    host_rows = 0
    for b in batches:
        qf = _project_nofold(b, W, mean)
        uids = _shortlist(capped.coarse_topk(qf, CASCADE_N * K)[1])
        host_rows += int(((uids >= host_lo) & (uids < final.full.base.n)).sum())
        if not same(capped.search_projected(b, W, k=K, mean=mean),
                    final.search_projected(b, W, k=K, mean=mean)):
            raise AssertionError("cascade (d): the host-tier paged cascade differs "
                                 "from the segmented")
    if not host_rows:
        raise AssertionError("cascade (d): no shortlist row lay in a host page")
    with counters.uncounted():
        qf = _project_nofold(qb, W, mean)
        uids = _shortlist(capped.coarse_topk(qf, CASCADE_N * K)[1])
        host_tier = dict(
            host_pages=EVICT_PAGES, shortlist_rows_on_host=host_rows, batches=len(batches),
            batch_ms=cuda_ms(lambda: capped.search_projected(qb, W, k=K, mean=mean), reps=5),
            resident_batch_ms=cuda_ms(lambda: paged.search_projected(qb, W, k=K, mean=mean),
                                      reps=5),
            segmented_batch_ms=cuda_ms(lambda: final.search_projected(qb, W, k=K, mean=mean),
                                       reps=5),
            rescore_ms=cuda_ms(lambda: capped.full.rescore(qf, uids, K), reps=10),
            resident_rescore_ms=cuda_ms(lambda: paged.full.rescore(qf, uids, K), reps=10),
            segmented_rescore_ms=cuda_ms(lambda: final.full.rescore(qf, uids, K), reps=10))
    emit("cascade_host_tier", **host_tier, equals_segmented=True)
    del capped
    ms = np.array(state["ms"])
    summary["live"] = dict(appended=LIVE_APPEND, deltas=len(final.full.deltas),
                           swaps=server.swap_count, append_ms_p50=float(np.median(ms)),
                           append_ms_p90=float(np.percentile(ms, 90)),
                           open_loop={k: v for k, v in res.items() if k != "results"},
                           tape_qps=tape_qps(res["n"], CASCADE_RATE), **stats)
    summary["host_tier"] = host_tier
    emit("cascade_live", **summary["live"], replies_lost=0, paged_equals_segmented=True)
    del paged

    # (e) the store round trip of the grown segmented int8 cascade
    root = os.path.join(HERE, "build", "cascade_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = os.path.join(root, "cascade")
    t0 = time.perf_counter()
    st = save_index(path, final, pruner=pruner)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    ld = CascadeIndex.load(path, m_coarse=CASCADE_M, n_factor=CASCADE_N, segmented=True,
                           delta_capacity=DELTA_CAPACITY, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    for side in ("coarse", "full"):
        a, b = getattr(final, side), getattr(ld, side)
        if not (torch.equal(a.base.vectors, b.base.vectors)
                and torch.equal(a.base.scale, b.base.scale)
                and len(a.deltas) == len(b.deltas)):
            raise AssertionError(f"cascade (e): the {side} base differs after the load")
        for da, db in zip(a.deltas, b.deltas):
            if not (torch.equal(da.vectors[:da.n_real], db.vectors[:db.n_real])
                    and torch.equal(da.scale, db.scale)):
                raise AssertionError(f"cascade (e): a {side} delta differs after the load")
    t0 = time.perf_counter()
    lp = CascadeIndex.load(path, m_coarse=CASCADE_M, n_factor=CASCADE_N, paged=True,
                           delta_capacity=DELTA_CAPACITY, device=dev)
    torch.cuda.synchronize()
    t_paged = time.perf_counter() - t0
    for b in batches:
        want = final.search_projected(b, W, k=K, mean=mean)
        if not (same(ld.search_projected(b, W, k=K, mean=mean), want)
                and same(lp.search_projected(b, W, k=K, mean=mean), want)):
            raise AssertionError("cascade (e): a reloaded search differs")
    summary["store"] = dict(bytes=int(st.nbytes), save_s=t_save, load_s=t_load,
                            load_paged_s=t_paged,
                            coarse_deltas=len(st.resolution_deltas(f"m{CASCADE_M}")))
    emit("cascade_store", **summary["store"], bitwise=True)
    del ld, lp, final, live, state
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()
    emit("cascade_summary", peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         **summary)


def phase_fleet(counters, index_f32, index_int8, pruner, Q):
    """Phase 11: three replicas over the full-corpus int8 artifact (phase
    4's int8 index saved again: phase 9 removed its own), under build/
    fleet_smoke/. An open-loop drive at 1,000 qps for 10 s while a fault
    plan kills r1 at 3 s and restarts it at 6 s: no accepted reply lost,
    every OK reply's ids those of the single-server search on the same
    bytes, health ok after. Then a timed restart, a good rollout (recall
    1.0 on every replica), a row-permuted artifact (build_index_to over
    phase 4's pruned rows in a random order) that rolls back after the
    first replica with zero misrouted replies under traffic, and a torn
    artifact that is refused while the fleet keeps serving."""
    import gc
    import shutil
    import threading
    import numpy as np
    import torch
    from repro_torch.core import save_index
    from repro_torch.launch.serve import _drive_open
    from repro_torch.serving.fleet import FaultEvent, FaultPlan, ReplicaSet, corrupt_artifact

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    W, mean = pruner.projection()
    n = index_int8.n
    root = os.path.join(HERE, "build", "fleet_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    v1, v2, vbad = (os.path.join(root, x) for x in ("v1", "v2", "vbad"))
    t0 = time.perf_counter()
    save_index(v1, index_int8, pruner=pruner)
    t_v1 = time.perf_counter() - t0
    # the single server's answer to each query, on the same bytes
    with counters.uncounted():
        want = []
        for i in range(0, len(Q), BATCH):
            q = torch.as_tensor(Q[i:i + BATCH], device=dev)
            nq = q.shape[0]
            if nq < BATCH:
                q = torch.cat([q, q.new_zeros(BATCH - nq, q.shape[1])])
            want.append(index_int8.search_projected(q, W, k=K, mean=mean)[1][:nq].cpu().numpy())
        want = np.concatenate(want)

    def misrouted(res, qidx):
        return sum(1 for j, r in enumerate(res["results"])
                   if isinstance(r, tuple) and not np.array_equal(r[1], want[qidx[j]]))

    def drive(n_q):
        qidx = np.arange(n_q) % len(Q)
        res = _drive_open(fleet, Q[qidx], rate=FLEET_RATE, collect=True,
                          tolerate_errors=True, deadline=2.0)
        return res, misrouted(res, qidx)

    def summary_of(res):
        return {k: v for k, v in res.items() if k != "results"}

    t0 = time.perf_counter()
    fleet = ReplicaSet(v1, replicas=FLEET_REPLICAS, k=K, max_batch=BATCH, pipeline_depth=3,
                       delta_capacity=DELTA_CAPACITY, probe_queries=Q[:16], device=dev)
    t_fleet = time.perf_counter() - t0
    out = {}
    try:
        # the kill/restart drive
        FaultPlan([FaultEvent(FLEET_KILL_AT, "kill", "r1"),
                   FaultEvent(FLEET_RESTART_AT, "restart", "r1")]).start(fleet)
        res, mis = drive(int(FLEET_RATE * FLEET_SECONDS))
        stats, health = fleet.stats(), fleet.health()
        out["chaos"] = dict(**summary_of(res), tape_qps=tape_qps(res["n"], FLEET_RATE),
                            misrouted=mis, health_ok=health["ok"],
                            **{k: stats[k] for k in ("accepted", "completed", "shed",
                                                     "timed_out", "failed", "failovers",
                                                     "marked_down", "lost_accepted")})
        emit("fleet_chaos", replicas=FLEET_REPLICAS, kill_at=FLEET_KILL_AT,
             restart_at=FLEET_RESTART_AT, **out["chaos"])
        if stats["lost_accepted"] or mis or not health["ok"]:
            raise AssertionError(f"fleet chaos: lost_accepted={stats['lost_accepted']}, "
                                 f"misrouted={mis}, health={health['ok']}")
        t0 = time.perf_counter()
        fleet.restart("r2")
        out["restart_s"] = time.perf_counter() - t0
        # a good rollout: the same bytes under a new version
        save_index(v2, index_int8, pruner=pruner)
        t0 = time.perf_counter()
        good = fleet.rollout(v2)
        out["good_rollout"] = dict(seconds=time.perf_counter() - t0, ok=good["ok"],
                                   per_replica=good["per_replica"])
        emit("fleet_rollout", kind="good", **out["good_rollout"])
        if not (good["ok"] and fleet.version == v2
                and all(p["recall"] == 1.0 for p in good["per_replica"])):
            raise AssertionError(f"fleet: the good rollout failed: {good}")
        # a row-permuted artifact: every id it returns is wrong
        perm = torch.randperm(n, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
        t0 = time.perf_counter()
        pruner.build_index_to(
            vbad, lambda: (index_f32.vectors[perm[i:i + BUILD_BLOCK]]
                           for i in range(0, n, BUILD_BLOCK)),
            quantize_int8=True, already_projected=True)
        t_bad = time.perf_counter() - t0
        del perm
        result = {}
        roller = threading.Thread(target=lambda: result.update(fleet.rollout(vbad)),
                                  daemon=True)
        t0 = time.perf_counter()
        roller.start()
        res, mis = drive(ROLLOUT_TAPE)
        roller.join(timeout=300.0)
        stats = fleet.stats()
        out["bad_rollout"] = dict(build_s=t_bad, seconds=time.perf_counter() - t0,
                                  rolled_back=result.get("rolled_back"),
                                  replicas_probed=len(result.get("per_replica", ())),
                                  per_replica=result.get("per_replica"), misrouted=mis,
                                  lost_accepted=stats["lost_accepted"],
                                  drive=summary_of(res))
        emit("fleet_rollout", kind="row_permuted", **out["bad_rollout"])
        if not (result.get("rolled_back") and not result.get("ok")
                and len(result["per_replica"]) == 1 and mis == 0
                and stats["lost_accepted"] == 0 and fleet.version == v2
                and set(fleet.router.states().values()) == {"up"}):
            raise AssertionError(f"fleet: the row-permuted rollout did not roll back "
                                 f"cleanly ({mis} misrouted): {result}")
        # a torn artifact is refused before any replica is touched
        removed = corrupt_artifact(vbad)
        torn = fleet.rollout(vbad)
        _, ids = fleet.query(Q[3], timeout=30.0)
        out["torn"] = dict(removed=os.path.basename(removed), ok=torn["ok"],
                           rolled_back=torn["rolled_back"], reason=torn.get("reason"),
                           still_serving=bool(np.array_equal(ids, want[3])))
        emit("fleet_rollout", kind="torn", **out["torn"])
        if (torn["ok"] or torn["rolled_back"] or "rejected" not in torn.get("reason", "")
                or torn["per_replica"] or fleet.version != v2
                or not out["torn"]["still_serving"] or not fleet.health()["ok"]):
            raise AssertionError(f"fleet: the torn artifact was not refused cleanly: {torn}")
    finally:
        fleet.close()
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()
    emit("fleet_summary", save_v1_s=t_v1, fleet_start_s=t_fleet, restart_s=out["restart_s"],
         peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)


def fit_agreement(pa, pb, m):
    """Two fits held by the PR 18 contract: eigenvalues (relative to the
    largest), the kept m-dim subspace through its projector, and the
    columns an fp32 eigensolver defines (its column i is good to about
    eps * lambda_1 / gap_i) up to sign."""
    import torch
    Wa, Wb = pa.components[:, :m], pb.components[:, :m]
    signs = torch.sign((Wa * Wb).sum(0))
    col_err = (Wa * signs[None, :] - Wb).abs().amax(0)
    lam = pa.eigenvalues.double()
    gaps = (lam[:-1] - lam[1:]).abs()
    near = torch.minimum(torch.cat([gaps[:1], gaps]), torch.cat([gaps, gaps[-1:]]))[:m]
    conditioned = (6e-8 * lam[0] / near.clamp_min(1e-30)) < 1e-4
    return dict(eigenvalues_max_rel_err=float((pa.eigenvalues - pb.eigenvalues).abs().max()
                                              / pa.eigenvalues[0]),
                kept_subspace_projector_max_abs_err=float((Wa @ Wa.T - Wb @ Wb.T).abs().max()),
                conditioned_columns=int(conditioned.sum()),
                conditioned_max_abs_err_up_to_sign=(float(col_err[conditioned].max())
                                                    if bool(conditioned.any()) else 0.0),
                all_columns_max_abs_err_up_to_sign=float(col_err.max()))


def phase_sharded(counters, index_f32, index_int8, pruner, Q, fresh, rows, protocol_docs):
    """Phase 12: the sharded index at full width on one card, over phase
    4's pruned indexes, each slot of a (4,) and a (2, 2) mesh on the card
    and each shard a row view (8,841,823 rows: shards of 2,210,456 and a
    last of 2,210,455). (a) search_projected at k 10 and 100, flat and
    hierarchical, bitwise equal to the dense search, four top-k launches a
    batch; (b) each batch timed beside the dense one, the merges alone, the
    per-shard kernel against its plain version; (c) gram_distributed and
    fit_pca_distributed at the protocol size and at full size (phase 4's
    corpus drawn again) against fp64 and fit_pca; (d) ShardedDenseIndex.load of the int8 index saved under
    build/sharded_smoke/, bitwise the built one; (e) a SegmentedIndex over
    the sharded int8 base grown by 10,000 rows, bitwise the same appends
    over the dense base, then compacted onto the same mesh, bitwise the
    dense compaction; (f) a depth-3 server over the sharded int8 index,
    closed loop, p50 beside the dense server's."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.core import IndexUpdater, SegmentedIndex, save_index
    from repro_torch.core.index import (ShardedDenseIndex, _merge_stages, _staged_topk_merge,
                                        project_queries)
    from repro_torch.core.pca import fit_pca, fit_pca_distributed, gram_distributed
    from repro_torch.data.synthetic import corpus_on_device
    from repro_torch.kernels import gram, topk_score
    from repro_torch.launch.serve import RetrievalServer, _drive, _lat_summary
    from repro_torch.par.mesh import make_mesh

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    meshes = {"4": make_mesh((4,), ("data",), dev), "2x2": make_mesh((2, 2), ("row", "col"), dev)}
    mesh4 = meshes["4"]
    W, mean = pruner.projection()
    m = pruner.kept_dims
    n = index_int8.n
    Qs = torch.as_tensor(Q[:SEARCH_BATCHES * BATCH], device=dev)
    batches = [Qs[i:i + BATCH] for i in range(0, len(Qs), BATCH)]
    tk = topk_score.topk_score_cuda
    dense = {"f32": index_f32, "int8": index_int8}

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    # (a) every batch, both meshes and merges, k 10 and 100: bitwise the
    # dense search, one top-k launch per shard
    sharded = {}
    for name, index in dense.items():
        for mname, mesh in meshes.items():
            sidx = ShardedDenseIndex.from_rows(index.vectors, mesh, scale=index.scale)
            starts = range(0, n, sidx.rows_per)
            if not all(t.data_ptr() == index.vectors[lo:].data_ptr()
                       for t, lo in zip(sidx.shards, starts)):
                raise AssertionError(f"sharded {name} {mname}: a shard is not a view")
            sharded[(name, mname)] = sidx
    shard_rows = [t.shape[0] for t in sharded[("int8", "4")].shards]
    checked = 0
    for name, index in dense.items():
        for k in SHARD_KS:
            with counters.uncounted():
                want = [index.search_projected(b, W, k=k, mean=mean) for b in batches]
            for mname in meshes:
                for merge in ("flat", "hierarchical"):
                    for b, w in zip(batches, want):
                        before = tk.launches[name]
                        got = sharded[(name, mname)].search_projected(b, W, k=k, mean=mean,
                                                                      merge=merge)
                        if tk.launches[name] - before != 4:
                            raise AssertionError(f"sharded {name}: {tk.launches[name] - before} "
                                                 f"top-k launches for 4 shards")
                        if not same(got, w):
                            raise AssertionError(f"sharded {name} {mname} {merge} k={k}: not "
                                                 f"bitwise the dense search")
                        checked += 1
    torch.cuda.synchronize()
    emit("sharded", step="a_bitwise_vs_dense", n=n, m=m, shard_rows=shard_rows,
         meshes={k: list(v.shape) for k, v in meshes.items()}, ks=list(SHARD_KS),
         batches_checked=checked, shards_are_views=True, launches_per_batch=4)

    # (b) batch times beside the dense search; the merges alone; the
    # per-shard kernel at its shape against its plain version
    times = {}
    with counters.uncounted():
        qb = batches[0]
        for name, index in dense.items():
            for k in SHARD_KS:
                row = dict(dense_ms=cuda_ms(lambda: index.search_projected(
                    qb, W, k=k, mean=mean), reps=10))
                for mname in meshes:
                    for merge in ("flat", "hierarchical"):
                        fn = (lambda s=sharded[(name, mname)], mg=merge:
                              s.search_projected(qb, W, k=k, mean=mean, merge=mg))
                        row[f"{mname}_{merge}_ms"] = cuda_ms(fn, reps=10)
                        row[f"{mname}_{merge}_enqueue_ms"] = enqueue_ms(fn, reps=20)
                times[f"{name}_k{k}"] = row
        g = torch.Generator(device=dev).manual_seed(12)
        merges = {}
        for k in SHARD_KS:
            s_all = torch.randn(2, 2, BATCH, k, generator=g, device=dev).sort(
                dim=-1, descending=True).values
            i_all = torch.randint(0, n, (2, 2, BATCH, k), generator=g, device=dev,
                                  dtype=torch.int32)
            for merge in ("flat", "hierarchical"):
                stages = _merge_stages(meshes["2x2"], merge)
                merges[f"k{k}_{merge}_ms"] = cuda_ms(
                    lambda st=stages: _staged_topk_merge(s_all, i_all, k, st), reps=50)
        emit("sharded", step="b_times", card_note="4 slots on one card: the fan-out's "
             "overhead, not a speedup", merges_2x2=merges, **times)
        for name, index in dense.items():
            shard = sharded[(name, "4")].shards[0]
            ns = shard.shape[0]
            q = project_queries(qb, W, scale=index.scale).contiguous()
            got = topk_score.topk_score_cuda(shard, q, k=K)
            want = topk_score.topk_score_plain(shard, q, k=K)
            err, eq, near = compare_topk(*want, *got, f"topk shard {name}")
            item = shard.element_size()
            rows[f"topk_score_shard_{name}"] = dict(
                shape=[ns, m, BATCH, K], store=name, max_abs_err=err, ids_equal=eq,
                near_ties=near,
                ms=cuda_ms(lambda: topk_score.topk_score_cuda(shard, q, k=K), reps=10),
                enqueue_ms=enqueue_ms(lambda: topk_score.topk_score_cuda(shard, q, k=K)),
                plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(shard, q, k=K), reps=2),
                library_ms=None,
                matmul_topk_ms=(cuda_ms(lambda: torch.topk(q @ shard.T, K), reps=5)
                                if item == 4 else None),
                dense_ms=times[f"{name}_k{K}"]["dense_ms"],
                bound=bound(item * ns * m + 4 * BATCH * m + 8 * BATCH * K, 2 * BATCH * ns * m))
            del got, want

    # (c) the distributed Gram and fit at the protocol size and at full
    # size (phase 4's corpus, drawn again from its seed)
    for what, n_rows in (("protocol", protocol_docs), ("full", n)):
        Dx = corpus_on_device("tasb", n_docs=n_rows, d=DIM, seed=0, device=dev)
        d = Dx.shape[1]
        Gd = gram_distributed(Dx, mesh4)                   # one gram launch a strip
        fit_d = fit_pca_distributed(Dx, mesh4)
        with counters.uncounted():
            G1 = gram.gram_cuda(Dx)
            G64 = torch.zeros((d, d), dtype=torch.float64, device=dev)
            for i in range(0, n_rows, 1 << 20):
                c = Dx[i:i + (1 << 20)].double()
                G64 += c.T @ c
            del c
            g64 = float(G64.abs().max())
            rel_d = float((Gd.double() - G64).abs().max()) / g64
            rel_1 = float((G1.double() - G64).abs().max()) / g64
            agree = fit_agreement(fit_pca(Dx), fit_d, m)
            dist_ms = cuda_ms(lambda: gram_distributed(Dx, mesh4), reps=3)
            one_ms = cuda_ms(lambda: gram.gram_cuda(Dx), reps=3)
            if what == "protocol":
                ns = -(-n_rows // mesh4.size)
                strip = Dx[:ns]
                Gs, Gp = gram.gram_cuda(strip), gram.gram_plain(strip)
                before = gram.gram_cuda.cuda_launches
                gram.gram_cuda(strip)
                rows["gram_strip"] = dict(
                    shape=[ns, d], max_abs_err=float((Gs - Gp).abs().max()),
                    rel_err_vs_plain_f32=float((Gs - Gp).abs().max() / Gp.abs().max()),
                    cuda_launches_per_call=gram.gram_cuda.cuda_launches - before,
                    ms=cuda_ms(lambda: gram.gram_cuda(strip), reps=10),
                    plain_ms=cuda_ms(lambda: gram.gram_plain(strip), reps=10),
                    library_ms=cuda_ms(lambda: torch.matmul(strip.T, strip), reps=10),
                    library_call="matmul(D.T, D)",
                    bound=bound(4 * ns * d + 4 * d * d, ns * d * (d + 1)))
                del strip, Gs, Gp
        emit("sharded", step=f"c_distributed_fit_{what}", rows=n_rows, d=d, slots=mesh4.size,
             rel_err_vs_f64=rel_d, one_gram_rel_err_vs_f64=rel_1, tolerance=GRAM_TOL,
             distributed_ms=dist_ms, one_gram_ms=one_ms, components_tol=COMP_TOL, **agree)
        if rel_d > GRAM_TOL:
            raise AssertionError(f"gram_distributed ({what}): relative error {rel_d} vs the "
                                 f"fp64 Gram")
        if (agree["eigenvalues_max_rel_err"] > 1e-5
                or agree["kept_subspace_projector_max_abs_err"] > COMP_TOL
                or agree["conditioned_max_abs_err_up_to_sign"] > COMP_TOL):
            raise AssertionError(f"fit_pca_distributed ({what}) differs from fit_pca: {agree}")
        del Dx, G1, G64, Gd, fit_d
        gc.collect()
        torch.cuda.empty_cache()

    # (d) the int8 index saved, then loaded over the (4,) mesh
    root = os.path.join(HERE, "build", "sharded_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = os.path.join(root, "int8")
    t0 = time.perf_counter()
    save_index(path, index_int8, pruner=pruner)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ShardedDenseIndex.load(path, mesh4)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    built = sharded[("int8", "4")]
    if not (all(torch.equal(a, b) for a, b in zip(loaded.shards, built.shards))
            and torch.equal(loaded.scale, built.scale)):
        raise AssertionError("sharded load: shards or scale differ from the built index")
    for k in SHARD_KS:
        for b in batches:
            got = loaded.search_projected(b, W, k=k, mean=mean)
            with counters.uncounted():
                want = built.search_projected(b, W, k=k, mean=mean)
            if not same(got, want):
                raise AssertionError(f"sharded load: search at k={k} not bitwise the built index")
    emit("sharded", step="d_load", rows=loaded.n, gb=loaded.nbytes / 1e9, save_s=t_save,
         load_s=t_load, load_gb_per_s=loaded.nbytes / 1e9 / t_load, bitwise_vs_built=True)
    del loaded
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the live index over the sharded int8 base, then its compaction
    new_rows = pruner.prune_index(fresh[:LIVE_APPEND]).float().cpu().numpy()
    new_rows[WIDEN_AT:WIDEN_AT + APPEND_BLOCK] *= 9.0
    seg_s = SegmentedIndex.from_index(built, delta_capacity=DELTA_CAPACITY)
    seg_d = SegmentedIndex.from_index(index_int8, delta_capacity=DELTA_CAPACITY)
    t_app = []
    for i in range(0, LIVE_APPEND, APPEND_BLOCK):
        blk = new_rows[i:i + APPEND_BLOCK]
        t0 = time.perf_counter()
        seg_s = seg_s.append(blk)
        t_app.append(time.perf_counter() - t0)
        seg_d = seg_d.append(blk)
    for k in SHARD_KS:
        for b in batches:
            got = seg_s.search_projected(b, W, k=k, mean=mean)
            with counters.uncounted():
                want = seg_d.search_projected(b, W, k=k, mean=mean)
            if not same(got, want):
                raise AssertionError(f"sharded live: search at k={k} not bitwise the dense base's")
    with counters.uncounted():
        seg_ms = cuda_ms(lambda: seg_s.search_projected(batches[0], W, k=K, mean=mean), reps=10)
        seg_dense_ms = cuda_ms(lambda: seg_d.search_projected(batches[0], W, k=K, mean=mean),
                               reps=10)
    n_deltas = len(seg_s.deltas)
    up_s = IndexUpdater(pruner=pruner, index=seg_s, delta_capacity=DELTA_CAPACITY)
    del seg_s
    t0 = time.perf_counter()
    up_s.compact()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    base_s = up_s.index.base
    if not (isinstance(base_s, ShardedDenseIndex) and base_s.mesh is mesh4
            and base_s.n == n + LIVE_APPEND and not up_s.index.deltas):
        raise AssertionError("sharded compact: the base left its mesh")
    with counters.uncounted():
        up_d = IndexUpdater(pruner=pruner, index=seg_d, delta_capacity=DELTA_CAPACITY)
        del seg_d
        up_d.compact()
        base_d = up_d.index.base
        per = base_s.rows_per
        if not (all(torch.equal(t, base_d.vectors[i * per:i * per + t.shape[0]])
                    for i, t in enumerate(base_s.shards))
                and torch.equal(base_s.scale, base_d.scale)):
            raise AssertionError("sharded compact: bytes differ from the dense compaction")
    for b in batches:
        got = up_s.index.search_projected(b, W, k=K, mean=mean)
        with counters.uncounted():
            want = up_d.index.search_projected(b, W, k=K, mean=mean)
        if not same(got, want):
            raise AssertionError("sharded compact: search not bitwise the dense compaction's")
    emit("sharded", step="e_live", appended=LIVE_APPEND, deltas=n_deltas,
         append_ms_p50=float(np.percentile(t_app, 50) * 1e3),
         batch_ms_segmented_sharded=seg_ms, batch_ms_segmented_dense=seg_dense_ms,
         compact_s=t_compact, compacted_rows=base_s.n, same_mesh=True, bitwise_vs_dense=True)
    del up_s, up_d, base_s, base_d, new_rows
    gc.collect()
    torch.cuda.empty_cache()

    # (f) a depth-3 server over the sharded int8 index, beside the dense one
    served = {}
    for what, index in (("sharded_4_flat", sharded[("int8", "4")]),
                        ("sharded_2x2_hierarchical", ShardedDenseIndex.from_rows(
                            index_int8.vectors, meshes["2x2"], scale=index_int8.scale,
                            merge="hierarchical")),
                        ("dense", index_int8)):
        ctx = counters.uncounted() if what == "dense" else contextlib.nullcontext()
        with ctx:
            server = RetrievalServer(index, pruner, k=K, max_batch=BATCH, pipeline_depth=3)
            try:
                server.warmup()
                wall, lat = _drive(server, Q[:SERVER_CLOSED])
                served[what] = dict(qps=SERVER_CLOSED / wall, **_lat_summary(lat))
                replies = [server.query(q) for q in Q[:BATCH]]
            finally:
                server.close()
        pad = torch.zeros((BATCH - 1, DIM), device=dev)
        with counters.uncounted():
            for q, (rs, ri) in zip(Q[:BATCH], replies):
                s, ids = index_int8.search_projected(
                    torch.cat([torch.as_tensor(q[None], device=dev), pad]), W, k=K, mean=mean)
                if not (np.array_equal(ri, ids[0].cpu().numpy())
                        and np.array_equal(rs, s[0].cpu().numpy())):
                    raise AssertionError(f"server {what}: a reply differs from the dense search")
    emit("sharded", step="f_server", pipeline_depth=3, batch=BATCH, k=K, queries=SERVER_CLOSED,
         replies_checked=BATCH, peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         **served)


def phase_analysis(counters, index_f32, index_int8, pruner, Q, fresh, rows, smi):
    """Phase 18: the analysis gate on the card, over phase 4's indexes.
    (a) the top-k's live count as a 0-d device tensor against the host int,
    bitwise: a 4,096-row delta (f32 and int8) at five counts and the full
    index at n - 1, then a delta search captured once in a CUDA graph and
    replayed at three counts against eager; (b) the dispatch lints on the
    full-size dense, sharded (4 slots), segmented, paged and cascade entry
    points: top-k calls a search as the CPU counts them, no upcast of an
    int8 index, no synchronizing call; (c) the kernel budget, one line a
    kernel; (d) each entry point's batch timed into
    build/analysis/measured.json and the cost cross-check; (e) the whole
    gate, ``python -m repro_torch.analysis --fail-on-findings``, exit 0."""
    import torch
    from repro_torch.analysis import cost_model, dispatch_lints, kernel_budget
    from repro_torch.core.cascade import CascadeIndex
    from repro_torch.core.index import SegmentedIndex, ShardedDenseIndex, _delta_topk
    from repro_torch.core.paged import PagedIndex
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import topk_score
    from repro_torch.par.mesh import make_mesh

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    W, mean = pruner.projection()
    m = pruner.kept_dims
    n = index_int8.n
    qraw = torch.as_tensor(Q[:BATCH], device=dev)
    q = (qraw.float() - (0 if mean is None else mean[None, :])) @ W
    tk = topk_score.topk_score_cuda

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    # (a) a device count against the host int, bitwise
    delta_f32 = index_f32.vectors[:ANALYSIS_DELTA].contiguous()
    delta_i8, dscale = quantize_int8_per_dim(delta_f32)
    deltas = {"f32": (delta_f32, q.contiguous()),
              "int8": (delta_i8, (q * dscale[None, :]).contiguous())}
    checks = 0
    for st, (D, qd) in deltas.items():
        for k in (K, SHORTLIST_K):
            for nv in ANALYSIS_COUNTS:
                count = torch.tensor(nv, dtype=torch.int32, device=dev)
                if not same(tk(D, qd, k=k, n_valid=count), tk(D, qd, k=k, n_valid=nv)):
                    raise AssertionError(f"analysis (a): {st} delta k={k} count {nv}: the "
                                         f"device count differs from the host int")
                checks += 1
    for st, index in (("f32", index_f32), ("int8", index_int8)):
        qd = (q if index.scale is None else q * index.scale[None, :]).contiguous()
        count = torch.tensor(n - 1, dtype=torch.int32, device=dev)
        if not same(tk(index.vectors, qd, k=K, n_valid=count),
                    tk(index.vectors, qd, k=K, n_valid=n - 1)):
            raise AssertionError(f"analysis (a): full {st} index at n - 1: the device count "
                                 f"differs from the host int")
        checks += 1
    count = torch.tensor(ANALYSIS_COUNTS[1], dtype=torch.int32, device=dev)
    for _ in range(2):
        _delta_topk(delta_i8, dscale, q, count, n, K)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gs, gi = _delta_topk(delta_i8, dscale, q, count, n, K)
    for live in ANALYSIS_REPLAY:
        count.fill_(live)
        graph.replay()
        if not same((gs, gi), _delta_topk(delta_i8, dscale, q, live, n, K)):
            raise AssertionError(f"analysis (a): the graph replayed at {live} differs from "
                                 f"eager")
    with counters.uncounted():
        for st, (D, qd) in deltas.items():
            for how, nv in (("host", 1808), ("device", torch.tensor(1808, dtype=torch.int32,
                                                                   device=dev))):
                rows[f"topk_score_delta_{st}_{how}_count"] = topk_row(D, qd, K, n_valid=nv)
        replay_ms = median_ms(graph.replay, reps=ANALYSIS_TIMED)
        eager_ms = median_ms(lambda: _delta_topk(delta_i8, dscale, q, count, n, K),
                             reps=ANALYSIS_TIMED)
    del graph
    emit("analysis", step="a_device_count", checks=checks, replays=len(ANALYSIS_REPLAY),
         graph_replay_ms=replay_ms, eager_ms=eager_ms,
         **{f"delta_{st}_{how}_ms": rows[f"topk_score_delta_{st}_{how}_count"]["ms"]
            for st in deltas for how in ("host", "device")})

    # (b) the dispatch lints at full size
    mesh4 = make_mesh((4,), ("data",), dev)
    grow = pruner.prune_index(fresh[:ANALYSIS_DELTA + ANALYSIS_COUNTS[2]]).cpu().numpy()
    seg = SegmentedIndex.from_index(index_int8, delta_capacity=ANALYSIS_DELTA).append(grow)
    pg = PagedIndex.from_index(index_int8, page_rows=PAGE_ROWS)
    cas = CascadeIndex.from_index(index_int8, m_coarse=CASCADE_M, n_factor=CASCADE_N)
    targets = {
        "DenseIndex.search_projected[f32]": (index_f32, 1, None),
        "DenseIndex.search_projected[int8]": (index_int8, 1, "int8"),
        "ShardedDenseIndex.search_projected[flat,f32]": (
            ShardedDenseIndex.from_rows(index_f32.vectors, mesh4), 4, None),
        "ShardedDenseIndex.search_projected[flat,int8]": (
            ShardedDenseIndex.from_rows(index_int8.vectors, mesh4, scale=index_int8.scale), 4,
            "int8"),
        f"SegmentedIndex.search_projected[int8,{len(seg.deltas)}d]": (
            seg, 1 + len(seg.deltas), None),
        "PagedIndex.search_projected[int8]": (pg, 1, "int8"),
        "CascadeIndex.search_projected[int8]": (cas, 2, "int8"),
    }
    entries = [dispatch_lints.EntryPoint(
        label=label, fn=(lambda ix: lambda x: ix.search_projected(x, W, k=K, mean=mean))(ix),
        args=(qraw,), expected_calls=calls, corpus_shape=(n, m), family=label.split(".")[0],
        storage_dtype=store, batch=BATCH, index=ix) for label, (ix, calls, store)
        in targets.items()]
    lint = {}
    for ep in entries:
        probe = dispatch_lints.run_probed(ep.fn, ep.args, device="cuda",
                                          strip_elems=dispatch_lints.strip_elems(ep.corpus_shape))
        found = dispatch_lints.lint_entry(ep)
        lint[ep.label] = dict(calls=probe.kernel_calls, expected=ep.expected_calls,
                              upcasts=len(probe.upcasts), host_reads=len(probe.host_reads),
                              findings=[f.key for f in found])
        emit("analysis", step="b_dispatch", entry=ep.label, **lint[ep.label])
        if found:
            raise AssertionError(f"analysis (b): {ep.label}: {[f.message for f in found]}")

    # (c) the kernel budget
    compiled = {(r["source"], r["kernel"]) for r in kernel_budget.ptxas_rows()}
    table = kernel_budget.kernel_table()
    for r in table:
        emit("analysis", step="c_budget", **r)
    with counters.uncounted():          # its alignment probes are checks, not the path
        budget = kernel_budget.run(
            "cuda", extra=[(lambda ep=ep: ep.fn(*ep.args)) for ep in entries])
    for f in budget:
        emit("analysis", step="c_budget_finding", key=f.key, severity=f.severity,
             message=f.message)
    gating = [f.key for f in budget if f.severity == "error"]
    if gating:
        raise AssertionError(f"analysis (c): kernel budget findings {gating}")
    if len(table) != len(compiled):
        raise AssertionError(f"analysis (c): {len(table)} kernels with attributes, "
                             f"{len(compiled)} in the ptxas reports")

    # (d) each entry point timed, then the cost cross-check
    measured = {}
    with counters.uncounted():
        for ep in entries:
            measured[ep.label] = dict(ms=median_ms(lambda: ep.fn(*ep.args), reps=ANALYSIS_TIMED),
                                      B=BATCH, n=n, m=m, reps=ANALYSIS_TIMED)
    name_, limit = [s.strip() for s in smi.split(",")]
    out = os.path.join(HERE, "build", "analysis", "measured.json")
    cost_model.write_measured(out, measured, device=name_, power_limit=limit)
    cross = cost_model.bench_crosscheck(
        json.load(open(cost_model.COSTS_PATH))["entries"], json.load(open(out)))
    emit("analysis", step="d_measured", path=os.path.relpath(out, HERE),
         **{label: row["ms"] for label, row in measured.items()},
         crosscheck=[f.key for f in cross], crosscheck_messages=[f.message for f in cross])
    del seg, pg, cas, entries
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the whole gate in a process of its own
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--fail-on-findings",
                          "--json", os.path.join("build", "analysis", "report.json")],
                         cwd=HERE, env={**os.environ, "PYTHONPATH": os.path.join(HERE, "src")},
                         capture_output=True, text=True, timeout=ANALYSIS_TIMEOUT)
    report = json.load(open(os.path.join(HERE, "build", "analysis", "report.json")))
    emit("analysis", step="e_gate", rc=res.returncode, seconds=time.perf_counter() - t0,
         counts=report["counts"], findings=[f["check"] + ":" + f["where"]
                                           for f in report["findings"]],
         suppressed=[f["check"] + ":" + f["where"] for f in report["suppressed"]])
    if res.returncode != 0:
        raise AssertionError(f"analysis (e): python -m repro_torch.analysis exited "
                             f"{res.returncode}:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    emit("analysis", step="done", seconds=time.perf_counter() - t_phase)


def median_ms(fn, reps=3):
    """Median device time of ``fn`` over ``reps`` runs after one warm-up,
    each run between its own pair of CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bf16_ulps(a, b):
    """Entry-wise distance of two bf16 tensors in bf16 ULPs (ordered bits)."""
    import torch

    def ordered(x):
        i = x.cpu().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def encoder_flops(tokens, seq_len, cfg):
    """(bf16 FLOP, f32 FLOP) of ``encode`` over ``tokens`` tokens in
    sequences of ``seq_len``: per layer the four projections, the MLP's three
    products and P·V in bf16, Q·Kᵀ in f32; the pooled projection is
    negligible and left out."""
    d, f = cfg.d_model, cfg.d_ff
    per_layer_bf16 = 2 * (4 * d * d + 3 * d * f) + 2 * seq_len * d
    return cfg.n_layers * tokens * per_layer_bf16, cfg.n_layers * tokens * 2 * seq_len * d


def phase_encoder(counters, rows, encode_docs, encode_batch):
    """Phase 13: the bi-encoder at the full width of
    configs/biencoder_msmarco.CFG (BERT-base: 12 layers, d 768, 12 heads,
    d_ff 3072, gated GELU MLP, vocab 30,522, max_len 256), weights from a
    seeded generator on the card. (a) 8 x 256 encoded on the card and on
    the CPU, f32 compute (max |delta| <= 1e-4) and bf16 (cosine >= 0.999
    per row), and the bf16 GELU on a 1,024 x 3,072 tensor (within one bf16
    ULP, share differing printed); (b) one encode_corpus batch (8,192 x
    256) in micro-batches of ``encode_batch`` rows, and query batches of 32
    x 32 and 32 x 256, CUDA events, median of 3 after a warm-up, beside the
    bound, with the peak memory; (c) launch.encode's path: ``encode_docs``
    passages and 1,000 queries at seq 256, the fit, the prune, the int8
    index through the fused kernel (held to the two-pass build) and an f32
    one, the searches at k 10 against the plain top-k, MRR@10; (d) one
    encoder layer at the micro-batch op by op, each against its bound, the
    ops' composition held bitwise to the layer, SDPA beside the
    attention."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.biencoder_msmarco import CFG, SHAPES
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.data.tokens import pair_batch
    from repro_torch.kernels import gram, pca_project, topk_score
    from repro_torch.launch import encode as encode_cli
    from repro_torch.models import layers as L
    from repro_torch.models.biencoder import encode, init_biencoder

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = init_biencoder(CFG, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tensor_params = sum(p.numel() for p in model.parameters())
    emit("encoder", step="init", config=dataclasses.asdict(CFG),
         param_count=CFG.param_count(), tensor_params=tensor_params, init_s=t_init)
    if CFG.param_count() != 137_491_968:
        raise AssertionError(f"encoder: param_count {CFG.param_count()}")

    # (a) the card against the CPU on the same weights
    seq = CFG.max_len
    tok = pair_batch(7, 0, batch=ENCODE_PARITY_ROWS, seq_len=seq, vocab=CFG.vocab)["d_tokens"]
    mask = torch.ones(tok.shape, dtype=torch.int32)
    cpu_model = copy.deepcopy(model).cpu()
    f32 = dataclasses.replace(CFG, compute_dtype="float32")
    t0 = time.perf_counter()
    with torch.inference_mode():
        got32 = encode(model.with_config(f32), tok, mask).cpu()
        want32 = encode(cpu_model.with_config(f32), tok, mask)
        got16 = encode(model, tok, mask).cpu()
        want16 = encode(cpu_model, tok, mask)
    t_cpu = time.perf_counter() - t0
    del cpu_model
    err32 = float((got32 - want32).abs().max())
    err16 = float((got16 - want16).abs().max())
    cos16 = float(((got16 * want16).sum(1) / got16.norm(dim=1) / want16.norm(dim=1)).min())
    x = (torch.randn(1024, CFG.d_ff, generator=torch.Generator().manual_seed(1)) * 2).bfloat16()
    ulps = bf16_ulps(L.gelu(x.to(dev)), L.gelu(x))
    gelu_frac, gelu_max = float((ulps != 0).float().mean()), int(ulps.max())
    emit("encoder", step="a_parity", rows=ENCODE_PARITY_ROWS, seq_len=seq,
         f32_max_abs_err=err32, f32_tol=ENCODE_F32_TOL, bf16_max_abs_err=err16,
         bf16_min_cos=cos16, bf16_cos_bar=ENCODE_BF16_COS, gelu_shape=list(x.shape),
         gelu_frac_differ=gelu_frac, gelu_max_ulps=gelu_max, both_encodes_s=t_cpu)
    if err32 > ENCODE_F32_TOL or cos16 < ENCODE_BF16_COS or gelu_max > 1:
        raise AssertionError(f"encoder (a): f32 {err32}, bf16 cos {cos16}, gelu {gelu_max} ulps")
    if not (torch.isfinite(got16).all() and got16.shape == (ENCODE_PARITY_ROWS, CFG.embed_dim)):
        raise AssertionError("encoder (a): embeddings not finite or of the wrong shape")

    # (b) times
    cell = next(s for s in SHAPES if s.name == "encode_corpus").dims
    nb, seq = cell["global_batch"], cell["seq_len"]
    g = torch.Generator(device=dev).manual_seed(1)
    corpus_tok = torch.randint(0, CFG.vocab, (nb, seq), generator=g, device=dev,
                               dtype=torch.int32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    batch_ms = median_ms(lambda: encode_cli.encode_rows(model, corpus_tok, encode_batch))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bf, ff = encoder_flops(nb * seq, seq, CFG)
    b_ms, b_by = bound(4 * tensor_params + 4 * nb * seq + 4 * nb * CFG.embed_dim, ff, bf)
    queries = {}
    for qs in (32, seq):
        qt = torch.randint(0, CFG.vocab, (BATCH, qs), generator=g, device=dev,
                           dtype=torch.int32)
        qbf, qff = encoder_flops(BATCH * qs, qs, CFG)
        queries[f"{BATCH}x{qs}"] = dict(
            ms=median_ms(lambda: encode_cli.encode_rows(model, qt, BATCH), reps=5),
            enqueue_ms=enqueue_ms(lambda: encode_cli.encode_rows(model, qt, BATCH), reps=5),
            bound=bound(4 * tensor_params, qff, qbf))
    emit("encoder", step="b_times", batch=[nb, seq], micro_batch=encode_batch,
         batch_ms=batch_ms, tokens_per_s=nb * seq / batch_ms * 1e3, bound_ms=b_ms,
         bound_by=b_by, bf16_flop=bf, f32_flop=ff, queries=queries,
         peak_allocated_gb=peak_gb, allocated_before_gb=base_gb)
    del corpus_tok

    # (c) the path, through the entry point: the fit, the prune, the fused
    # int8 build and the full and int8 searches; the f32 pruned index is
    # built and searched beside it
    args = encode_cli.parse_args([
        "--full", "--seq-len", str(seq), "--n-docs", str(encode_docs),
        "--n-queries", str(ENCODE_QUERIES), "--cutoff", str(CUTOFF), "--quantize-int8",
        "--encode-batch", str(encode_batch), "--device", str(dev), "--json"])
    t0 = time.perf_counter()
    res = encode_cli.run(args, model=model)   # gram, pca_project(_quant), topk_score
    index_int8 = res.index
    index_f32 = DenseIndex.build(res.pruned)
    qhat = res.pruner.transform_queries(res.Q)                # pca_project
    s32, i32 = index_f32.search(qhat, k=K)                    # topk_score, f32
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    D, Q, n, d, m = res.D, res.Q, res.D.shape[0], res.D.shape[1], res.pruner.kept_dims
    W = res.pruner.projection()[0].contiguous()
    two_pass = quantize_int8_per_dim(res.pruned)
    qd = (index_int8.vectors.int() - two_pass[0].int()).abs()
    fused_frac, fused_max = float((qd != 0).float().mean()), int(qd.max())
    del qd
    mrr = {"full": res.mrr["full"], "pruned": encode_cli.mrr_at_10(i32),
           "pruned_int8": res.mrr["pruned"]}
    if not (torch.isfinite(D).all() and torch.isfinite(Q).all()):
        raise AssertionError("encoder (c): embeddings not finite")
    if not (index_int8.dtype == torch.int8 and torch.equal(index_int8.scale, two_pass[1])):
        raise AssertionError("encoder (c): the int8 index is not under the two-pass scale")
    if fused_max > 1 or fused_frac > 1e-3:
        raise AssertionError(f"encoder (c): fused int8 build differs on {fused_frac}")
    del two_pass

    with counters.uncounted():
        searched = {"full": (D, Q, None, res.results["full"]),
                    "f32": (index_f32.vectors, qhat, None, (s32, i32)),
                    "int8": (index_int8.vectors, qhat, index_int8.scale, res.results["pruned"])}
        for name, (Dx, q, scale, got) in searched.items():
            q = (q if scale is None else q * scale[None, :]).contiguous()
            want = topk_score.topk_score_plain(Dx, q, k=K)
            err, eq, near = compare_topk(*want, *got, f"encoder (c) {name}")
            item, nq, mx = Dx.element_size(), q.shape[0], Dx.shape[1]
            rows[f"topk_score_encoder_{name}"] = dict(
                shape=[n, mx, nq, K], store="int8" if scale is not None else "f32",
                max_abs_err=err, ids_equal=eq, near_ties=near,
                ms=cuda_ms(lambda: topk_score.topk_score_cuda(Dx, q, k=K), reps=10),
                plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(Dx, q, k=K), reps=3),
                library_ms=None,
                matmul_topk_ms=(cuda_ms(lambda: torch.topk(q @ Dx.T, K), reps=3)
                                if item == 4 else None),
                bound=bound(item * n * mx + 4 * nq * mx + 8 * nq * K, 2 * nq * n * mx))
        # gram held against the plain version's arithmetic in fp64, as in
        # phase 4
        G, Gp = gram.gram_cuda(D), gram.gram_plain(D)
        D64 = D.double()
        G64 = D64.T @ D64
        del D64
        g64 = float(G64.abs().max())
        g_err = float((G.double() - G64).abs().max())
        before = gram.gram_cuda.cuda_launches
        gram.gram_cuda(D)
        per_call = gram.gram_cuda.cuda_launches - before
        rows["gram_encoder"] = dict(
            shape=[n, d], max_abs_err=g_err, rel_err=g_err / g64,
            plain_f32_rel_err_vs_f64=float((Gp.double() - G64).abs().max()) / g64,
            rel_err_vs_plain_f32=float((G - Gp).abs().max() / Gp.abs().max()),
            cuda_launches_per_call=per_call,
            ms=cuda_ms(lambda: gram.gram_cuda(D), reps=10),
            plain_ms=cuda_ms(lambda: gram.gram_plain(D), reps=10),
            library_ms=cuda_ms(lambda: torch.matmul(D.T, D), reps=10),
            bound=bound(4 * n * d + 4 * d * d, n * d * (d + 1)))
        if g_err / g64 > GRAM_TOL:
            raise AssertionError(f"encoder (c): gram relative error {g_err / g64} vs fp64")
        p1 = pca_project.pca_project_cuda(D, W)
        p_err = float((p1 - pca_project.pca_project_plain(D, W)).abs().max())
        if not torch.equal(p1, res.pruned) or p_err > 1e-4:
            raise AssertionError(f"encoder (c): pca_project error {p_err}")
        rows["pca_project_encoder"] = dict(
            shape=[n, d, m], max_abs_err=p_err,
            ms=cuda_ms(lambda: pca_project.pca_project_cuda(D, W), reps=10),
            plain_ms=cuda_ms(lambda: pca_project.pca_project_plain(D, W), reps=10),
            library_ms=cuda_ms(lambda: torch.matmul(D, W), reps=10),
            bound=bound(4 * n * d + 4 * d * m + 4 * n * m, 2 * n * d * m))
        sc = index_int8.scale
        fused = pca_project.pca_project_quant_cuda(D, W, sc)
        if not torch.equal(fused, index_int8.vectors):
            raise AssertionError("encoder (c): the entry point's int8 rows are not the kernel's")
        qd = (fused.int() - pca_project.pca_project_quant_plain(D, W, sc).int()).abs()
        q_frac, q_max = float((qd != 0).float().mean()), int(qd.max())
        if q_max > 1 or q_frac > 1e-3:
            raise AssertionError(f"encoder (c): pca_project_quant: {q_frac} differ")
        rows["pca_project_quant_encoder"] = dict(
            shape=[n, d, m], max_abs_err=q_max, frac_differ=q_frac,
            ms=cuda_ms(lambda: pca_project.pca_project_quant_cuda(D, W, sc), reps=10),
            plain_ms=cuda_ms(lambda: pca_project.pca_project_quant_plain(D, W, sc), reps=10),
            library_ms=None,
            bound=bound(4 * n * d + 4 * d * m + 4 * m + n * m, 2 * n * d * m))
        del G, Gp, G64, p1, qd, fused
    emit("encoder", step="c_path", n_docs=n, n_queries=Q.shape[0], seq_len=seq, d=d, m=m,
         path_s=t_path, **res.seconds, encode_tokens_per_s=n * seq / res.seconds["encode_s"],
         mrr10=mrr, fused_vs_two_pass_frac_differ=fused_frac,
         ids_vs_plain={k: {kk: rows[f"topk_score_encoder_{k}"][kk]
                           for kk in ("ids_equal", "near_ties", "max_abs_err")}
                       for k in ("full", "f32", "int8")},
         eigenvalue_top3=res.pruner.state.eigenvalues[:3].tolist())
    del res, D, Q, index_f32, index_int8, qhat

    # (d) one layer at the micro-batch, op by op: each op is the layer's
    # own call (layers.py) on the value the layer gives it, and their
    # composition is held bitwise to the layer as encode runs it
    lm = CFG.lm_cfg()
    lp = model.layers[0]
    H, dh, f = lm.n_heads, lm.hd, lm.d_ff
    T = encode_batch * seq
    xr = torch.randn(encode_batch, seq, lm.d_model, generator=g, device=dev).bfloat16()
    pos = torch.arange(seq, dtype=torch.int32, device=dev)

    def layer():
        h, _ = L.apply_attention(lp["attn"], L.apply_layernorm(lp["attn_norm"], xr), pos,
                                 n_heads=H, n_kv_heads=H, head_dim=dh,
                                 rope_theta=lm.rope_theta, mode="bidirectional")
        y = xr + h
        return y + L.apply_mlp(lp["mlp"], L.apply_layernorm(lp["mlp_norm"], y), act="gelu")

    with torch.inference_mode():
        xn = L.apply_layernorm(lp["attn_norm"], xr)
        q0, k0, v = (L.apply_dense(lp["attn"][w], xn).reshape(encode_batch, seq, H, dh)
                     for w in ("wq", "wk", "wv"))
        cos, sin = L.rope_tables(pos, dh, lm.rope_theta)
        q, k = (L.apply_rope(t, cos[None], sin[None]) for t in (q0, k0))
        s_raw = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        s = s_raw / np.sqrt(dh)
        p = torch.softmax(s, dim=-1)
        p16 = p.to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p16, v).reshape(encode_batch, seq, H * dh)
        h = L.apply_dense(lp["attn"]["wo"], o)
        y = xr + h
        yn = L.apply_layernorm(lp["mlp_norm"], y)
        h1 = L.apply_dense(lp["mlp"]["w1"], yn)
        a = L.gelu(h1)
        h3 = L.apply_dense(lp["mlp"]["w3"], yn)
        ag = a * h3
        mo = L.apply_dense(lp["mlp"]["w2"], ag)
        if not (torch.equal(y + mo, layer()) and torch.equal(o, L.dense_attention(
                q, k, v, pos, pos, "bidirectional", keys_padded=False).reshape(o.shape))):
            raise AssertionError("encoder (d): the ops' composition is not the layer")
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_err = float((F.scaled_dot_product_attention(qs, ks, vs).transpose(1, 2)
                          .reshape(o.shape).float() - o.float()).abs().max())
        BHSS = encode_batch * H * seq * seq
        wd, wf = 4 * lm.d_model * lm.d_model, 4 * lm.d_model * f   # f32 weights read
        act, hid = 2 * T * lm.d_model, 2 * T * f                  # bf16 activations
        table = [
            # name, fn, bytes, f32 FLOP, bf16 FLOP
            ("attn_norm (layer norm)", lambda: L.apply_layernorm(lp["attn_norm"], xr),
             2 * act, 0, 0),
            *[(f"{w} projection", lambda w=w: L.apply_dense(lp["attn"][w], xn),
               2 * act + wd, 0, 2 * T * lm.d_model ** 2) for w in ("wq", "wk", "wv")],
            *[(f"RoPE ({w})", lambda t=t: L.apply_rope(t, cos[None], sin[None]), 2 * act, 0, 0)
              for w, t in (("q", q0), ("k", k0))],
            ("QK^T (f32, with the upcasts)",
             lambda: torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()),
             2 * act + 4 * BHSS, 2 * BHSS * dh, 0),
            ("scale (/ sqrt(dh))", lambda: s_raw / np.sqrt(dh), 8 * BHSS, 0, 0),
            ("softmax (f32)", lambda: torch.softmax(s, dim=-1), 8 * BHSS, 0, 0),
            ("cast p to bf16", lambda: p.to(v.dtype), 6 * BHSS, 0, 0),
            ("PV (bf16)", lambda: torch.einsum("bhqk,bkhd->bqhd", p16, v),
             2 * BHSS + 2 * act, 0, 2 * BHSS * dh),
            ("attention (dense_attention, all of it)",
             lambda: L.dense_attention(q, k, v, pos, pos, "bidirectional", keys_padded=False),
             4 * act, 2 * BHSS * dh, 2 * BHSS * dh),
            ("wo projection", lambda: L.apply_dense(lp["attn"]["wo"], o), 2 * act + wd, 0,
             2 * T * lm.d_model ** 2),
            ("residual add (attn)", lambda: xr + h, 3 * act, 0, 0),
            ("mlp_norm (layer norm)", lambda: L.apply_layernorm(lp["mlp_norm"], y),
             2 * act, 0, 0),
            ("w1 product", lambda: L.apply_dense(lp["mlp"]["w1"], yn), act + wf + hid, 0,
             2 * T * lm.d_model * f),
            ("w3 product", lambda: L.apply_dense(lp["mlp"]["w3"], yn), act + wf + hid, 0,
             2 * T * lm.d_model * f),
            ("GELU (bf16)", lambda: L.gelu(h1), 2 * hid, 0, 0),
            ("gate (a * w3 x)", lambda: a * h3, 3 * hid, 0, 0),
            ("w2 product", lambda: L.apply_dense(lp["mlp"]["w2"], ag), hid + wf + act, 0,
             2 * T * lm.d_model * f),
            ("residual add (mlp)", lambda: y + mo, 3 * act, 0, 0),
        ]
        ops_rows = []
        for name, fn, nbytes, f32_flop, bf16_flop in table:
            b_ms, b_by = bound(nbytes, f32_flop, bf16_flop)
            ops_rows.append(dict(op=name, ms=median_ms(fn), bound_ms=b_ms, bound_by=b_by))
        sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs))
        lbf, lff = encoder_flops(T, seq, dataclasses.replace(CFG, n_layers=1))
        layer_ms = median_ms(layer)
    emit("encoder", step="d_layer_ops", micro_batch=[encode_batch, seq], ops=ops_rows,
         layer_ms=layer_ms, layer_bound_ms=bound(2 * act + wd + 3 * wf, lff, lbf)[0],
         sum_of_ops_ms=sum(r["ms"] for r in ops_rows if not r["op"].startswith("attention (")),
         sdpa_library_ms=sdpa_ms, sdpa_vs_dense_attention_max_abs_err=sdpa_err)
    del xr, xn, q0, k0, q, k, v, s_raw, s, p, p16, o, h, y, yn, h1, a, h3, ag, mo, qs, ks, vs
    del model
    torch.cuda.empty_cache()


def train_flops(tokens, seq_len, cfg):
    """(bf16 FLOP, f32 FLOP) of one training step over ``tokens`` tokens:
    the forward (``encoder_flops``), its per-layer recompute, and the
    backward at twice the forward; 6·P_layers·T + 2·P_layers·T in bf16 with
    P·V, and Q·Kᵀ with its two gradients and its recompute in f32."""
    bf, ff = encoder_flops(tokens, seq_len, cfg)
    return 4 * bf, 4 * ff


def phase_train(counters, rows, encode_batch):
    """Phase 14: the bi-encoder's training half at the full width of
    configs/biencoder_msmarco.CFG (bf16 compute, f32 parameters, remat on,
    seq 128 as train_pairs). (a) One step's loss and gradients on 8 pairs
    x 32 tokens on the card and on the CPU from the same seeded weights, f32
    and bf16 compute; (b) the step at the largest power-of-two batch (of
    train_pairs' 4,096) that the card holds, chosen from the peaks at 128
    and 256 pairs and descending on an out-of-memory error: forward,
    backward with its recompute (and a no-grad forward, the recompute's
    share), optimizer, tokens/s, peak memory, against the bound; (c)
    launch.train for 20 steps at 256 pairs, checkpoints every 10 under
    build/train_smoke/: finite, descending; (d) the checkpoint: bytes, the
    blocking host copy and the background write beside a step run during
    it, a bitwise restore, and a resume at step 10 whose step-11 loss is
    the uninterrupted run's; (e) launch.encode --full --steps 20 --batch 256
    --seq-len 128 --quantize-int8 over 100,000 passages: train, encode,
    fit (gram), prune (pca_project), int8 (pca_project_quant), search
    (topk_score), ids against the plain top-k."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.biencoder_msmarco import CFG, SHAPES
    from repro_torch.configs.steps import value_and_grad
    from repro_torch.convert import checkpoint_tree, decay_mask
    from repro_torch.data.tokens import pair_batch
    from repro_torch.kernels import topk_score
    from repro_torch.launch import encode as encode_cli, train as train_cli
    from repro_torch.models.biencoder import contrastive_loss, init_biencoder
    from repro_torch.optim import adamw_init, adamw_update

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    cell = next(s for s in SHAPES if s.name == "train_pairs").dims
    seq, cell_batch = cell["seq_len"], cell["global_batch"]

    # (a) one step's loss and gradients, the card against the CPU
    models = {d: init_biencoder(CFG, generator=torch.Generator().manual_seed(0), device=d)
              .requires_grad_(True) for d in ("cpu", dev)}
    b = pair_batch(0, 0, batch=TRAIN_PARITY_PAIRS, seq_len=TRAIN_PARITY_SEQ, vocab=CFG.vocab)
    parity = {}
    t0 = time.perf_counter()
    for cd in ("float32", "bfloat16"):
        c = dataclasses.replace(CFG, compute_dtype=cd)
        (lc, gc_), (lg, gg) = (value_and_grad(contrastive_loss, m.with_config(c), b)
                               for m in models.values())
        leaf_err = {n: float((gg[n].cpu() - g).abs().max() / g.abs().max().clamp_min(1e-30))
                    for n, g in gc_.items()}
        a = torch.cat([g.flatten() for g in gc_.values()]).double()
        v = torch.cat([gg[n].cpu().flatten() for n in gc_]).double()
        parity[cd] = dict(loss_card=float(lg), loss_cpu=float(lc),
                          loss_rel_err=abs(float(lg) - float(lc)) / abs(float(lc)),
                          grad_max_leaf_rel_err=max(leaf_err.values()),
                          grad_worst_leaf=max(leaf_err, key=leaf_err.get),
                          grad_cos=float(a @ v / a.norm() / v.norm()))
        del gc_, gg, a, v
    emit("train", step="a_parity", pairs=TRAIN_PARITY_PAIRS, seq_len=TRAIN_PARITY_SEQ,
         f32_tol=TRAIN_F32_TOL, bf16_loss_rtol=TRAIN_BF16_LOSS_RTOL, bf16_cos_bar=TRAIN_BF16_COS,
         seconds=time.perf_counter() - t0, **parity)
    f32, b16 = parity["float32"], parity["bfloat16"]
    if (f32["loss_rel_err"] > TRAIN_F32_TOL or f32["grad_max_leaf_rel_err"] > TRAIN_F32_TOL
            or b16["loss_rel_err"] > TRAIN_BF16_LOSS_RTOL or b16["grad_cos"] < TRAIN_BF16_COS):
        raise AssertionError(f"train (a): card against CPU {parity}")
    model = models[dev]
    del models

    # (b) the step at the largest power-of-two batch the card holds
    named = dict(model.named_parameters())
    opt = adamw_init(named, decay_mask(named))
    lr = torch.tensor(1e-4)
    n_params = sum(p.numel() for p in named.values())

    def batch_of(n_pairs, t=0):
        return {k: torch.from_numpy(x).to(dev)
                for k, x in pair_batch(0, t, batch=n_pairs, seq_len=seq, vocab=CFG.vocab).items()}

    def one_step(bt):
        loss, grads = value_and_grad(contrastive_loss, model, bt)
        adamw_update(grads, opt, named, lr)
        return loss

    total = torch.cuda.get_device_properties(0).total_memory
    probes = {}
    for nb in TRAIN_PROBE_BATCHES:
        bt = batch_of(nb)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        one_step(bt)
        torch.cuda.synchronize()
        probes[nb] = torch.cuda.max_memory_allocated()
        del bt
    (b0, p0), (b1, p1) = sorted(probes.items())
    per_pair = (p1 - p0) / (b1 - b0)
    predict = {nb: p0 + per_pair * (nb - b0) for nb in (cell_batch, cell_batch // 2,
                                                         cell_batch // 4, cell_batch // 8)}
    tries, fits = [], None
    for nb in sorted(predict, reverse=True):
        if predict[nb] > total:
            tries.append(dict(batch=nb, predicted_peak_gb=predict[nb] / 1e9, tried=False))
            continue
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            bt = batch_of(nb)
            one_step(bt)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            tries.append(dict(batch=nb, predicted_peak_gb=predict[nb] / 1e9, tried=True,
                              oom=str(e).splitlines()[0][:160],
                              peak_at_oom_gb=torch.cuda.max_memory_allocated() / 1e9))
            bt = None
            continue
        tries.append(dict(batch=nb, predicted_peak_gb=predict[nb] / 1e9, tried=True,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        fits = nb
        break
    if fits is None:
        raise AssertionError(f"train (b): no batch of {sorted(predict)} fits: {tries}")
    torch.cuda.reset_peak_memory_stats()
    parts = {"forward": [], "backward": [], "optimizer": [], "no_grad_forward": []}
    for _ in range(TRAIN_TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        with torch.enable_grad():
            loss = contrastive_loss(model, bt)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(named.values()))
        ev[2].record()
        adamw_update(dict(zip(named, grads)), opt, named, lr)
        ev[3].record()
        del grads, loss
        with torch.no_grad():
            contrastive_loss(model, bt)
        ev[4].record()
        ev[4].synchronize()
        for i, k in enumerate(("forward", "backward", "optimizer", "no_grad_forward")):
            parts[k].append(ev[i].elapsed_time(ev[i + 1]))
    peak = torch.cuda.max_memory_allocated()
    med = {k: sorted(v)[len(v) // 2] for k, v in parts.items()}
    step_ms = med["forward"] + med["backward"] + med["optimizer"]
    tokens = 2 * fits * seq
    bf, ff = train_flops(tokens, seq, CFG)
    fb, fs = encoder_flops(tokens, seq, CFG)
    bounds = {
        "step": bound(4 * 7 * n_params, ff, bf),
        "forward": bound(4 * n_params, fs, fb),
        "backward": bound(4 * 2 * n_params, 3 * fs, 3 * fb),     # recompute + 2x forward
        "recompute": bound(4 * n_params, fs, fb),
        "optimizer": bound(4 * 7 * n_params, 0),    # p, g, mu, nu read; p, mu, nu written
    }
    emit("train", step="b_step", batch=fits, seq_len=seq, cell_batch=cell_batch,
         tokens=tokens, probe_peak_gb={str(k): v / 1e9 for k, v in probes.items()},
         per_pair_gb=per_pair / 1e9, card_memory_gb=total / 1e9, tries=tries,
         ms={k: med[k] for k in ("forward", "backward", "optimizer")},
         recompute_ms_est=med["no_grad_forward"], step_ms=step_ms,
         tokens_per_s=tokens / step_ms * 1e3, peak_allocated_gb=peak / 1e9,
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()}, bf16_flop=bf, f32_flop=ff,
         timed_steps=TRAIN_TIMED_STEPS, all_ms=parts)
    del bt, model, named, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (c) launch.train: 20 steps at full width, checkpoints every 10
    root = os.path.join(HERE, "build", "train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    ckpt = os.path.join(root, "ck")
    run = dict(steps=TRAIN_RUN_STEPS, smoke=False, ckpt_dir=ckpt, ckpt_every=TRAIN_CKPT_EVERY,
               seed=0, batch=TRAIN_RUN_BATCH, device=dev, log_every=TRAIN_CKPT_EVERY)
    t0 = time.perf_counter()
    out = train_cli.train("biencoder-msmarco", resume="none", **run)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    losses = out["losses"]
    emit("train", step="c_steps", batch=TRAIN_RUN_BATCH, seq_len=seq, steps=out["steps_run"],
         seconds=t_run, first_loss=losses[0], last_loss=losses[-1], losses=losses)
    if not (len(losses) == TRAIN_RUN_STEPS and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"train (c): losses not finite and descending: {losses}")

    # (d) the checkpoint: a bitwise restore of step 20, a timed save with a
    # step run during its write, and a resume at step 10
    model, opt = out["model"], out["opt_state"]
    mgr = CheckpointManager(ckpt)
    tree = checkpoint_tree(model, opt)
    back, at = mgr.restore(tree)
    leaves = lambda t: [x for v in t for x in _tree_leaves(v)]
    bitwise = all(torch.equal(x, y) for x, y in zip(leaves(tree), leaves(back)))
    step_dir = os.path.join(ckpt, f"step_{at:010d}")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
    del back
    timed = CheckpointManager(os.path.join(root, "timed"), keep_n=1)
    bt = batch_of(TRAIN_RUN_BATCH, TRAIN_RUN_STEPS)
    named = dict(model.named_parameters())
    step_times = []
    del tree
    for during in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if during:
            timed.save(at + 1, checkpoint_tree(model, opt))
            t_copy = time.perf_counter() - t0
        loss, grads = value_and_grad(contrastive_loss, model, bt)
        adamw_update(grads, opt, named, lr)
        float(loss)
        step_times.append(time.perf_counter() - t0)
        del grads
    writing_after_step = any(t.is_alive() for t in timed._pending)
    timed.wait()
    t_save = time.perf_counter() - t0
    shutil.rmtree(os.path.join(ckpt, f"step_{at:010d}"))       # leaves step 10 the latest
    res_out = train_cli.train("biencoder-msmarco", resume="auto",
                              **{**run, "steps": 1, "log_every": 0})
    resumed = res_out["losses"][0]
    emit("train", step="d_checkpoint", step_restored=at, bytes=nbytes, restore_bitwise=bitwise,
         save_host_copy_s=t_copy, save_total_s=t_save, step_s_alone=step_times[0],
         step_s_with_save=step_times[1] - t_copy, save_still_writing_after_step=writing_after_step,
         resumed_at=TRAIN_CKPT_EVERY, resumed_loss=resumed,
         uninterrupted_loss=losses[TRAIN_CKPT_EVERY],
         resumed_rel_err=abs(resumed - losses[TRAIN_CKPT_EVERY]) / abs(losses[TRAIN_CKPT_EVERY]))
    if not bitwise or abs(resumed - losses[TRAIN_CKPT_EVERY]) > 1e-5 * abs(resumed):
        raise AssertionError(f"train (d): restore bitwise {bitwise}, resumed loss {resumed} "
                             f"against {losses[TRAIN_CKPT_EVERY]}")
    del out, res_out, model, opt, bt, named
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the entry point: train, then encode, fit, prune, build int8, search
    args = encode_cli.parse_args([
        "--full", "--steps", str(TRAINED_STEPS), "--batch", str(TRAINED_BATCH),
        "--seq-len", str(TRAINED_SEQ), "--n-docs", str(TRAINED_DOCS),
        "--n-queries", str(ENCODE_QUERIES), "--cutoff", str(CUTOFF), "--quantize-int8",
        "--encode-batch", str(encode_batch), "--device", str(dev), "--json"])
    t0 = time.perf_counter()
    res = encode_cli.run(args)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    ids_vs_plain = {}
    with counters.uncounted():
        qhat = res.pruner.transform_queries(res.Q)
        for name, (Dx, q, scale) in {"full": (res.D, res.Q, None),
                                     "int8": (res.index.vectors, qhat, res.index.scale)}.items():
            q = (q if scale is None else q * scale[None, :]).contiguous()
            want = topk_score.topk_score_plain(Dx, q, k=K)
            got = res.results["full" if name == "full" else "pruned"]
            err, eq, near = compare_topk(*want, *got, f"train (e) {name}")
            ids_vs_plain[name] = dict(ids_equal=eq, near_ties=near, max_abs_err=err)
    if not (torch.isfinite(res.D).all() and torch.isfinite(res.Q).all()
            and all(np.isfinite(res.losses)) and len(res.losses) == TRAINED_STEPS):
        raise AssertionError("train (e): losses or embeddings not finite")
    emit("train", step="e_trained_path", steps=TRAINED_STEPS, batch=TRAINED_BATCH,
         seq_len=TRAINED_SEQ, n_docs=res.D.shape[0], n_queries=res.Q.shape[0],
         m=res.pruner.kept_dims, index_dtype=str(res.index.dtype), path_s=t_path,
         **res.seconds, first_loss=res.losses[0], last_loss=res.losses[-1], mrr10=res.mrr,
         ids_vs_plain=ids_vs_plain)
    del res, qhat
    gc.collect()
    torch.cuda.empty_cache()


def lm_bound(cfg, *, kind, B, S, pos=None, n_layers=None):
    """(bytes, f32 FLOP, bf16 FLOP) that one call of the LM's ``kind`` step
    must move and do, counted as the port's functions compute it: bf16
    parameters (training: f32 with their gradient and AdamW's two moments,
    28 bytes each), the products of every parameter with every token (6x
    for a training step: forward and backward), and attention in f32 over
    every tile it computes (blocked self-attention computes masked tiles
    too; a decode step scores all S cache slots)."""
    L = n_layers or cfg.n_layers
    d, V, H, hd = cfg.d_model, cfg.vocab, cfg.n_heads, cfg.hd
    kv = cfg.n_kv_heads * hd
    P = cfg.param_count()
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    P_layers = P - emb - d
    if kind == "train":
        tokens = B * S
        f32 = 3 * 4 * B * S * S * H * hd * L            # Q·Kᵀ and P·V, forward + backward
        return 28 * P, f32, 6 * P * tokens
    if kind == "prefill":
        blk = -(-S // cfg.attn_q_chunk) * cfg.attn_q_chunk
        f32 = 4 * B * blk * blk * H * hd * L if S > cfg.blocked_attn_threshold else \
            4 * B * S * S * H * hd * L
        bf16 = 2 * P_layers * B * S + 2 * V * d * B
        return 2 * P + 2 * L * B * S * kv * 2, f32, bf16
    # decode / decode_long: every cache slot scored, the slots up to pos read
    live = min(pos + 1, S)
    f32 = 4 * B * S * H * hd * L
    bf16 = 2 * (P_layers + V * d) * B
    return 2 * P + 2 * L * B * live * kv * 2, f32, bf16


def _leaf_err(a, b):
    """max |a - b| over max |b|, on the CPU in f64."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _cos_t(a, b):
    a, b = a.detach().double().cpu().flatten(), b.detach().double().cpu().flatten()
    return float(a @ b / a.norm() / b.norm())


def phase_lm(counters):
    """Phase 15: the decoder-LM family. (a) Card against CPU on the smoke
    configs of qwen2 (QKV bias, tied embeddings), mixtral (MoE, sliding
    window) and arctic (dense residual, Adafactor), the same seeded weights
    and tokens: f32 loss, prefill and decode logits and each gradient leaf
    within LM_F32_TOL, the MoE aux loss within LM_AUX_TOL, the arch's
    optimizer step from the same gradients within 1e-6, bf16 loss and
    gradient cosine >= LM_BF16_COS. (b) qwen2-1.5b at full width, bf16
    weights: prefill at prefill_32k's 32,768 tokens, decode_step against
    decode_32k's static 32,768-slot cache at the largest batch the card
    holds (picked from the peaks at 1 and 2 sequences), each against its
    bound; and decode at position p equal to the full forward's logits at
    p on a short prompt (f32 compute). (c) qwen2-1.5b, one train step at
    seq 4,096 in 4 micro-batches at the largest global batch that fits:
    forward, backward and optimizer ms, tokens/s against the bound, peak.
    (d) mixtral-8x7b at full width with its depth cut to MIXTRAL_LAYERS:
    prefill of the 4,096-token window, then decode_step_sliding at B 1 past
    position 524,000 (the rolling buffer wrapped), ms a step and the MoE
    layers' share. (e) launch.train --arch smollm-135m (full config, 20
    steps at a cut batch, checkpoints every 10 under build/lm_smoke/): the
    manifest's specs equal param_specs on the run's mesh, a resume from
    step 10 replays step 11 bitwise, and an elastic restore onto a (2, 2)
    mesh of the card's slots gives the saved values."""
    import dataclasses
    import json as _json
    import shutil
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry, steps
    from repro_torch.data.tokens import token_batch
    from repro_torch.launch import train as train_cli
    from repro_torch.models import moe as M, transformer as T
    from repro_torch.optim import adafactor_update, adamw_update
    from repro_torch.par import sharding as SH
    from repro_torch.par.mesh import make_mesh
    from repro_torch.util import flatten_with_paths

    dev = torch.device("cuda")
    total = torch.cuda.get_device_properties(0).total_memory
    gc.collect()
    torch.cuda.empty_cache()

    # (a) card against CPU on the smoke configs
    t0 = time.perf_counter()
    parity, bad = {}, []
    for arch in LM_PARITY_ARCHS:
        cfg = registry.get_smoke_cfg(arch)
        models = {d: T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device=d)
                  for d in ("cpu", dev)}
        b = token_batch(0, 0, batch=4, seq_len=32, vocab=cfg.vocab)
        r = {}
        for cd in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, compute_dtype=cd)
            out = {}
            for d, m in models.items():
                mm = m.with_config(c).requires_grad_(True)
                out[d] = steps.value_and_grad(steps._lm_loss, mm, b)
                mm.requires_grad_(False)
            (lc, gc_), (lg, gg) = out["cpu"], out[dev]
            if cd == "float32":
                r["loss_rel_err"] = abs(float(lg) - float(lc)) / abs(float(lc))
                errs = {n: _leaf_err(gg[n], g) for n, g in gc_.items()}
                r["grad_max_leaf_rel_err"] = max(errs.values())
                r["grad_worst_leaf"] = max(errs, key=errs.get)
                # the arch's optimizer from the CPU's gradients on both sides
                opt = registry.get_arch(arch).optimizer
                init, update = steps._opt_pack(opt)
                moved = {}
                for d, m in models.items():
                    mm = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device=d)
                    mm.requires_grad_(True)
                    named = dict(mm.named_parameters())
                    update({n: g.to(d) for n, g in gc_.items()}, init(mm), named,
                           torch.tensor(1e-2))
                    moved[d] = named
                r["optimizer"] = opt
                r["optimizer_step_max_abs_err"] = max(
                    float((moved[dev][n].detach().cpu() - p.detach()).abs().max())
                    for n, p in moved["cpu"].items())
                with torch.no_grad():
                    aux = {d: T.forward_hidden(m.with_config(c), b["tokens"])[1]
                           for d, m in models.items()}
                r["aux_cpu"], r["aux_abs_err"] = float(aux["cpu"]), abs(
                    float(aux[dev]) - float(aux["cpu"]))
                # prefill, then decode (static cache; mixtral: also the rolling buffer)
                lo = {}
                for d, m in models.items():
                    mc = m.with_config(c)
                    pl, cache = T.prefill(mc, b["tokens"][:, :24], cache_len=32)
                    dl, _ = T.decode_step(mc, cache, b["tokens"][:, 24], 24)
                    seq = [pl, dl]
                    if cfg.sliding_window:
                        W = cfg.sliding_window
                        _, rc = T.prefill(mc, b["tokens"], cache_len=W)
                        seq.append(T.decode_step_sliding(mc, rc, b["tokens"][:, 0], 3 * W + 5)[0])
                    lo[d] = seq
                r["logits_max_abs_err"] = max(float((x.cpu() - y).abs().max())
                                              for x, y in zip(lo[dev], lo["cpu"]))
                if (r["loss_rel_err"] > LM_F32_TOL or r["grad_max_leaf_rel_err"] > LM_F32_TOL
                        or r["logits_max_abs_err"] > LM_F32_TOL
                        or r["aux_abs_err"] > LM_AUX_TOL
                        or r["optimizer_step_max_abs_err"] > 1e-6):
                    bad.append(arch)
            else:
                r["bf16_loss_rel_err"] = abs(float(lg) - float(lc)) / abs(float(lc))
                r["bf16_grad_cos"] = _cos_t(torch.cat([gg[n].cpu().flatten() for n in gc_]),
                                            torch.cat([g.flatten() for g in gc_.values()]))
                if r["bf16_loss_rel_err"] > 1e-2 or r["bf16_grad_cos"] < LM_BF16_COS:
                    bad.append(arch + ":bf16")
            del out, gc_, gg
        parity[arch] = r
    emit("lm", step="a_parity", seconds=time.perf_counter() - t0, f32_tol=LM_F32_TOL,
         aux_tol=LM_AUX_TOL, bf16_cos_bar=LM_BF16_COS, **parity)
    if bad:
        raise AssertionError(f"lm (a): card against CPU out of bounds for {bad}: {parity}")
    del models

    # (b) qwen2-1.5b at full width, serving
    spec = registry.get_arch(SERVE_ARCH)
    cfg = dataclasses.replace(spec.cfg, param_dtype="bfloat16")
    S = spec.cell("prefill_32k").dims["seq_len"]
    S_dec = spec.cell("decode_32k").dims["seq_len"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = T.init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    rng = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (PREFILL_BATCH, S), generator=rng, device=dev,
                           dtype=torch.int32)
    T.prefill(model, prompt[:, :2048])                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    logits, cache = T.prefill(model, prompt)
    ev[1].record()
    ev[1].synchronize()
    prefill_ms = ev[0].elapsed_time(ev[1])
    prefill_peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(logits).all()) or tuple(cache[0].shape) != (
            cfg.n_layers, PREFILL_BATCH, S, cfg.n_kv_heads, cfg.hd):
        raise AssertionError("lm (b): prefill logits not finite or cache misshapen")
    del logits, cache
    pb, pf, pbf = lm_bound(cfg, kind="prefill", B=PREFILL_BATCH, S=S)
    p_bound = bound(pb, pf, pbf)

    # decode at p against the full forward (f32 compute), a short prompt
    c32 = model.with_config(dataclasses.replace(cfg, compute_dtype="float32"))
    short = prompt[:, :LM_CHECK_PROMPT + 1]
    with torch.no_grad():
        h, _ = T.forward_hidden(c32, short)
        full = T._unembed(c32, h)[:, LM_CHECK_PROMPT]
    _, cache = T.prefill(c32, short[:, :LM_CHECK_PROMPT], cache_len=LM_CHECK_PROMPT + 1)
    step_logits, _ = T.decode_step(c32, cache, short[:, LM_CHECK_PROMPT], LM_CHECK_PROMPT)
    dec_err = float((step_logits - full).abs().max())
    dec_ok = bool(torch.allclose(step_logits, full, rtol=1e-4, atol=1e-4))
    del h, full, cache, step_logits, c32

    # decode_step against decode_32k's cache: the batch from the peaks at 1 and 2
    def decode_peak(Bd):
        shape = (cfg.n_layers, Bd, S_dec, cfg.n_kv_heads, cfg.hd)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kc = torch.randn(shape, generator=rng, device=dev, dtype=torch.bfloat16)
        vc = torch.randn(shape, generator=rng, device=dev, dtype=torch.bfloat16)
        tok = torch.randint(0, cfg.vocab, (Bd,), generator=rng, device=dev, dtype=torch.int32)
        lg, _ = T.decode_step(model, (kc, vc), tok, S_dec - 1)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(), (kc, vc, tok, lg)

    p1 = decode_peak(1)[0]
    p2 = decode_peak(2)[0]
    per_seq = p2 - p1
    predict = {bd: p1 + per_seq * (bd - 1) for bd in DECODE_BATCHES}
    tries, fits, st = [], None, None
    for bd in sorted(predict, reverse=True):
        if predict[bd] > 0.95 * total:
            tries.append(dict(batch=bd, predicted_peak_gb=predict[bd] / 1e9, tried=False))
            continue
        try:
            peak, st = decode_peak(bd)
        except torch.cuda.OutOfMemoryError as e:
            tries.append(dict(batch=bd, predicted_peak_gb=predict[bd] / 1e9, tried=True,
                              oom=str(e).splitlines()[0][:160]))
            st = None
            continue
        tries.append(dict(batch=bd, predicted_peak_gb=predict[bd] / 1e9, tried=True,
                          peak_gb=peak / 1e9))
        fits = bd
        break
    if fits is None:
        raise AssertionError(f"lm (b): no decode batch fits: {tries}")
    kc, vc, tok, lg = st
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("lm (b): decode logits not finite")
    dec_ms = median_ms(lambda: T.decode_step(model, (kc, vc), tok, S_dec - 1), reps=3)
    db, df, dbf = lm_bound(cfg, kind="decode", B=fits, S=S_dec, pos=S_dec - 1)
    d_bound = bound(db, df, dbf)
    emit("lm", step="b_serve", arch=SERVE_ARCH, weights_gb=weights / 1e9,
         prefill=dict(batch=PREFILL_BATCH, cell_batch=spec.cell("prefill_32k").dims[
             "global_batch"], seq_len=S, ms=prefill_ms, ms_per_token=prefill_ms / (
                 PREFILL_BATCH * S), tokens_per_s=PREFILL_BATCH * S / prefill_ms * 1e3,
             peak_gb=prefill_peak / 1e9, bound_ms=p_bound[0], bound_by=p_bound[1],
             bytes=pb, f32_flop=pf, bf16_flop=pbf),
         decode=dict(batch=fits, cell_batch=spec.cell("decode_32k").dims["global_batch"],
                     cache_slots=S_dec, pos=S_dec - 1, ms=dec_ms, ms_per_token=dec_ms / fits,
                     tokens_per_s=fits / dec_ms * 1e3, peak_gb=tries[-1]["peak_gb"],
                     peak_1_gb=p1 / 1e9, per_sequence_gb=per_seq / 1e9, tries=tries,
                     cache_gb=2 * kc.numel() * kc.element_size() / 1e9,
                     bound_ms=d_bound[0], bound_by=d_bound[1], bytes=db, f32_flop=df,
                     bf16_flop=dbf),
         decode_vs_full=dict(prompt=LM_CHECK_PROMPT, compute="float32",
                             max_abs_err=dec_err, allclose_1e4=dec_ok))
    if not dec_ok:
        raise AssertionError(f"lm (b): decode at {LM_CHECK_PROMPT} differs from the full "
                             f"forward by {dec_err}")
    del model, kc, vc, tok, lg, st, prompt
    gc.collect()
    torch.cuda.empty_cache()

    # (c) one qwen2-1.5b train step, seq 4,096, 4 micro-batches
    cfg = spec.cfg
    seq = spec.cell("train_4k").dims["seq_len"]
    model = T.init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    model.requires_grad_(True)
    step, opt_init = steps.make_train_step(steps._lm_loss, "adamw", microbatch=LM_TRAIN_K,
                                           accum_dtype=cfg.grad_accum_dtype)
    opt = opt_init(model)
    named = dict(model.named_parameters())

    def lm_batch(nb, t=0):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in token_batch(0, t, batch=nb, seq_len=seq, vocab=cfg.vocab).items()}

    def train_peak(nb):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bt = lm_batch(nb)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = step(model, opt, bt)
        ev[1].record()
        ev[1].synchronize()
        return torch.cuda.max_memory_allocated(), bt, out, ev[0].elapsed_time(ev[1])

    # the peaks at the two smallest global batches predict the rest; the
    # largest predicted to fit is tried (descending on an out-of-memory
    # error), and its step, the first at that batch, is the one timed
    (q0, _, _, _), (q1, _, _, _) = (train_peak(nb) for nb in LM_TRAIN_PROBES)
    per_seq_train = (q1 - q0) / (LM_TRAIN_PROBES[1] - LM_TRAIN_PROBES[0])
    tries, fits = [], None
    for nb in LM_TRAIN_BATCHES:
        pred = q0 + per_seq_train * (nb - LM_TRAIN_PROBES[0])
        if pred > 0.9 * total:
            tries.append(dict(batch=nb, predicted_peak_gb=pred / 1e9, tried=False))
            continue
        try:
            peak, bt, out, step_ms = train_peak(nb)
        except torch.cuda.OutOfMemoryError as e:
            tries.append(dict(batch=nb, predicted_peak_gb=pred / 1e9, tried=True,
                              oom=str(e).splitlines()[0][:160]))
            bt = out = None
            continue
        tries.append(dict(batch=nb, predicted_peak_gb=pred / 1e9, tried=True,
                          peak_gb=peak / 1e9))
        fits = nb
        break
    if fits is None:
        raise AssertionError(f"lm (c): no train batch fits: {tries}")
    # one micro-batch's forward and backward, and the optimizer, alone
    mb = {k: v[:fits // LM_TRAIN_K] for k, v in bt.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    with torch.enable_grad():
        loss = steps._lm_loss(model, mb)
    ev[1].record()
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    ev[2].record()
    adamw_update(grads, opt, named, torch.tensor(1e-4))
    ev[3].record()
    ev[3].synchronize()
    fwd, bwd, optm = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    del grads, loss
    tokens = fits * seq
    tb, tf, tbf = lm_bound(cfg, kind="train", B=fits, S=seq)
    t_bound = bound(tb, tf, tbf)
    emit("lm", step="c_train", arch=SERVE_ARCH, batch=fits, seq_len=seq,
         microbatch=LM_TRAIN_K, cell_batch=spec.cell("train_4k").dims["global_batch"],
         probe_peak_gb={str(nb): q / 1e9 for nb, q in zip(LM_TRAIN_PROBES, (q0, q1))},
         per_sequence_gb=per_seq_train / 1e9, tries=tries, loss=float(out["loss"]),
         step_ms=step_ms, microbatch_ms=dict(forward=fwd, backward=bwd), optimizer_ms=optm,
         tokens=tokens, tokens_per_s=tokens / step_ms * 1e3, peak_gb=peak / 1e9,
         bound_ms=t_bound[0], bound_by=t_bound[1], bytes=tb, f32_flop=tf, bf16_flop=tbf)
    if not np.isfinite(float(out["loss"])):
        raise AssertionError("lm (c): non-finite loss")
    del model, opt, named, bt, mb, out, step
    gc.collect()
    torch.cuda.empty_cache()

    # (d) mixtral-8x7b, depth cut: prefill the window, then the rolling buffer past 524,000
    mspec = registry.get_arch("mixtral-8x7b")
    mcfg = dataclasses.replace(mspec.cfg, param_dtype="bfloat16", n_layers=MIXTRAL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = T.init_lm(mcfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    W = mcfg.sliding_window
    B_long = mspec.cell("long_500k").dims["global_batch"]
    win = torch.randint(0, mcfg.vocab, (B_long, W), generator=rng, device=dev,
                        dtype=torch.int32)
    T.prefill(model, win[:, :512])
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    _, cache = T.prefill(model, win, cache_len=W)
    ev[1].record()
    ev[1].synchronize()
    m_prefill_ms = ev[0].elapsed_time(ev[1])
    pos = [LONG_POS]

    def long_step():
        lg, _ = T.decode_step_sliding(model, cache, win[:, pos[0] % W], pos[0])
        pos[0] += 1
        return lg

    lg = long_step()
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("lm (d): decode_step_sliding logits not finite")
    m_step_ms = median_ms(long_step, reps=5)
    xn = torch.randn((B_long, 1, mcfg.d_model), generator=rng, device=dev,
                     dtype=torch.bfloat16)
    with torch.no_grad():
        moe_ms = median_ms(lambda: [M.apply_moe(
            lp["moe"], xn, n_experts=mcfg.n_experts, top_k=mcfg.top_k,
            capacity_factor=mcfg.capacity_factor, group_size=mcfg.moe_group_size,
            act=mcfg.act, compute_dtype=mcfg.cdt) for lp in model.layers], reps=5)
    lb, lf, lbf = lm_bound(mcfg, kind="decode_long", B=B_long, S=W, pos=LONG_POS)
    l_bound = bound(lb, lf, lbf)
    emit("lm", step="d_long", arch="mixtral-8x7b", n_layers=MIXTRAL_LAYERS,
         full_layers=mspec.cfg.n_layers, window=W, batch=B_long,
         weights_gb=sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9,
         prefill_window_ms=m_prefill_ms, first_pos=LONG_POS, wrapped_slot=LONG_POS % W,
         ms_per_step=m_step_ms, moe_ms=moe_ms, moe_share=moe_ms / m_step_ms,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, bound_ms=l_bound[0],
         bound_by=l_bound[1], bytes=lb, f32_flop=lf, bf16_flop=lbf)
    del model, cache, win, lg, xn
    gc.collect()
    torch.cuda.empty_cache()

    # (e) launch.train --arch smollm-135m, full config, checkpoints, resume, elastic restore
    root = os.path.join(HERE, "build", "lm_smoke")
    shutil.rmtree(root, ignore_errors=True)
    ckpt = os.path.join(root, "ck")
    run = dict(steps=LM_RUN_STEPS, smoke=False, ckpt_dir=ckpt, ckpt_every=LM_RUN_CKPT_EVERY,
               seed=0, batch=LM_RUN_BATCH, device=dev, log_every=LM_RUN_CKPT_EVERY)
    t0 = time.perf_counter()
    res = train_cli.train("smollm-135m", resume="none", **run)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    losses = res["losses"]
    bundle = res["bundle"]
    at = LM_RUN_STEPS
    with open(os.path.join(ckpt, f"step_{at:010d}", "manifest.json")) as f:
        manifest = {e["path"]: e["spec"] for e in _json.load(f)["leaves"]}
    named = dict(res["model"].named_parameters())
    pspec = SH.param_specs(convert.reference_shapes(named), bundle.mesh,
                           SH.lm_rules_dp_only())
    want = {f"0/{p}": s.to_json() for p, s in flatten_with_paths(pspec)}
    specs_ok = all(manifest[p] == s for p, s in want.items()) and all(
        manifest[p] == s.to_json() for p, s in flatten_with_paths(bundle.in_specs[:2]))
    # elastic restore of step 20 onto a (2, 2) mesh of the card's slots
    tree = convert.checkpoint_tree(res["model"], res["opt_state"])
    mesh22 = make_mesh((2, 2), ("data", "model"), dev)
    placed, _ = CheckpointManager(ckpt).restore(tree, at, mesh=mesh22)
    saved = dict(flatten_with_paths(tree))
    elastic_ok, sharded_leaves = True, 0
    for p, st in flatten_with_paths(placed):
        elastic_ok &= bool(torch.equal(st.full(), saved[p]))
        for slot, s in enumerate(st.shards):
            elastic_ok &= bool(torch.equal(
                s, saved[p][SH.shard_index(st.shape, st.spec, mesh22, slot)]))
        sharded_leaves += any(part is not None for part in st.spec)
    del placed, tree
    # resume from step 10: step 11's loss bitwise
    shutil.rmtree(os.path.join(ckpt, f"step_{at:010d}"))
    res2 = train_cli.train("smollm-135m", resume="auto", **{**run, "steps": 1, "log_every": 0})
    resumed = res2["losses"][0]
    emit("lm", step="e_launch_train", arch="smollm-135m", batch=LM_RUN_BATCH,
         seq_len=bundle.meta["dims"]["seq_len"], microbatch=bundle.meta["microbatch"],
         steps=res["steps_run"], seconds=t_run, first_loss=losses[0], last_loss=losses[-1],
         mesh=list(bundle.mesh.shape), manifest_specs_equal_param_specs=specs_ok,
         elastic_mesh=[2, 2], elastic_bitwise=elastic_ok, elastic_sharded_leaves=sharded_leaves,
         resumed_at=LM_RUN_CKPT_EVERY, resumed_loss=resumed,
         uninterrupted_loss=losses[LM_RUN_CKPT_EVERY],
         resume_bitwise=resumed == losses[LM_RUN_CKPT_EVERY])
    if not (len(losses) == LM_RUN_STEPS and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"lm (e): losses not finite and descending: {losses}")
    if not (specs_ok and elastic_ok and resumed == losses[LM_RUN_CKPT_EVERY]):
        raise AssertionError(f"lm (e): specs {specs_ok}, elastic {elastic_ok}, resumed "
                             f"{resumed} against {losses[LM_RUN_CKPT_EVERY]}")
    del res, res2
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()


def topk_row(D, q, k, *, n_valid=None, reps=10):
    """A kernel row for one top-k shape: the kernel against its plain
    version (ids up to near-ties, scores at TOL), their times, matmul +
    topk beside them where D is f32, and the bound (each row read once)."""
    import torch
    from repro_torch.kernels import topk_score
    want = topk_score.topk_score_plain(D, q, k=k, n_valid=n_valid)
    got = topk_score.topk_score_cuda(D, q, k=k, n_valid=n_valid)
    n, m = D.shape
    nv = n if n_valid is None else max(0, min(int(n_valid), n))
    err, eq, near = compare_topk(*want, *got, f"recsys top-k {tuple(D.shape)} {D.dtype}")
    item, B = D.element_size(), q.shape[0]
    return dict(
        shape=[n, m, B, k], store={1: "int8", 4: "f32"}[item], n_valid=nv,
        max_abs_err=err, ids_equal=eq, near_ties=near,
        ms=cuda_ms(lambda: topk_score.topk_score_cuda(D, q, k=k, n_valid=n_valid), reps=reps),
        plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(D, q, k=k, n_valid=n_valid),
                         reps=3),
        library_ms=None,
        matmul_topk_ms=(cuda_ms(lambda: torch.topk(q @ D[:nv].T, k), reps=reps)
                        if item == 4 else None),
        bound=bound(item * nv * m + 4 * B * m + 8 * B * k, 2 * B * nv * m))


def gram_row(D):
    """A kernel row for ``gram`` at D's shape, held to the plain version's
    product in fp64 (as phase 4 holds it)."""
    import torch
    from repro_torch.kernels import gram
    n, d = D.shape
    G, Gp = gram.gram_cuda(D), gram.gram_plain(D)
    D64 = D.double()
    G64 = D64.T @ D64
    del D64
    g64 = float(G64.abs().max())
    g_err = float((G.double() - G64).abs().max())
    if g_err / g64 > GRAM_TOL:
        raise AssertionError(f"recsys: gram relative error {g_err / g64} at {tuple(D.shape)}")
    return dict(shape=[n, d], max_abs_err=g_err, rel_err=g_err / g64,
                plain_f32_rel_err_vs_f64=float((Gp.double() - G64).abs().max()) / g64,
                ms=cuda_ms(lambda: gram.gram_cuda(D), reps=10),
                plain_ms=cuda_ms(lambda: gram.gram_plain(D), reps=10),
                library_ms=cuda_ms(lambda: torch.matmul(D.T, D), reps=10),
                bound=bound(4 * n * d + 4 * d * d, n * d * (d + 1)))


def pca_project_row(D, W, want=None):
    """A kernel row for ``pca_project`` at D's and W's shapes; ``want`` (the
    path's output) must be within 1e-4 of the kernel's, and whether it is
    bitwise is recorded."""
    import torch
    from repro_torch.kernels import pca_project
    n, d = D.shape
    m = W.shape[1]
    p1 = pca_project.pca_project_cuda(D, W)
    err = float((p1 - pca_project.pca_project_plain(D, W)).abs().max())
    path_err = 0.0 if want is None else float((p1 - want).abs().max())
    if err > 1e-4 or path_err > 1e-4:
        raise AssertionError(f"recsys: pca_project error {err}, against the path's "
                             f"{path_err} at {tuple(D.shape)}")
    return dict(shape=[n, d, m], max_abs_err=err,
                path_bitwise=want is None or bool(torch.equal(p1, want)),
                ms=cuda_ms(lambda: pca_project.pca_project_cuda(D, W), reps=10),
                plain_ms=cuda_ms(lambda: pca_project.pca_project_plain(D, W), reps=10),
                library_ms=cuda_ms(lambda: torch.matmul(D, W), reps=10),
                bound=bound(4 * n * d + 4 * d * m + 4 * n * m, 2 * n * d * m))


def recsys_batch(cfg, B, t=0):
    from repro_torch.data.recsys import ctr_batch, two_tower_batch
    if cfg.kind == "two_tower":
        return two_tower_batch(0, t, batch=B, user_vocab=cfg.user_vocab,
                               item_vocab=cfg.item_vocab)
    return ctr_batch(0, t, batch=B, vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)


def bundle_bound(meta):
    """The least time of a bundle's step from its analytic bytes and model
    FLOPs (f32: the recsys family computes in f32)."""
    return bound(meta["analytic_bytes"], meta["model_flops"])


def phase_recsys(counters, rows):
    """Phase 16: the recsys family. (a) The smoke configs of all four archs
    on the card against the CPU from the same seeded weights and batch: f32
    loss and gradients per leaf, the arch's step (the rowwise step for
    DLRM, DeepFM and AutoInt, AdamW for the two-tower) on parameters,
    tables, accumulators and moments, the CTR forward and the two-tower's
    retrieval ids. (b) The two-tower at full width: the candidate index
    from item_embedding over retrieval_cand's 1,000,448 items, fitted
    (gram) and pruned to m = 128 (pca_project), int8 by the per-dim
    absmax; retrieval_cand through its bundle four ways (full d 256, pruned
    f32, pruned int8, int8 with a 4,096-row delta holding 4,000 new items)
    and the pruned int8 one again under hier_merge on a (2, 2) mesh of the
    card's slots: ids against the plain top-k, each search's ms against its
    bound, recall@100 of the pruned searches against the full one (random
    weights: a check that the pieces connect). compress_tables over the
    item table (1,048,576 x 256 -> 128). (c) One train_batch step at the
    largest batch that fits (65,536 first, halved on an out-of-memory
    error), serve_p99 and serve_bulk forwards, each against its bundle's
    bound, with the peak memory. (d) DLRM with each table cut to 2^24
    rows (45.0 GB of tables): one rowwise step at 65,536, in place, the
    peak under tables + 20 GB; DeepFM and AutoInt at full config: a
    rowwise step at 65,536 and serve_p99 each. (e) launch.train --arch
    deepfm (full config) for 20 steps with checkpoints every 10 under
    build/recsys_smoke/, and a resume from step 10 that replays step 11
    bitwise."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import registry, steps
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.index import _topk_merge, project_queries
    from repro_torch.core.pruning import StaticPruner
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.core.table_compress import compress_tables
    from repro_torch.kernels import topk_score
    from repro_torch.launch import train as train_cli
    from repro_torch.models import recsys as R
    from repro_torch.par.mesh import make_mesh
    from repro_torch.util import flatten_with_paths

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    mesh11 = make_mesh((1, 1), ("data", "model"), dev)
    mesh22 = make_mesh((2, 2), ("data", "model"), dev)

    def bundle(arch, cfg, cell, mesh=mesh11):
        spec = dataclasses.replace(registry.get_arch(arch), cfg=cfg)
        return steps.recsys_bundle(spec, cell, mesh)

    def on(batch, d):
        return {k: torch.as_tensor(v, device=d) for k, v in batch.items()}

    # (a) card against CPU on the smoke configs
    t0 = time.perf_counter()
    parity, bad = {}, []
    train = ShapeCell("smoke", "train", dict(batch=RECSYS_PARITY_BATCH))
    for arch in RECSYS_ARCHS:
        cfg = registry.get_smoke_cfg(arch)
        opt_name = registry.get_arch(arch).optimizer
        b = recsys_batch(cfg, RECSYS_PARITY_BATCH)
        out = {}
        for d in ("cpu", dev):
            m = R.init_recsys(cfg, generator=torch.Generator().manual_seed(0), device=d)
            m.requires_grad_(True)
            loss_fn = R.two_tower_loss if cfg.kind == "two_tower" else R.bce_loss
            loss, grads = steps.value_and_grad(loss_fn, m, on(b, d))
            init, _ = steps._opt_pack(opt_name)
            opt = init(m)
            bd = bundle(arch, cfg, train, make_mesh((1, 1), ("data", "model"), d))
            step_loss = bd.fn(m, opt, on(b, d))["loss"]
            tree = convert.checkpoint_tree(m, opt)
            with torch.no_grad():
                if cfg.kind == "two_tower":
                    items = torch.arange(cfg.item_vocab, device=d)
                    fwd = R.score_candidates(m, torch.tensor([TT_USER], device=d),
                                             R.item_embedding(m, items), k=100)
                else:
                    fwd = R.forward_ctr(m, on(b, d))
            out[d] = (loss, grads, step_loss, tree, fwd)
        (lc, gc_, slc, tc, fc), (lg, gg, slg, tg, fg) = out["cpu"], out[dev]
        r = {"optimizer": opt_name,
             "loss_rel_err": abs(float(lg) - float(lc)) / abs(float(lc)),
             "step_loss_rel_err": abs(float(slg) - float(slc)) / abs(float(slc))}
        errs = {n: _leaf_err(gg[n], g) for n, g in gc_.items()}
        r["grad_max_leaf_rel_err"] = max(errs.values())
        r["grad_worst_leaf"] = max(errs, key=errs.get)
        flat_c = dict(flatten_with_paths(tc))
        flat_g = dict(flatten_with_paths(tg))
        p_err = max(float((flat_g[p].detach().cpu() - v.detach()).abs().max())
                    for p, v in flat_c.items() if p.startswith("0/"))
        s_err = max(_leaf_err(flat_g[p], v) for p, v in flat_c.items()
                    if p.startswith("1/") and v.is_floating_point() and bool(v.abs().max() > 0))
        r["step_params_max_abs_err"], r["step_state_max_leaf_rel_err"] = p_err, s_err
        if cfg.kind == "two_tower":
            r["retrieval_ids_near_ties"] = compare_topk(*fc, *fg, f"recsys (a) {arch}")[2]
            bad_fwd = False
        else:
            r["forward_max_abs_err"] = float((fg.cpu() - fc).abs().max())
            bad_fwd = r["forward_max_abs_err"] > RECSYS_F32_TOL
        if (r["loss_rel_err"] > RECSYS_F32_TOL or r["step_loss_rel_err"] > RECSYS_F32_TOL
                or r["grad_max_leaf_rel_err"] > RECSYS_F32_TOL or bad_fwd
                or p_err > RECSYS_STEP_TOL or s_err > RECSYS_F32_TOL):
            bad.append(arch)
        parity[arch] = r
        del out
    emit("recsys", step="a_parity", seconds=time.perf_counter() - t0, f32_tol=RECSYS_F32_TOL,
         step_tol=RECSYS_STEP_TOL, **parity)
    if bad:
        raise AssertionError(f"recsys (a): card against CPU out of bounds for {bad}: {parity}")

    # (b) the two-tower at full width: the candidate index and retrieval_cand
    arch = "two-tower-retrieval"
    spec = registry.get_arch(arch)
    cfg = spec.cfg
    t0 = time.perf_counter()
    model = R.init_recsys(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    C = TT_CANDIDATES
    with torch.no_grad():
        t0 = time.perf_counter()
        full = torch.cat([R.item_embedding(model, torch.arange(i, min(i + TT_EMBED_BLOCK, C),
                                                              device=dev))
                          for i in range(0, C, TT_EMBED_BLOCK)])
        torch.cuda.synchronize()
        t_embed = time.perf_counter() - t0
        t0 = time.perf_counter()
        pruner = StaticPruner(cutoff=TT_CUTOFF).fit(full)              # gram
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        pruned = pruner.prune_index(full)                               # pca_project
        torch.cuda.synchronize()
        t_prune = time.perf_counter() - t0
        m = pruner.kept_dims
        W = pruner.projection()[0].contiguous()
        q8, scale = quantize_int8_per_dim(pruned)
        new = R.item_embedding(model, torch.arange(C, C + TT_DELTA_LIVE, device=dev))
        d8, dscale = quantize_int8_per_dim(project_queries(new, W))
        delta = torch.zeros((TT_DELTA_ROWS, m), dtype=torch.int8, device=dev)
        delta[:TT_DELTA_LIVE] = d8
        users = torch.tensor([TT_USER], device=dev)
        u = R.user_embedding(model, users)
        q = project_queries(u, W)
    base = dict(batch=1, n_candidates=C)
    ways = {"full": ({}, (full,), mesh11),
            "pruned_f32": (dict(index_dim=m), (pruned, W, torch.ones(m, device=dev)), mesh11),
            "pruned_int8": (dict(index_dim=m, int8=1), (q8, W, scale), mesh11),
            "int8_delta": (dict(index_dim=m, int8=1, delta_rows=TT_DELTA_ROWS),
                           (q8, W, scale, delta, dscale, TT_DELTA_LIVE), mesh11),
            "int8_hier": (dict(index_dim=m, int8=1, hier_merge=1), (q8, W, scale), mesh22)}
    results, searches = {}, {}
    for name, (dims, args, mesh) in ways.items():
        bd = bundle(arch, cfg, ShapeCell("retrieval_cand", "retrieval", {**base, **dims}), mesh)
        with torch.no_grad():
            s, i = bd.fn(model, *args, users)
            torch.cuda.synchronize()
            with counters.uncounted():
                ms = cuda_ms(lambda: bd.fn(model, *args, users), reps=10)
        results[name] = (s, i)
        searches[name] = dict(ms=ms, bound_ms=bundle_bound(bd.meta)[0], n_candidates=C,
                              index_dim=bd.meta["index_dim"], int8=bd.meta["index_int8"])
    with counters.uncounted(), torch.no_grad():
        # each search against the plain top-k on the same operands
        plain = {"full": topk_score.topk_score_plain(full, u.contiguous(), k=100),
                 "pruned_f32": topk_score.topk_score_plain(pruned, q.contiguous(), k=100),
                 "pruned_int8": topk_score.topk_score_plain(
                     q8, (q * scale[None, :]).contiguous(), k=100)}
        plain["int8_hier"] = plain["pruned_int8"]
        ds = topk_score.topk_score_plain(delta, (q * dscale[None, :]).contiguous(), k=100,
                                         n_valid=TT_DELTA_LIVE)
        plain["int8_delta"] = _topk_merge(
            torch.cat([plain["pruned_int8"][0], ds[0]], 1),
            torch.cat([plain["pruned_int8"][1], torch.where(ds[1] >= 0, ds[1] + C, ds[1])], 1),
            100)
        for name, got in results.items():
            err, eq, near = compare_topk(*plain[name], *got, f"recsys (b) {name}")
            searches[name].update(max_abs_err=err, ids_equal=eq, near_ties=near)
        if not torch.equal(results["int8_hier"][1], results["pruned_int8"][1]):
            raise AssertionError("recsys (b): the hierarchical merge's ids differ from the flat")
        full_ids = set(results["full"][1][0].tolist())
        recall = {name: len(full_ids & set(results[name][1][0].tolist())) / 100
                  for name in ("pruned_f32", "pruned_int8", "int8_delta")}
        in_delta = int((results["int8_delta"][1] >= C).sum())
        # the kernels at this path's shapes
        rows["topk_score_recsys_f32_d256"] = topk_row(full, u.contiguous(), 100)
        rows["topk_score_recsys_f32_m128"] = topk_row(pruned, q.contiguous(), 100)
        qs = (q * scale[None, :]).contiguous()
        rows["topk_score_recsys_int8_m128"] = topk_row(q8, qs, 100)
        rows["topk_score_recsys_delta_int8"] = topk_row(
            delta, (q * dscale[None, :]).contiguous(), 100, n_valid=TT_DELTA_LIVE)
        shard = q8[:C // 4]
        rows["topk_score_recsys_shard_int8"] = topk_row(shard, qs, 100)
        rows["gram_recsys"] = gram_row(full)
        rows["pca_project_recsys"] = pca_project_row(full, W, pruned)
    emit("recsys", step="b_retrieval", arch=arch, init_s=t_init, embed_s=t_embed,
         fit_s=t_fit, prune_s=t_prune, kept_dims=m, candidates=C, delta_rows=TT_DELTA_ROWS,
         delta_live=TT_DELTA_LIVE, recall_at_100_vs_full=recall, delta_ids_in_top100=in_delta,
         hier_ids_equal_flat=True, searches=searches,
         eigenvalue_top3=pruner.state.eigenvalues[:3].tolist())
    del full, pruned, q8, delta, new, results, plain

    # compress_tables over the item table (the same fit and prune, on a table)
    with torch.no_grad():
        t0 = time.perf_counter()
        (ct,), cp = compress_tables([model.item_embed])            # gram, pca_project
        torch.cuda.synchronize()
        t_compress = time.perf_counter() - t0
        with counters.uncounted():
            sample = model.item_embed[:100_000]
            rows["gram_table_compress"] = gram_row(sample)
            rows["pca_project_table_compress"] = pca_project_row(
                model.item_embed, cp.projection()[0].contiguous(), ct)
    emit("recsys", step="d_compress_tables", table=list(model.item_embed.shape),
         pruned=list(ct.shape), kept_dims=cp.kept_dims, seconds=t_compress,
         bytes_full=model.item_embed.numel() * 4, bytes_pruned=ct.numel() * 4)
    del ct, cp

    # (c) two-tower training and serving at full width
    model.requires_grad_(True)
    init, _ = steps._opt_pack(spec.optimizer)
    opt = init(model)
    trained, tried = None, {}
    for B in TT_TRAIN_BATCHES:
        bd = bundle(arch, cfg, ShapeCell("train_batch", "train", dict(batch=B)))
        batch = on(recsys_batch(cfg, B), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            loss = float(bd.fn(model, opt, batch)["loss"])
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as e:
            tried[B] = dict(oom=str(e).split("\n")[0][:200],
                            peak_at_oom_gb=torch.cuda.max_memory_allocated() / 1e9)
            del e
            gc.collect()
            torch.cuda.empty_cache()
            continue
        ms = median_ms(lambda: bd.fn(model, opt, batch), reps=TT_TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated()
        b_ms, b_by = bundle_bound(bd.meta)
        trained = dict(batch=B, first_step_s=first, loss=loss, ms=ms, bound_ms=b_ms,
                       bound_by=b_by, bound_frac=b_ms / ms, peak_gb=peak / 1e9,
                       samples_per_s=B / ms * 1e3)
        del batch
        break
    if trained is None or not np.isfinite(trained["loss"]):
        raise AssertionError(f"recsys (c): no train_batch step ran: {tried}")
    model.requires_grad_(False)
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    served = {}
    for cell in ("serve_p99", "serve_bulk"):
        c = spec.cell(cell)
        bd = bundle(arch, cfg, c)
        batch = recsys_batch(cfg, c.dims["batch"])
        batch = on({k: batch[k] for k in ("user_ids", "item_ids")}, dev)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            out = bd.fn(model, batch)
            ms = cuda_ms(lambda: bd.fn(model, batch), reps=10)
        if not (out.shape == (c.dims["batch"],) and bool(torch.isfinite(out).all())):
            raise AssertionError(f"recsys (c): {cell} output {tuple(out.shape)} not finite")
        b_ms, b_by = bundle_bound(bd.meta)
        served[cell] = dict(batch=c.dims["batch"], ms=ms, bound_ms=b_ms, bound_by=b_by,
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("recsys", step="c_two_tower", arch=arch, params=cfg.param_count(),
         train=trained, train_tried_oom=tried, serve=served)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) DLRM with its tables cut to 2^24 rows; DeepFM and AutoInt whole
    ctr = {}
    for arch in ("dlrm-mlperf", "deepfm", "autoint"):
        spec = registry.get_arch(arch)
        cfg = spec.cfg
        if arch == "dlrm-mlperf":
            cfg = dataclasses.replace(cfg, vocab_sizes=tuple(min(v, DLRM_ROW_CAP)
                                                             for v in cfg.vocab_sizes))
        t0 = time.perf_counter()
        model = R.init_recsys(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        model.requires_grad_(True)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        table_bytes = sum(t.numel() * t.element_size() for t in model.tables)
        init, _ = steps._opt_pack(spec.optimizer)
        opt = init(model)
        bd = bundle(arch, cfg, ShapeCell("train_batch", "train",
                                         dict(batch=RECSYS_TRAIN_BATCH)))
        ptrs = [t.data_ptr() for t in model.tables]
        touched = torch.as_tensor(recsys_batch(cfg, RECSYS_TRAIN_BATCH)["sparse"][:8, 0],
                                  device=dev).long()
        probe = model.tables[0][touched].clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for t in range(2):
            batch = on(recsys_batch(cfg, RECSYS_TRAIN_BATCH, t), dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(float(bd.fn(model, opt, batch, t)["loss"]))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        in_place = [t.data_ptr() for t in model.tables] == ptrs
        moved = bool((probe != model.tables[0][touched]).any(1).all())
        model.requires_grad_(False)
        del opt
        sp = spec.cell("serve_p99")
        sb = bundle(arch, cfg, sp)
        batch = on(recsys_batch(cfg, sp.dims["batch"]), dev)
        with torch.no_grad():
            logits = sb.fn(model, batch)
            s_ms = cuda_ms(lambda: sb.fn(model, batch), reps=10)
        b_ms, b_by = bundle_bound(bd.meta)
        sb_ms, sb_by = bundle_bound(sb.meta)
        ctr[arch] = dict(
            tables_gb=table_bytes / 1e9, rows=sum(cfg.vocab_sizes), init_s=t_init,
            losses=losses, first_step_ms=times[0], step_ms=times[1], bound_ms=b_ms,
            bound_by=b_by, samples_per_s=RECSYS_TRAIN_BATCH / times[1] * 1e3,
            peak_gb=peak / 1e9, peak_over_tables_gb=(peak - table_bytes) / 1e9,
            tables_in_place=in_place, touched_rows_moved=moved,
            serve_p99=dict(ms=s_ms, bound_ms=sb_ms, bound_by=sb_by))
        if arch == "dlrm-mlperf":
            ctr[arch]["cut"] = f"each table at most {DLRM_ROW_CAP:,} rows"
        # DLRM's bar: no copy of its 45 GB of tables fits under 20 GB more
        if not (all(np.isfinite(losses)) and in_place and moved
                and bool(torch.isfinite(logits).all())
                and (arch != "dlrm-mlperf" or peak - table_bytes < 20e9)):
            raise AssertionError(f"recsys (d): {arch}: {ctr[arch]}")
        del model, batch, logits
        gc.collect()
        torch.cuda.empty_cache()
    emit("recsys", step="d_ctr", train_batch=RECSYS_TRAIN_BATCH, **ctr)

    # (e) launch.train --arch deepfm, full config, checkpoints, resume
    root = os.path.join(HERE, "build", "recsys_smoke")
    shutil.rmtree(root, ignore_errors=True)
    ckpt = os.path.join(root, "ck")
    run = dict(steps=RECSYS_RUN_STEPS, smoke=False, ckpt_dir=ckpt,
               ckpt_every=RECSYS_RUN_CKPT_EVERY, seed=0, batch=RECSYS_TRAIN_BATCH, device=dev,
               log_every=RECSYS_RUN_CKPT_EVERY)
    t0 = time.perf_counter()
    res = train_cli.train("deepfm", resume="none", **run)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    losses = res["losses"]
    del res
    gc.collect()
    shutil.rmtree(os.path.join(ckpt, f"step_{RECSYS_RUN_STEPS:010d}"))
    res2 = train_cli.train("deepfm", resume="auto", **{**run, "steps": 1, "log_every": 0})
    resumed = res2["losses"][0]
    emit("recsys", step="e_launch_train", arch="deepfm", batch=RECSYS_TRAIN_BATCH,
         steps=len(losses), seconds=t_run, first_loss=losses[0], last_loss=losses[-1],
         resumed_at=RECSYS_RUN_CKPT_EVERY, resumed_loss=resumed,
         uninterrupted_loss=losses[RECSYS_RUN_CKPT_EVERY],
         resume_bitwise=resumed == losses[RECSYS_RUN_CKPT_EVERY])
    if not (len(losses) == RECSYS_RUN_STEPS and all(np.isfinite(losses))):
        raise AssertionError(f"recsys (e): losses not finite: {losses}")
    if resumed != losses[RECSYS_RUN_CKPT_EVERY]:
        raise AssertionError(f"recsys (e): resumed {resumed} against "
                             f"{losses[RECSYS_RUN_CKPT_EVERY]}")
    del res2
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()


def start_dryrun():
    """Phase 17(e): ``launch.dryrun --all --mesh both`` over every cell of
    every family on meta tensors, in DRYRUN_JOBS processes at the lowest CPU
    priority, its records under build/experiments/dryrun and its lines in
    build/experiments/dryrun.log. It needs no card; phase_gnn starts it
    after its timed cells and collects it after (d)."""
    out = os.path.join(HERE, "build", "experiments")
    os.makedirs(out, exist_ok=True)
    log = open(os.path.join(out, "dryrun.log"), "w")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    proc = subprocess.Popen(
        ["nice", "-n", "19", sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--force", "--jobs", str(DRYRUN_JOBS),
         "--out", os.path.join(out, "dryrun")],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=HERE, start_new_session=True)
    return proc, log, time.perf_counter()


def stop_dryrun(proc):
    """Kill the dry run and its worker processes (one process group) if it
    is still running."""
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def gnn_graph(n_nodes, n_edges, d_feat, d_edge, d_out, dev, seed, power_law=False):
    """A seeded graph batch drawn on ``dev``: edges uniform (or with both
    ends zipf-weighted, exponent 0.8, as data/graph.py's random_graph),
    f32 features, edge mask and node mask all ones."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    if power_law:
        w = 1.0 / torch.arange(1, n_nodes + 1, device=dev, dtype=torch.float64) ** 0.8
        cdf = torch.cumsum(w, 0)
        cdf /= cdf[-1].clone()
        ends = [torch.searchsorted(cdf, torch.rand(n_edges, generator=g, device=dev,
                                                   dtype=torch.float64)).clamp_(max=n_nodes - 1)
                for _ in range(2)]
        ei = torch.stack(ends).int()
    else:
        ei = torch.randint(0, n_nodes, (2, n_edges), generator=g, device=dev).int()
    return {"nodes": torch.randn(n_nodes, d_feat, generator=g, device=dev),
            "edges": torch.randn(n_edges, d_edge, generator=g, device=dev),
            "edge_index": ei,
            "edge_mask": torch.ones(n_edges, device=dev),
            "targets": torch.randn(n_nodes, d_out, generator=g, device=dev),
            "node_mask": torch.ones(n_nodes, device=dev)}


def gnn_kernel_share(step):
    """Device time of one call of ``step`` under torch.profiler, split into
    the gathers (index_select), the segment reductions (segment_reduce) and
    the plan (sort, searchsorted): each a share of all kernel time, or None
    when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    parts = {"gather": 0.0, "segment": 0.0, "plan": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if not t:
            continue
        name = ev.key.lower()
        if "segment" in name:
            parts["segment"] += t
        elif "index_select" in name or "indexselect" in name or "gather" in name:
            parts["gather"] += t
        elif "sort" in name or "searchsorted" in name or "radix" in name:
            parts["plan"] += t
        else:
            parts["other"] += t
    total = sum(parts.values())
    if not total:
        return None
    return {"kernel_ms": total / 1e3, **{f"{k}_share": v / total for k, v in parts.items()}}


def phase_gnn(counters):
    """Phase 17: the GNN family (graphcast: 16 layers, h 512, bf16 compute,
    f32 parameters, remat). (a) The smoke config on the card against the
    CPU from the same seeded weights, for each aggregator with and without
    an edge mask, on a graph with tied messages (repeated edges) and
    isolated nodes: f32 loss, each gradient leaf and the parameters after
    one AdamW step; bf16 compute (227 outputs) by cosine. (b) Determinism:
    one full-width step on the minibatch_lg batch, twice from the same
    state: the same loss and parameters, bit for bit. (c) One AdamW step a
    cell at the published sizes: molecule (128 graphs of 30 nodes and 64
    edges), full_graph_sm (Cora: 2,708 nodes, 10,556 edges, 1,433
    features), minibatch_lg (the fanout sampler, 1,024 seeds, fanouts
    15/10, over a seeded power-law graph of 232,965 nodes and 114,615,892
    edges in CSR; a 232,965 x 602 feature table on the card gathered by the
    sampled ids; the loss on the seeds) and ogb_products with its nodes
    and edges divided by the first power of two in GNN_OGB_FACTORS whose
    step fits: ms a step (median of GNN_TIMED_STEPS after a warm-up)
    against the one-card bound max(counted FLOPs / 989e12, analytic bytes /
    3.35e12), peak memory, and the gathers' and segment sums' share of the
    step's kernel time. (d) launch.train --arch graphcast (full config, its
    first cell) for 20 steps with checkpoints every 10 under
    build/gnn_smoke/, and a resume from step 10 that replays step 11
    bitwise. (e) The dry run (``start_dryrun``), started once (c) is timed
    and running beside (d): every cell of every family on both meshes ok,
    or skipped with the reference's reason, or an error naming its op; the
    slowest cells' counting seconds; the roofline tables."""
    import dataclasses
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs import registry, steps
    from repro_torch.data.graph import CSRGraph, NeighborSampler
    from repro_torch.launch import flops as F
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import gnn as G

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    spec = registry.get_arch("graphcast")
    prod = make_production_mesh()

    def leaf_errs(ga, gb):
        return {k: float((ga[k].float().cpu() - gb[k].float().cpu()).abs().max())
                / max(float(ga[k].float().abs().max()), 1e-30) for k in ga}

    def flat_cos(ga, gb):
        a = torch.cat([ga[k].float().cpu().reshape(-1) for k in sorted(ga)])
        b = torch.cat([gb[k].float().cpu().reshape(-1) for k in sorted(gb)])
        return float(a @ b / a.norm() / b.norm())

    def rows_cos(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float(((a * b).sum(1) / a.norm(dim=1) / b.norm(dim=1)).min())

    # (a) card against CPU on the smoke config, tied messages, isolated nodes
    t0 = time.perf_counter()
    smoke = registry.get_smoke_cfg("graphcast")
    rng = np.random.default_rng(0)
    n, e, live, dup = 60, 240, 50, 24
    src = rng.integers(0, n, e)
    dst = rng.integers(0, live, e)
    ei = np.stack([np.concatenate([src, src[:dup]]), np.concatenate([dst, dst[:dup]])])
    edges = rng.standard_normal((e, smoke.d_edge_in)).astype(np.float32)
    host = {"nodes": rng.standard_normal((n, smoke.d_in)).astype(np.float32),
            "edges": np.concatenate([edges, edges[:dup]]),
            "edge_index": ei.astype(np.int32),
            "edge_mask": (rng.random(e + dup) < 0.8).astype(np.float32),
            "targets": rng.standard_normal((n, smoke.d_out)).astype(np.float32),
            "node_mask": (rng.random(n) < 0.7).astype(np.float32)}
    parity, bad = {}, []
    for agg in GNN_AGGS:
        for masked in (False, True):
            cfg = dataclasses.replace(smoke, aggregator=agg, remat=True)
            b = dict(host) if masked else {k: v for k, v in host.items() if k != "edge_mask"}
            out = {}
            for d in ("cpu", dev):
                m = G.init_gnn(cfg, generator=torch.Generator().manual_seed(0), device=d)
                m.requires_grad_(True)
                bd = {k: torch.as_tensor(v, device=d) for k, v in b.items()}
                loss, grads = steps.value_and_grad(G.mse_loss, m, bd)
                step, init = steps.make_train_step(G.mse_loss, "adamw")
                opt = init(m)
                step(m, opt, bd)
                out[d] = (float(loss), grads, {k: v.detach() for k, v in m.named_parameters()})
            (lc, gc_, pc), (lg, gg, pg) = out["cpu"], out[dev]
            gerr = max(leaf_errs(gc_, gg).values())
            perr = max(float((pc[k] - pg[k].cpu()).abs().max()) for k in pc)
            r = dict(loss_cpu=lc, loss_card=lg, loss_err=abs(lc - lg), grad_leaf_err=gerr,
                     param_err_after_adamw=perr)
            parity[f"{agg}{'_masked' if masked else ''}"] = r
            if not (abs(lc - lg) <= GNN_F32_TOL * max(abs(lc), 1.0) and gerr <= GNN_F32_TOL
                    and perr <= GNN_F32_TOL):
                bad.append((agg, masked, r))
    bcfg = dataclasses.replace(smoke, compute_dtype="bfloat16", d_hidden=64, d_out=227,
                               remat=True)
    b16 = dict(host, targets=rng.standard_normal((n, 227)).astype(np.float32))
    outs = {}
    for d in ("cpu", dev):
        m = G.init_gnn(bcfg, generator=torch.Generator().manual_seed(1), device=d)
        m.requires_grad_(True)
        bd = {k: torch.as_tensor(v, device=d) for k, v in b16.items()}
        with torch.no_grad():
            y = G.forward(m, bd["nodes"], bd["edges"], bd["edge_index"], bd["edge_mask"])
        outs[d] = (y, steps.value_and_grad(G.mse_loss, m, bd)[1])
    bf16 = dict(out_row_cos_min=rows_cos(outs["cpu"][0], outs[dev][0]),
                grad_cos=flat_cos(outs["cpu"][1], outs[dev][1]))
    emit("gnn", step="a_parity", seconds=time.perf_counter() - t0, f32=parity, bf16=bf16)
    if bad or min(bf16.values()) < GNN_BF16_COS:
        raise AssertionError(f"gnn (a): card against CPU: {bad} {bf16}")

    # the minibatch_lg graph: power-law CSR drawn on the card, sampled on the host
    t0 = time.perf_counter()
    lg_cell = spec.cell("minibatch_lg")
    nd = lg_cell.dims
    big = gnn_graph(nd["n_nodes"], nd["n_edges"], 1, 1, 1, dev, seed=0, power_law=True)
    src, dst = big["edge_index"][0].long(), big["edge_index"][1].long()
    del big
    order = torch.argsort(src, stable=True)
    indptr = torch.zeros(nd["n_nodes"] + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=nd["n_nodes"]), 0)
    csr = CSRGraph(indptr=indptr.cpu().numpy(), indices=dst[order].int().cpu().numpy(),
                   n_nodes=nd["n_nodes"])
    del src, dst, order, indptr
    t_graph = time.perf_counter() - t0
    sampler = NeighborSampler(csr, (nd["fanout0"], nd["fanout1"]), nd["batch_nodes"], seed=0)
    t0 = time.perf_counter()
    sample = sampler.sample()
    t_sample = time.perf_counter() - t0
    gf = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn(nd["n_nodes"], nd["d_feat"], generator=gf, device=dev)
    ids = torch.as_tensor(sample["node_ids"], device=dev).long()
    E = sample["edge_index"].shape[1]
    mb = {"nodes": table.index_select(0, ids),
          "edges": torch.randn(E, spec.cfg.d_edge_in, generator=gf, device=dev),
          "edge_index": torch.as_tensor(sample["edge_index"], device=dev),
          "edge_mask": torch.ones(E, device=dev),
          "targets": torch.randn(ids.shape[0], spec.cfg.d_out, generator=gf, device=dev),
          "node_mask": torch.as_tensor(sample["seed_mask"], device=dev)}
    emit("gnn", step="minibatch_graph", nodes=csr.n_nodes, edges=int(csr.indices.shape[0]),
         build_s=t_graph, sample_ms=t_sample * 1e3, sampled_nodes=int(ids.shape[0]),
         unique_nodes=int(sample["node_mask"].sum()), sampled_edges=E,
         table_gb=table.numel() * 4 / 1e9)
    del table, csr, sampler

    def cell_run(cell):
        b = steps.gnn_bundle(spec, cell, prod)
        acc = F.step_cost(b)
        cfg = dataclasses.replace(spec.cfg, d_in=cell.dims["d_feat"])
        model = G.init_gnn(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        model.requires_grad_(True)
        return b, acc, model, b.opt_init(model)

    # (b) determinism: the same full-width step twice from the same state
    t0 = time.perf_counter()
    b, acc, model, opt = cell_run(lg_cell)
    b.fn(model, opt, mb)            # a state with moments to replay from
    state0 = [t.detach().clone() for t in (*model.parameters(), *opt["mu"].values(),
                                           *opt["nu"].values())]
    step0 = opt["step"].clone()
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for t, v in zip((*model.parameters(), *opt["mu"].values(), *opt["nu"].values()),
                            state0):
                t.copy_(v)
        opt["step"] = step0.clone()
        loss = b.fn(model, opt, mb)["loss"]
        runs.append((loss.clone(), [p.detach().clone() for p in model.parameters()]))
    same_loss = torch.equal(runs[0][0], runs[1][0])
    same_params = all(torch.equal(a, c) for a, c in zip(runs[0][1], runs[1][1]))
    emit("gnn", step="b_determinism", cell="minibatch_lg", seconds=time.perf_counter() - t0,
         loss=float(runs[0][0]), loss_bitwise=same_loss, params_bitwise=same_params)
    if not (same_loss and same_params):
        raise AssertionError("gnn (b): a repeated full-width step is not bitwise")
    del runs, state0, model, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (c) one AdamW step a cell at the published sizes
    def timed(cell, batch, extra):
        torch.cuda.reset_peak_memory_stats()
        b, acc, model, opt = cell_run(cell)
        losses, times = [], []
        for i in range(GNN_TIMED_STEPS + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(float(b.fn(model, opt, batch, i)["loss"]))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        share = gnn_kernel_share(lambda: b.fn(model, opt, batch))
        t_ops = acc["flops"] / BF16_FLOP_PER_S * 1e3
        t_bytes = b.meta["analytic_bytes"] / HBM_BYTES_PER_S * 1e3
        row = dict(nodes=b.meta["n_nodes"], edges=b.meta["n_edges"],
                   d_feat=cell.dims["d_feat"], first_ms=times[0],
                   ms=statistics.median(times[1:]), bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   counted_flops=acc["flops"], model_flops=b.meta["model_flops"],
                   analytic_bytes=b.meta["analytic_bytes"], peak_gb=peak / 1e9,
                   losses=losses, kernels=share, **extra)
        del model, opt
        if not all(np.isfinite(losses)):
            raise AssertionError(f"gnn (c): {cell.name}: losses not finite: {losses}")
        return row

    cells = {}
    t0 = time.perf_counter()
    cells["minibatch_lg"] = timed(lg_cell, mb, dict(seeds=nd["batch_nodes"]))
    del mb
    for name in ("molecule", "full_graph_sm"):
        cell = spec.cell(name)
        b = steps.gnn_bundle(spec, cell, prod)
        batch = gnn_graph(b.meta["n_nodes"], b.meta["n_edges"], cell.dims["d_feat"],
                          spec.cfg.d_edge_in, spec.cfg.d_out, dev, seed=2,
                          power_law=name == "full_graph_sm")
        if name == "molecule":     # 128 graphs: edges stay inside each graph
            d = cell.dims
            local = torch.randint(0, d["n_nodes"], (2, d["batch"], d["n_edges"]), device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(3))
            off = (torch.arange(d["batch"], device=dev) * d["n_nodes"])[None, :, None]
            batch["edge_index"] = (local + off).reshape(2, -1).int()
        cells[name] = timed(cell, batch, {})
        del batch
    gc.collect()
    torch.cuda.empty_cache()
    ogb = spec.cell("ogb_products")
    tried = []
    for factor in GNN_OGB_FACTORS:
        cut = dataclasses.replace(ogb, dims={**ogb.dims, "n_nodes": ogb.dims["n_nodes"] // factor,
                                             "n_edges": ogb.dims["n_edges"] // factor})
        try:
            b = steps.gnn_bundle(spec, cut, prod)
            batch = gnn_graph(b.meta["n_nodes"], b.meta["n_edges"], cut.dims["d_feat"],
                              spec.cfg.d_edge_in, spec.cfg.d_out, dev, seed=4,
                              power_law=True)
            cells["ogb_products"] = timed(cut, batch, dict(
                cut_factor=factor, cut=f"nodes and edges / {factor}",
                full_nodes=ogb.dims["n_nodes"], full_edges=ogb.dims["n_edges"]))
            break
        except torch.OutOfMemoryError:
            tried.append(dict(factor=factor, peak_gb=torch.cuda.max_memory_allocated() / 1e9))
            batch = b = None
            gc.collect()
            torch.cuda.empty_cache()
    if "ogb_products" not in cells:
        raise AssertionError(f"gnn (c): ogb_products fits at no factor of {GNN_OGB_FACTORS}")
    cells["ogb_products"]["did_not_fit"] = tried
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    emit("gnn", step="c_cells", seconds=time.perf_counter() - t0, **cells)
    dryrun = start_dryrun()
    try:
        _gnn_launcher_and_dryrun(dev, dryrun)
    finally:
        stop_dryrun(dryrun[0])
        dryrun[1].close()


def _gnn_launcher_and_dryrun(dev, dryrun):
    """Phase 17(d) and (e), while the dry run counts: see ``phase_gnn``."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import roofline, train as train_cli

    # (d) launch.train --arch graphcast, full config, checkpoints, resume
    root = os.path.join(HERE, "build", "gnn_smoke")
    shutil.rmtree(root, ignore_errors=True)
    ckpt = os.path.join(root, "ck")
    run = dict(steps=GNN_RUN_STEPS, smoke=False, ckpt_dir=ckpt, ckpt_every=GNN_RUN_CKPT_EVERY,
               seed=0, device=dev, log_every=GNN_RUN_CKPT_EVERY)
    t0 = time.perf_counter()
    res = train_cli.train("graphcast", resume="none", **run)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    losses = res["losses"]
    first_cell = res["bundle"].meta["shape"]
    del res
    gc.collect()
    shutil.rmtree(os.path.join(ckpt, f"step_{GNN_RUN_STEPS:010d}"))
    res2 = train_cli.train("graphcast", resume="auto", **{**run, "steps": 1, "log_every": 0})
    resumed = res2["losses"][0]
    emit("gnn", step="d_launch_train", arch="graphcast", cell=first_cell, steps=len(losses),
         seconds=t_run, first_loss=losses[0], last_loss=losses[-1],
         resumed_at=GNN_RUN_CKPT_EVERY, resumed_loss=resumed,
         uninterrupted_loss=losses[GNN_RUN_CKPT_EVERY],
         resume_bitwise=resumed == losses[GNN_RUN_CKPT_EVERY])
    if not (len(losses) == GNN_RUN_STEPS and all(np.isfinite(losses))):
        raise AssertionError(f"gnn (d): losses not finite: {losses}")
    if resumed != losses[GNN_RUN_CKPT_EVERY]:
        raise AssertionError(f"gnn (d): resumed {resumed} against "
                             f"{losses[GNN_RUN_CKPT_EVERY]}")
    del res2
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the dry run over every cell, started after (c)
    proc, _, t_start = dryrun
    t0 = time.perf_counter()
    rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT - (t0 - t_start)))
    waited = time.perf_counter() - t0
    art = os.path.join(HERE, "build", "experiments", "dryrun")
    recs = roofline.load_records(art)
    want = [(s.arch_id, c.name, m) for s, c in registry.cells() for m in ("pod", "multipod")]
    got = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    missing = [k for k in want if k not in got]
    status = {}
    for r in recs:
        status[r["status"]] = status.get(r["status"], 0) + 1
    unaccounted = [k for k, r in got.items()
                   if not (r["status"] == "ok"
                           or (r["status"] == "skipped" and r.get("reason"))
                           or (r["status"] == "error" and r.get("op")))]
    rows = [a for a in map(roofline.analyse, recs) if a]
    emit("gnn", step="e_dryrun", rc=rc, cells=len(want), records=len(recs), status=status,
         missing=missing, unaccounted=unaccounted, total_s=time.perf_counter() - t_start,
         waited_s=waited, jobs=DRYRUN_JOBS, count_s=sum(r.get("count_s", 0) for r in recs),
         slowest=[(r["arch"], r["shape"], r["mesh"], r["count_s"]) for r in sorted(
             (r for r in recs if "count_s" in r), key=lambda r: -r["count_s"])[:8]])
    for mesh in ("pod", "multipod"):
        print(roofline.fmt_table(sorted((r for r in rows if r["mesh"] == mesh),
                                        key=lambda r: (r["arch"], r["shape"]))), flush=True)
    if rc != 0 or missing or unaccounted or len(recs) != len(want):
        raise AssertionError(f"gnn (e): dry run rc {rc}, missing {missing}, "
                             f"unaccounted {unaccounted}")


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-docs", type=int, default=N_DOCS,
                    help="main-path corpus rows (default: MS MARCO's)")
    ap.add_argument("--protocol-docs", type=int, default=PROTOCOL_DOCS,
                    help="corpus rows of the Table-1 protocol check")
    ap.add_argument("--encode-docs", type=int, default=ENCODE_DOCS,
                    help="passages the encoder phase encodes, fits, prunes and searches")
    ap.add_argument("--encode-batch", type=int, default=ENCODE_BATCH,
                    help="rows per encoder micro-batch")
    args = ap.parse_args()
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "csrc")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              f"the root of a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    smi = phase_device()
    sys.path.insert(0, src)
    import torch
    import repro_torch  # noqa: F401  (sets the fp32 policy)
    phase_build()
    run_phases(args, smi)


def run_phases(args, smi):
    """Phases 3-18 and the closing lines."""
    import torch
    ids_row = phase_edge_cases()
    counters = Counters()
    rows = {}
    counters.zero()
    t0 = time.perf_counter()
    index_f32, index_int8, pruner, Q, fresh = phase_main_path(counters, rows, args.n_docs)
    phase_protocol(args.protocol_docs)
    phase_server(counters, index_f32, index_int8, pruner, Q)
    torch.cuda.synchronize()
    launches = counters.read()
    emit("main_path_launches", seconds=time.perf_counter() - t0, **launches)
    on_path = ("gram", "pca_project", "pca_project_quant", "topk_score_f32",
               "topk_score_int8", "topk_score_row_ids", "topk_select")
    missing = [k for k in on_path if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    # the paged path, counted on its own
    counters.zero()
    t0 = time.perf_counter()
    phase_paged(counters, index_f32, index_int8, pruner, Q, rows)
    torch.cuda.synchronize()
    paged_launches = counters.read()
    emit("paged_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in paged_launches.items() if "paged" in k})
    missing = [k for k in ("topk_score_paged_f32", "topk_score_paged_int8")
               if paged_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the paged path: {missing}")
    # the live path, counted on its own
    counters.zero()
    t0 = time.perf_counter()
    phase_live(counters, index_f32, index_int8, pruner, Q, fresh, rows)
    torch.cuda.synchronize()
    live_launches = counters.read()
    emit("live_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in live_launches.items() if v})
    on_live = ("pca_project", "topk_score_f32", "topk_score_int8", "topk_score_f32_n_valid",
               "topk_score_int8_n_valid", "topk_score_paged_f32", "topk_score_paged_int8")
    missing = [k for k in on_live if live_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the live path: {missing}")
    # the store path, counted on its own
    counters.zero()
    t0 = time.perf_counter()
    phase_store(counters, index_f32, index_int8, pruner, Q, fresh, args.n_docs,
                args.protocol_docs)
    torch.cuda.synchronize()
    store_launches = counters.read()
    emit("store_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in store_launches.items() if v})
    on_store = ("gram", "pca_project", "topk_score_f32", "topk_score_int8",
                "topk_score_int8_n_valid", "topk_score_paged_int8")
    missing = [k for k in on_store if store_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the store path: {missing}")
    # the cascade path, counted on its own (phase 9's corpus and artifacts
    # are gone by now)
    counters.zero()
    t0 = time.perf_counter()
    phase_cascade(counters, index_f32, index_int8, pruner, Q, fresh, rows)
    torch.cuda.synchronize()
    cascade_launches = counters.read()
    emit("cascade_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in cascade_launches.items() if v})
    on_cascade = ("pca_project", "topk_score_int8", "topk_select_int8", "topk_score_row_ids",
                  "topk_score_int8_n_valid", "topk_score_paged_int8")
    missing = [k for k in on_cascade if cascade_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the cascade path: {missing}")
    # the fleet path, counted on its own
    counters.zero()
    t0 = time.perf_counter()
    phase_fleet(counters, index_f32, index_int8, pruner, Q)
    torch.cuda.synchronize()
    fleet_launches = counters.read()
    emit("fleet_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in fleet_launches.items() if v})
    if fleet_launches["topk_score_int8"] == 0:
        raise AssertionError("kernels never launched on the fleet path: ['topk_score_int8']")
    # the sharded path, counted on its own
    counters.zero()
    t0 = time.perf_counter()
    phase_sharded(counters, index_f32, index_int8, pruner, Q, fresh, rows, args.protocol_docs)
    torch.cuda.synchronize()
    sharded_launches = counters.read()
    emit("sharded_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in sharded_launches.items() if v})
    on_sharded = ("gram", "pca_project", "topk_score_f32", "topk_score_int8", "topk_select_f32",
                  "topk_select_int8", "topk_score_int8_n_valid")
    missing = [k for k in on_sharded if sharded_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the sharded path: {missing}")
    # the analysis gate over phase 4's indexes, counted on its own
    counters.zero()
    t0 = time.perf_counter()
    phase_analysis(counters, index_f32, index_int8, pruner, Q, fresh, rows, smi)
    torch.cuda.synchronize()
    analysis_launches = counters.read()
    emit("analysis_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in analysis_launches.items() if v})
    on_analysis = ("pca_project", "topk_score_f32", "topk_score_int8", "topk_score_f32_n_valid",
                   "topk_score_int8_n_valid", "topk_score_row_ids", "topk_score_paged_int8")
    missing = [k for k in on_analysis if analysis_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the analysis path: {missing}")
    # the indexes of phases 4-12 are not needed past them: the encoder and
    # the trainer get the card
    del index_f32, index_int8, pruner, Q, fresh
    gc.collect()
    torch.cuda.empty_cache()
    # the encoder's path, counted on its own
    counters.zero()
    t0 = time.perf_counter()
    phase_encoder(counters, rows, args.encode_docs, args.encode_batch)
    torch.cuda.synchronize()
    encoder_launches = counters.read()
    emit("encoder_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in encoder_launches.items() if v})
    on_encoder = ("gram", "pca_project", "pca_project_quant", "topk_score_f32",
                  "topk_score_int8")
    missing = [k for k in on_encoder if encoder_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the encoder path: {missing}")
    # the training half, counted on its own: its trained encode -> fit ->
    # prune -> search launches the kernels
    counters.zero()
    t0 = time.perf_counter()
    phase_train(counters, rows, args.encode_batch)
    torch.cuda.synchronize()
    train_launches = counters.read()
    emit("train_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in train_launches.items() if v})
    missing = [k for k in on_encoder if train_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the training path: {missing}")
    # the LM family, counted on its own: it runs none of the kernels (no
    # Pallas kernel of the reference is on the LM's path)
    counters.zero()
    t0 = time.perf_counter()
    phase_lm(counters)
    torch.cuda.synchronize()
    lm_launches = counters.read()
    emit("lm_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in lm_launches.items() if v})
    # the recsys family, counted on its own: the two-tower's candidate index
    # is fitted, pruned and searched through the kernels
    counters.zero()
    t0 = time.perf_counter()
    phase_recsys(counters, rows)
    torch.cuda.synchronize()
    recsys_launches = counters.read()
    emit("recsys_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in recsys_launches.items() if v})
    on_recsys = ("gram", "pca_project", "topk_score_f32", "topk_score_int8", "topk_select",
                 "topk_score_int8_n_valid")
    missing = [k for k in on_recsys if recsys_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the recsys path: {missing}")
    # the GNN family, counted on its own: it runs none of the kernels (the
    # reference computes its step outside Pallas), and the dry run collected
    counters.zero()
    t0 = time.perf_counter()
    phase_gnn(counters)
    torch.cuda.synchronize()
    gnn_launches = counters.read()
    emit("gnn_path_launches", seconds=time.perf_counter() - t0,
         **{k: v for k, v in gnn_launches.items() if v})
    if any(gnn_launches.values()):
        raise AssertionError(f"a kernel launched on the GNN path: "
                             f"{ {k: v for k, v in gnn_launches.items() if v} }")

    def entry(name, row, source, replaces, counter, counts=launches, launches_of=None):
        """counter None: a row timed at a shape of its own, whose launches
        are the CUDA launches of one call at that shape. ``launches_of``
        says what a path's counter counts where it is more than this row's
        shape."""
        b_ms, b_by = row["bound"]
        if counter is None:
            n_launch = row["launches_per_call"]
            extra = {"launches_of": "one call at this shape, not a path's count"}
        else:
            n_launch = counts[counter]
            extra = ({"cuda_launches": counts[counter + "_cuda"]}
                     if counter + "_cuda" in counts else {})
            if launches_of:
                extra["launches_of"] = launches_of
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=n_launch, **extra,
                    max_abs_err=row["max_abs_err"],
                    ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=row["library_ms"],
                    shape=row["shape"],
                    **{k: v for k, v in row.items()
                       if k in ("ids_equal", "near_ties", "rel_err",
                                "plain_f32_rel_err_vs_f64", "rel_err_vs_plain_f32",
                                "frac_differ", "matmul_topk_ms", "dense_ms",
                                "cuda_launches_per_call", "page_rows", "pages",
                                "ranges", "range_sum_bitwise", "n_valid",
                                "enqueue_ms", "library_call", "U_live", "path_bitwise")})
    csrc = "src/repro_torch/csrc/"
    topk = ("src/repro/kernels/topk_score.py:283", csrc + "topk_score.cu")
    paged = "src/repro/kernels/topk_score.py:549"
    kernels = [
        entry("gram", rows["gram"], csrc + "gram.cu",
              "src/repro/kernels/gram.py:41", "gram"),
        # the Table-1 protocol's fit shape (100,000 x 768)
        entry("gram_protocol", rows["gram_protocol"], csrc + "gram.cu",
              "src/repro/kernels/gram.py:41", None),
        entry("pca_project", rows["pca_project"], csrc + "pca_project.cu",
              "src/repro/kernels/pca_project.py:56", "pca_project"),
        entry("pca_project_n32", rows["pca_project_n32"], csrc + "pca_project.cu",
              "src/repro/kernels/pca_project.py:56", None),
        entry("pca_project_quant", rows["pca_project_quant"], csrc + "pca_project.cu",
              "src/repro/kernels/pca_project.py:79", "pca_project_quant"),
        entry("topk_score", rows["topk_score_f32"], topk[1], topk[0], "topk_score_f32"),
        entry("topk_score_int8", rows["topk_score_int8"], topk[1], topk[0],
              "topk_score_int8"),
        # the same kernels at k = 100, 1000 and past the old cap: the chunk
        # kernel lists every key and the radix select takes the top k
        *[entry(f"topk_score{'' if st == 'f32' else '_int8'}_k{kk}",
                rows[f"topk_score_{st}_k{kk}"], topk[1], topk[0], None)
          for st in ("f32", "int8") for kk in (100, 1000, 2000, 10000)],
        # the select alone: radix_hist / radix_pick passes, radix_gather,
        # bitonic_tile (and bitonic_global past 8,192 keys), select_write;
        # launches are its runs on the main path (protocol k = 1000, the int8
        # shortlist at k = 100)
        entry("topk_select", rows["topk_select"], topk[1], topk[0], "topk_select"),
        entry("topk_score_row_ids", rows["topk_score_row_ids"], topk[1], topk[0],
              "topk_score_row_ids"),
        # launches of the paged kernel are counted over phase 7; the ids_pool
        # mode is not on that path, so its times come from the edge cases
        entry("topk_score_paged_f32", rows["topk_score_paged_f32"], topk[1], paged,
              "topk_score_paged_f32", paged_launches),
        entry("topk_score_paged_int8", rows["topk_score_paged_int8"], topk[1], paged,
              "topk_score_paged_int8", paged_launches),
        entry("topk_score_paged_ids", ids_row, topk[1], paged, "topk_score_paged_ids",
              paged_launches),
        *[entry(f"topk_score_paged_{st}_k{kk}", rows[f"topk_score_paged_{st}_k{kk}"],
                topk[1], paged, None) for st in ("f32", "int8") for kk in (2000, 10000)],
        # the live path (phase 8): a delta segment's search over its 4,096-row
        # buffer with n_valid below it (launches: every masked dense call of
        # phase 8, k = 10 and 1000), and the 64-row projection of
        # add_documents (launches: every pca_project call of phase 8)
        *[entry(f"topk_score_delta_{st}", rows[f"topk_score_delta_{st}"], topk[1], topk[0],
                f"topk_score_{st}_n_valid", live_launches) for st in ("f32", "int8")],
        entry("pca_project_n64", rows["pca_project_n64"], csrc + "pca_project.cu",
              "src/repro/kernels/pca_project.py:56", "pca_project", live_launches),
        # the cascade (phase 10): the coarse int8 scan at its shapes (list
        # mode and the radix select; launches: every int8 plain-mode call
        # of phase 10, whatever its shape), the row_ids rescore of a real
        # shortlist (launches: every rescore part of phase 10, both full
        # dtypes), and the paged coarse scan (launches: every paged int8
        # call of phase 10)
        entry(f"topk_score_cascade_coarse_m{CASCADE_M}_k{CASCADE_N * K}",
              rows[f"cascade_coarse_m{CASCADE_M}_k{CASCADE_N * K}"], topk[1], topk[0],
              "topk_score_int8", cascade_launches,
              launches_of="every counted int8 plain-mode call of phase 10: the coarse "
                          "scans at every n_factor, and the full int8 searches of dense "
                          "and segmented bases (the anchor, the growth checks, the "
                          "reloads)"),
        entry(f"topk_score_cascade_coarse_m{CASCADE_CONFIGS[1][0]}_k"
              f"{CASCADE_CONFIGS[1][1] * K}",
              rows[f"cascade_coarse_m{CASCADE_CONFIGS[1][0]}_k{CASCADE_CONFIGS[1][1] * K}"],
              topk[1], topk[0], None),
        *[entry(f"topk_score_cascade_rescore_{st}", rows[f"cascade_rescore_{st}"], topk[1],
                topk[0], "topk_score_row_ids", cascade_launches) for st in ("f32", "int8")],
        entry("topk_score_paged_cascade_coarse", rows["cascade_paged_coarse"], topk[1], paged,
              "topk_score_paged_int8", cascade_launches),
        # the sharded path (phase 12): one shard's search, 2,210,456 of the
        # 8,841,823 rows (launches: every counted plain-mode call of phase
        # 12 in that dtype, all per-shard searches of sharded and sharded-base
        # segmented indexes, k 10 and 100), and one strip's Gram of the
        # distributed fit (launches: every gram call of phase 12)
        *[entry(f"topk_score_shard_{st}", rows[f"topk_score_shard_{st}"], topk[1], topk[0],
                f"topk_score_{st}", sharded_launches,
                launches_of=f"every counted {st} plain-mode call of phase 12: the per-shard "
                            f"searches" + (", and the full deltas' of (e)" if st == "int8" else ""))
          for st in ("f32", "int8")],
        # the analysis path (phase 18): a delta's search (4,096 rows, 1,808
        # live) with the count as a host int and as a 0-d device tensor, in
        # one call (launches: every masked dense call of phase 18, both forms)
        *[entry(f"topk_score_delta_{st}_{how}_count", rows[f"topk_score_delta_{st}_{how}_count"],
                topk[1], topk[0], f"topk_score_{st}_n_valid", analysis_launches,
                launches_of=f"every {st} n_valid-mode call of phase 18: the device-count "
                            f"checks and the segmented entry point's deltas")
          for st in ("f32", "int8") for how in ("host", "device")],
        entry("gram_strip", rows["gram_strip"], csrc + "gram.cu", "src/repro/kernels/gram.py:41",
              "gram", sharded_launches,
              launches_of="every gram call of phase 12: one a strip of gram_distributed "
                          "and fit_pca_distributed"),
        # the encoder's path (phase 13): the entry point's fit, prune, fused
        # int8 build and searches over the encoded corpus, and the f32
        # pruned search beside them (launches: every counted call of phase
        # 13; the f32 count holds the full and the pruned searches)
        entry("gram_encoder", rows["gram_encoder"], csrc + "gram.cu",
              "src/repro/kernels/gram.py:41", "gram", encoder_launches),
        entry("pca_project_encoder", rows["pca_project_encoder"], csrc + "pca_project.cu",
              "src/repro/kernels/pca_project.py:56", "pca_project", encoder_launches,
              launches_of="every pca_project call of phase 13: the prune and the two "
                          "transform_queries"),
        entry("pca_project_quant_encoder", rows["pca_project_quant_encoder"],
              csrc + "pca_project.cu", "src/repro/kernels/pca_project.py:79",
              "pca_project_quant", encoder_launches),
        *[entry(f"topk_score_encoder_{name}", rows[f"topk_score_encoder_{name}"], topk[1],
                topk[0], f"topk_score_{st}", encoder_launches,
                launches_of=f"every {st} plain-mode call of phase 13"
                + (": the full and the pruned searches" if st == "f32" else ""))
          for name, st in (("full", "f32"), ("f32", "f32"), ("int8", "int8"))],
        # the recsys path (phase 16): retrieval_cand's searches at B 1, k 100
        # over the two-tower's 1,000,448 candidates (full d 256, pruned f32
        # and int8 m 128, the delta, one slot of the (2, 2) mesh), the index's
        # fit and prune, and compress_tables' fit sample and table
        *[entry(f"topk_score_recsys_{name}", rows[f"topk_score_recsys_{name}"], topk[1],
                topk[0], counter, recsys_launches, launches_of=what)
          for name, counter, what in (
              ("f32_d256", "topk_score_f32", "every f32 plain-mode call of phase 16: the "
               "full and pruned f32 searches (and the smoke configs' on the card)"),
              ("f32_m128", "topk_score_f32", "every f32 plain-mode call of phase 16"),
              ("int8_m128", "topk_score_int8", "every int8 plain-mode call of phase 16: the "
               "pruned int8 and delta bases, and the four slots under hier_merge"),
              ("delta_int8", "topk_score_int8_n_valid", None),
              ("shard_int8", "topk_score_int8", "every int8 plain-mode call of phase 16"))],
        entry("gram_recsys", rows["gram_recsys"], csrc + "gram.cu",
              "src/repro/kernels/gram.py:41", "gram", recsys_launches,
              launches_of="every gram call of phase 16: the index's fit and compress_tables'"),
        entry("gram_table_compress", rows["gram_table_compress"], csrc + "gram.cu",
              "src/repro/kernels/gram.py:41", "gram", recsys_launches,
              launches_of="every gram call of phase 16"),
        entry("pca_project_recsys", rows["pca_project_recsys"], csrc + "pca_project.cu",
              "src/repro/kernels/pca_project.py:56", "pca_project", recsys_launches,
              launches_of="every pca_project call of phase 16: the index's prune (four "
                          "262,144-row blocks) and compress_tables' (four)"),
        entry("pca_project_table_compress", rows["pca_project_table_compress"],
              csrc + "pca_project.cu", "src/repro/kernels/pca_project.py:56", "pca_project",
              recsys_launches, launches_of="every pca_project call of phase 16"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    # make_dataset keys its generators on hash(str): pin the hash seed so the
    # protocol's dataset is the same from run to run
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    main()
