"""Recommender models: DLRM, DeepFM, AutoInt, Two-Tower retrieval (port of
``repro/models/recsys.py``).

The embedding substrate:

  * ``embedding_bag``          — a row gather and a mean / sum over the
                                 hotness dim; single-hot is the H=1 case.
  * ``sharded_embedding_bag``  — a table's rows laid over the slots of one
                                 ``DeviceMesh`` axis; each slot resolves the
                                 ids in its row range (mask + take) and the
                                 slots' rows are summed in slot order (the
                                 reference's ``psum``). One process over the
                                 slots, as ``contrastive_loss_sharded`` is.

Interactions: DLRM pairwise-dot, FM second-order identity
(½[(Σv)² − Σv²]), AutoInt multi-head self-attention over field tokens.

A model is a ``RecsysModel``: the reference's parameter tree as modules
(``tables`` and ``first_order`` a ``ParameterList``, the MLP stacks and
``attn_layers`` a ``ModuleList``), so ``named_parameters`` names a leaf by
its reference path with ``.`` for ``/`` (``tables.3``, ``bot_mlp.0.w``).
The functions take the model and read its config, in the reference's
arithmetic and dtypes (f32 throughout). Row gathers that autograd
differentiates are advanced indexing, whose backward on the card sums
duplicate ids in a fixed order (a sorted ``index_put_``), so a step
replays bitwise.

The two-tower model's candidate scoring path is the paper's exact dense-
retrieval setting: its item-side index is a ``core`` ``DenseIndex``, PCA-
prunable offline (256 → m dims). ``score_candidates`` searches it through
the index's device dispatch: the ``topk_score`` kernel on the card,
``_scan_topk`` on the CPU.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

from repro_torch.models import layers as L
from repro_torch.models.biencoder import _axis_slots
from repro_torch.models.layers import apply_dense, apply_mlp_stack, init_dense, init_mlp_stack
from repro_torch.models.transformer import torch_dtype
from repro_torch.par.mesh import DeviceMesh
from repro_torch.util import as_tensor, default_device


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------


def init_embedding_tables(generator: torch.Generator | None, vocab_sizes: Sequence[int],
                          dim: int, dtype=torch.float32) -> list[torch.Tensor]:
    """One (v, dim) table a vocabulary, N(0, 1) / sqrt(dim), drawn in order
    on the generator's device (scaled in place: a table is drawn once)."""
    dev = L.gen_device(generator)
    out = []
    for v in vocab_sizes:
        t = torch.randn(int(v), dim, generator=generator, device=dev)
        out.append(t.div_(np.sqrt(dim)).to(dtype))
    return out


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``table`` (advanced indexing: a deterministic
    backward)."""
    return table[idx.long()]


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *, combiner: str = "mean"
                  ) -> torch.Tensor:
    """idx: (B,) single-hot or (B, H) multi-hot -> (B, dim)."""
    if idx.dim() == 1:
        return _take(table, idx)
    g = _take(table, idx.reshape(-1)).reshape(*idx.shape, -1)
    if combiner == "sum":
        return g.sum(dim=-2)
    return g.mean(dim=-2)


def sharded_embedding_bag(table: torch.Tensor, idx: torch.Tensor, mesh: DeviceMesh, *,
                          axis: str, vocab: int, combiner: str = "mean") -> torch.Tensor:
    """Row-sharded lookup over the slots of ``axis``.

    Slot s holds rows [s·rows, (s+1)·rows) of the logical (vocab, dim)
    ``table``, rows = vocab / slots; ``idx`` is replicated. Each slot
    resolves the ids in its range against its rows and zeros the others;
    the slots' results are summed in slot order (the reference's psum).
    """
    slots = _axis_slots(mesh, axis)
    rows = vocab // len(slots)
    flat = idx.reshape(-1).long()
    g = None
    for s in range(len(slots)):
        local = flat - s * rows
        in_range = (local >= 0) & (local < rows)
        part = table[s * rows:(s + 1) * rows][local.clamp(0, rows - 1)]
        part = torch.where(in_range[:, None], part, 0.0)
        g = part if g is None else g + part
    g = g.reshape(*idx.shape, -1)
    if idx.dim() == 1:
        return g
    return g.sum(-2) if combiner == "sum" else g.mean(-2)


# ---------------------------------------------------------------------------
# Interactions
# ---------------------------------------------------------------------------


def dot_interaction(vectors: torch.Tensor, *, self_interaction: bool = False
                    ) -> torch.Tensor:
    """DLRM pairwise dots. vectors: (B, F, E) -> (B, F·(F−1)/2)."""
    F = vectors.shape[1]
    z = torch.einsum("bfe,bge->bfg", vectors, vectors)
    iu, ju = np.triu_indices(F, k=0 if self_interaction else 1)
    return z[:, torch.as_tensor(iu, device=z.device), torch.as_tensor(ju, device=z.device)]


def fm_interaction(vectors: torch.Tensor) -> torch.Tensor:
    """FM 2nd-order term: ½ Σ_e [(Σ_f v)² − Σ_f v²]. (B, F, E) -> (B,)."""
    s = vectors.sum(dim=1)
    s2 = (vectors ** 2).sum(dim=1)
    return 0.5 * (s ** 2 - s2).sum(dim=-1)


def init_autoint_attn(generator: torch.Generator | None, d_in: int, n_heads: int,
                      d_attn: int, dtype=torch.float32) -> nn.ModuleDict:
    g = generator
    return nn.ModuleDict({
        "wq": init_dense(g, d_in, n_heads * d_attn, dtype=dtype),
        "wk": init_dense(g, d_in, n_heads * d_attn, dtype=dtype),
        "wv": init_dense(g, d_in, n_heads * d_attn, dtype=dtype),
        "wr": init_dense(g, d_in, n_heads * d_attn, dtype=dtype),  # residual proj
    })


def apply_autoint_attn(p, x: torch.Tensor, n_heads: int, d_attn: int) -> torch.Tensor:
    """Self-attention over field tokens. x: (B, F, d) -> (B, F, H·d_attn)."""
    B, F, _ = x.shape
    f32 = torch.float32
    q = apply_dense(p["wq"], x, f32).reshape(B, F, n_heads, d_attn)
    k = apply_dense(p["wk"], x, f32).reshape(B, F, n_heads, d_attn)
    v = apply_dense(p["wv"], x, f32).reshape(B, F, n_heads, d_attn)
    s = torch.einsum("bfhd,bghd->bhfg", q, k) / np.sqrt(d_attn)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(B, F, n_heads * d_attn)
    r = apply_dense(p["wr"], x, f32)
    return torch.relu(o + r)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "recsys"
    kind: str = "dlrm"                      # dlrm | deepfm | autoint | two_tower
    vocab_sizes: tuple[int, ...] = ()
    embed_dim: int = 128
    n_dense: int = 0
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    # autoint
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    # deepfm
    deep_mlp: tuple[int, ...] = ()
    # two-tower
    tower_mlp: tuple[int, ...] = (1024, 512, 256)
    user_vocab: int = 2_000_000
    item_vocab: int = 1_000_000
    temperature: float = 0.05
    param_dtype: str = "float32"

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    def param_count(self) -> int:
        e = self.embed_dim
        emb = sum(self.vocab_sizes) * e
        if self.kind == "dlrm":
            dims = (self.n_dense,) + self.bot_mlp
            bot = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
            f = self.n_sparse + 1
            d_int = f * (f - 1) // 2 + self.bot_mlp[-1]
            dims = (d_int,) + self.top_mlp
            top = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
            return emb + bot + top
        if self.kind == "deepfm":
            first = sum(self.vocab_sizes)
            dims = (self.n_sparse * e,) + self.deep_mlp + (1,)
            deep = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
            return emb + first + deep
        if self.kind == "autoint":
            d_l = [e] + [self.n_heads * self.d_attn] * self.n_attn_layers
            attn = sum(4 * d_l[i] * d_l[i + 1] for i in range(self.n_attn_layers))
            out = self.n_sparse * d_l[-1]
            return emb + attn + out + 1
        # two_tower
        ue = self.user_vocab * e + self.item_vocab * e
        dims = (e,) + self.tower_mlp
        tower = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        return ue + 2 * tower


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


class RecsysModel(nn.Module):
    """A recsys parameter tree as modules: a tensor a parameter, a list of
    tensors a ``ParameterList``, a list of subtrees a ``ModuleList``, a
    mapping a module (``layers.as_module``). ``params`` holds tensors,
    lists, mappings or modules; modules and ``nn.Parameter``s are shared,
    not copied."""

    def __init__(self, cfg: RecsysConfig, params: Mapping):
        super().__init__()
        self.cfg = cfg
        for k, v in params.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, L._param(v))
            elif isinstance(v, nn.Module):
                self.add_module(k, v)
            elif isinstance(v, (list, tuple)):
                if all(isinstance(x, torch.Tensor) for x in v):
                    self.add_module(k, nn.ParameterList([L._param(x) for x in v]))
                else:
                    self.add_module(k, nn.ModuleList([L.as_module(x) for x in v]))
            else:
                self.add_module(k, L.as_module(v))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def init_recsys(cfg: RecsysConfig, *, generator: torch.Generator | None,
                device=None) -> RecsysModel:
    """The reference's init distributions: N(0, 1) / sqrt(dim) for every
    table, N(0, 1) / sqrt(d_in) for every dense weight, zero biases. Draws
    come from ``generator`` on its device in a fixed order (tables first),
    so a seed gives the same weights on the CPU and the card; the model
    then goes to ``device`` (default: the card; a CUDA generator draws the
    tables there, never on the host). Without a generator, shapes only:
    ``device`` must be ``"meta"``."""
    dev = default_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    g, gd = generator, L.gen_device(generator)
    e = cfg.embed_dim
    if cfg.kind == "two_tower":
        user, item = init_embedding_tables(g, (cfg.user_vocab, cfg.item_vocab), e, pdt)
        p = {"user_embed": user, "item_embed": item,
             "user_tower": init_mlp_stack(g, (e,) + cfg.tower_mlp, dtype=pdt),
             "item_tower": init_mlp_stack(g, (e,) + cfg.tower_mlp, dtype=pdt)}
    else:
        p = {"tables": init_embedding_tables(g, cfg.vocab_sizes, e, pdt)}
        if cfg.kind == "dlrm":
            p["bot_mlp"] = init_mlp_stack(g, (cfg.n_dense,) + cfg.bot_mlp, dtype=pdt)
            f = cfg.n_sparse + 1
            d_int = f * (f - 1) // 2 + cfg.bot_mlp[-1]
            p["top_mlp"] = init_mlp_stack(g, (d_int,) + cfg.top_mlp, dtype=pdt)
        elif cfg.kind == "deepfm":
            p["first_order"] = init_embedding_tables(g, cfg.vocab_sizes, 1, pdt)
            p["deep_mlp"] = init_mlp_stack(
                g, (cfg.n_sparse * e,) + cfg.deep_mlp + (1,), dtype=pdt)
            p["bias"] = torch.zeros((), dtype=pdt, device=gd)
        elif cfg.kind == "autoint":
            d_l = [e] + [cfg.n_heads * cfg.d_attn] * cfg.n_attn_layers
            p["attn_layers"] = [init_autoint_attn(g, d_l[i], cfg.n_heads, cfg.d_attn, pdt)
                                for i in range(cfg.n_attn_layers)]
            p["out"] = init_dense(g, cfg.n_sparse * d_l[-1], 1, bias=True, dtype=pdt)
    return RecsysModel(cfg, p).to(dev)


def _lookup_all(tables, sparse_idx: torch.Tensor, *, mesh: DeviceMesh | None = None,
                axis: str | None = None, vocab_sizes: Sequence[int] = ()) -> torch.Tensor:
    """sparse_idx: (B, F) -> stacked embeddings (B, F, E)."""
    cols = []
    for f, table in enumerate(tables):
        idx = sparse_idx[:, f]
        if mesh is None:
            cols.append(embedding_bag(table, idx))
        else:
            cols.append(sharded_embedding_bag(table, idx, mesh, axis=axis,
                                              vocab=int(vocab_sizes[f])))
    return torch.stack(cols, dim=1)


def _on(model: RecsysModel, batch: Mapping) -> dict:
    dev = model.device
    return {k: as_tensor(v, dev) for k, v in batch.items()}


def forward_ctr(model: RecsysModel, batch: Mapping, *, mesh: DeviceMesh | None = None,
                axis: str | None = None) -> torch.Tensor:
    """CTR logit. batch: sparse (B, F) int32 [+ dense (B, n_dense) for dlrm];
    with ``mesh`` the tables are looked up row-sharded over ``axis``."""
    batch = _on(model, batch)
    emb = _lookup_all(model.tables, batch["sparse"], mesh=mesh, axis=axis,
                      vocab_sizes=model.cfg.vocab_sizes)          # (B, F, E)
    return forward_ctr_from_emb(model, emb, batch)


def forward_ctr_from_emb(model: RecsysModel, emb: torch.Tensor, batch: Mapping
                         ) -> torch.Tensor:
    """CTR logit from pre-gathered embeddings (B, F, E).

    Split out so the training step can gather rows OUTSIDE autograd and
    differentiate w.r.t. the rows themselves (sparse-grad path — see
    ``optim.rowwise``). It reads no table (DeepFM's ``first_order`` is not
    one)."""
    cfg = model.cfg
    if cfg.kind == "dlrm":
        dense_v = apply_mlp_stack(model.bot_mlp, batch["dense"], act="relu", final_act=True)
        feats = torch.cat([dense_v[:, None, :], emb], dim=1)
        inter = dot_interaction(feats)
        z = torch.cat([dense_v, inter], dim=-1)
        return apply_mlp_stack(model.top_mlp, z, act="relu")[:, 0]
    if cfg.kind == "deepfm":
        fm2 = fm_interaction(emb)
        first = sum(embedding_bag(t, batch["sparse"][:, f])[:, 0]
                    for f, t in enumerate(model.first_order))
        deep = apply_mlp_stack(model.deep_mlp, emb.reshape(emb.shape[0], -1),
                               act="relu")[:, 0]
        return model.bias + first + fm2 + deep
    # autoint
    x = emb
    for lp in model.attn_layers:
        x = apply_autoint_attn(lp, x, cfg.n_heads, cfg.d_attn)
    flat = x.reshape(x.shape[0], -1)
    return apply_dense(model.out, flat, torch.float32)[:, 0]


def bce_from_logit(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits, the reference's stable form."""
    return torch.mean(torch.clamp_min(logit, 0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def bce_loss(model: RecsysModel, batch: Mapping, *, mesh: DeviceMesh | None = None,
             axis: str | None = None) -> torch.Tensor:
    logit = forward_ctr(model, batch, mesh=mesh, axis=axis)
    return bce_from_logit(logit, as_tensor(batch["label"], model.device).float())


# -- two-tower ---------------------------------------------------------------


def _l2_normalised(u: torch.Tensor) -> torch.Tensor:
    return u / torch.clamp_min(torch.linalg.vector_norm(u, dim=-1, keepdim=True), 1e-9)


def user_embedding(model: RecsysModel, user_ids) -> torch.Tensor:
    e = _take(model.user_embed, as_tensor(user_ids, model.device))
    return _l2_normalised(apply_mlp_stack(model.user_tower, e, act="relu"))


def item_embedding(model: RecsysModel, item_ids) -> torch.Tensor:
    e = _take(model.item_embed, as_tensor(item_ids, model.device))
    return _l2_normalised(apply_mlp_stack(model.item_tower, e, act="relu"))


def _in_batch_softmax(u: torch.Tensor, v: torch.Tensor, logq: torch.Tensor,
                      labels: torch.Tensor, temperature: float) -> torch.Tensor:
    """Mean over u's rows of -log softmax(u · vᵀ / T − logq) at each row's
    label, f32."""
    logits = (u @ v.T) / temperature - logq[None, :]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def two_tower_loss(model: RecsysModel, batch: Mapping) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction.

    batch: user_ids (B,), item_ids (B,), item_logq (B,) — log sampling
    probability of each in-batch negative (Yi et al., RecSys'19). The
    reference's optional logit sharding constraint places nothing on one
    card and has no counterpart.
    """
    batch = _on(model, batch)
    u = user_embedding(model, batch["user_ids"])
    v = item_embedding(model, batch["item_ids"])
    labels = torch.arange(u.shape[0], device=u.device)
    return _in_batch_softmax(u, v, batch["item_logq"], labels, model.cfg.temperature)


def two_tower_loss_sharded(model: RecsysModel, batch: Mapping, mesh: DeviceMesh,
                           axis: str | tuple[str, ...] = "data") -> torch.Tensor:
    """Sharded in-batch softmax: the (B, B) logits blocked over the slots of
    ``axis``. Slot ``idx`` takes rows [idx·b, (idx + 1)·b) and embeds them;
    the items and their logQ are gathered in slot order; each slot scores
    its users against all items with labels ``idx·b + arange(b)``, and the
    loss is the mean of the slot means (the reference's ``pmean``). One
    process over the mesh; every slot must sit on the model's device."""
    slots = _axis_slots(mesh, axis)
    n = len(slots)
    batch = _on(model, batch)
    B = batch["user_ids"].shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows does not split over {n} slots of {axis!r}")
    if any(dev != model.device for dev in slots):
        raise ValueError(f"a slot of {axis!r} is not on the model's device {model.device}")
    b = B // n
    part = [{k: v[i * b:(i + 1) * b] for k, v in batch.items()} for i in range(n)]
    us = [user_embedding(model, r["user_ids"]) for r in part]
    v_all = torch.cat([item_embedding(model, r["item_ids"]) for r in part])
    logq_all = torch.cat([r["item_logq"] for r in part])
    arange = torch.arange(b, device=model.device)
    return torch.stack([_in_batch_softmax(u, v_all, logq_all, idx * b + arange,
                                          model.cfg.temperature)
                        for idx, u in enumerate(us)]).mean()


def ctr_user_item_split(cfg: RecsysConfig) -> tuple[int, int]:
    """Field split for CTR retrieval: first half user-side, rest item-side."""
    f_user = cfg.n_sparse // 2
    return f_user, cfg.n_sparse - f_user


def ctr_retrieval_scores(model: RecsysModel, user_batch: Mapping, cand_sparse
                         ) -> torch.Tensor:
    """Score one user context against C candidate items (CTR models).

    ``user_batch``: sparse (1, F_user) [+ dense (1, n_dense)];
    ``cand_sparse``: (C, F_item). The user fields broadcast across
    candidates. Returns logits (C,).
    """
    user_batch = _on(model, user_batch)
    cand = as_tensor(cand_sparse, model.device)
    C = cand.shape[0]
    user_sp = user_batch["sparse"].expand(C, user_batch["sparse"].shape[1])
    batch = {"sparse": torch.cat([user_sp, cand], dim=1)}
    if "dense" in user_batch:
        batch["dense"] = user_batch["dense"].expand(C, user_batch["dense"].shape[1])
    return forward_ctr(model, batch)


def score_candidates(model: RecsysModel, user_ids, item_index, k: int = 100
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Retrieval: user(s) vs a precomputed (possibly PCA-pruned) item index.

    ``item_index``: (n_candidates, m) rows or a ``DenseIndex`` — built
    offline via ``item_embedding`` + optional ``core.StaticPruner``; queries
    must be transformed by the same pruner before calling. The search is
    the index's: one ``topk_score`` launch on the card, ``_scan_topk`` on
    the CPU (an int8 index's scale folded into the query first).
    """
    from repro_torch.core.index import DenseIndex
    index = item_index if isinstance(item_index, DenseIndex) else DenseIndex(
        vectors=as_tensor(item_index, model.device))
    u = user_embedding(model, user_ids)
    return index._topk(index._dequeries(u), min(k, index.n))
