"""Carry fitted state across from numpy arrays (for example ``repro``'s
``PCAState``, ``DenseIndex``, ``ShardedDenseIndex``, ``CascadeIndex`` or
``PagedIndexStorage`` fields, or a bi-encoder's, decoder LM's or recsys
model's parameter tree and its AdamW, Adafactor or rowwise state, converted
with ``np.asarray``) into the port's objects, and models and optimizer
states back into the reference's trees, whose layers are stacked on a
leading axis and whose lists (a recsys model's ``tables``, MLP stacks and
``attn_layers``) stay lists. A KV cache keeps the reference's (L, B, S,
Hkv, Dh) layout and needs no conversion."""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.cascade import CascadeIndex
from repro_torch.core.index import DenseIndex, ShardedDenseIndex
from repro_torch.core.paged import PageExtent, PagedIndex, PagedIndexStorage
from repro_torch.core.pca import PCAState
from repro_torch.models.biencoder import BiEncoder, BiEncoderConfig
from repro_torch.models.recsys import RecsysConfig, RecsysModel
from repro_torch.models.transformer import LM, TransformerConfig
from repro_torch.util import as_tensor


def pca_state_from_numpy(components: np.ndarray, eigenvalues: np.ndarray,
                         mean: np.ndarray, n_samples: int, centered: bool,
                         device=None) -> PCAState:
    """A port ``PCAState`` on ``device`` (default: the card)."""
    return PCAState(
        components=as_tensor(np.asarray(components, np.float32), device),
        eigenvalues=as_tensor(np.asarray(eigenvalues, np.float32), device),
        mean=as_tensor(np.asarray(mean, np.float32), device),
        n_samples=int(n_samples), centered=bool(centered))


def dense_index_from_numpy(vectors: np.ndarray, scale: np.ndarray | None,
                           device=None) -> DenseIndex:
    """A port ``DenseIndex`` over the given (possibly int8) vectors."""
    v = as_tensor(np.ascontiguousarray(vectors), device)
    s = None if scale is None else as_tensor(np.asarray(scale, np.float32), device)
    return DenseIndex(vectors=v, scale=s)


def sharded_index_from_numpy(vectors: np.ndarray, scale: np.ndarray | None,
                             mesh, n_real: int | None = None,
                             merge: str = "flat") -> ShardedDenseIndex:
    """A port ``ShardedDenseIndex`` over ``mesh`` holding the first
    ``n_real`` rows of ``vectors`` (default: all of them), so a reference
    index's padded vectors come across without their padding."""
    v = np.ascontiguousarray(np.asarray(vectors)[:n_real])
    return ShardedDenseIndex.from_rows(
        as_tensor(v, mesh.device), mesh, merge=merge,
        scale=None if scale is None else np.asarray(scale, np.float32))


def cascade_index_from_numpy(coarse_vectors: np.ndarray, coarse_scale: np.ndarray | None,
                             full_vectors: np.ndarray, full_scale: np.ndarray | None,
                             n_factor: int = 8, device=None) -> CascadeIndex:
    """A port ``CascadeIndex`` over a dense cascade's two resolutions: the
    coarse (n, m_coarse) and full (n, m) vectors, each with its scale (or
    None), byte for byte."""
    return CascadeIndex(coarse=dense_index_from_numpy(coarse_vectors, coarse_scale, device),
                        full=dense_index_from_numpy(full_vectors, full_scale, device),
                        n_factor=n_factor)


def paged_index_from_numpy(pool: np.ndarray, tail: np.ndarray,
                           host_pages: dict, page_table: np.ndarray,
                           page_nvalid: np.ndarray, page_offset: np.ndarray,
                           page_scale: np.ndarray | None, extents,
                           free_pool, free_tail, *, page_rows: int,
                           seal_rows: int, device=None, depth: int = 2,
                           wave_pages: int = 8) -> PagedIndex:
    """A port ``PagedIndex`` holding a reference storage's bytes: ``pool``
    (P, R, m) and ``tail`` (T, R, m) f32 or int8, ``host_pages`` slot ->
    (R, m) page, the page table and its metadata, and ``extents`` as
    sequences of (kind, sealed, start_slot, n_pages, n_rows, row_offset,
    scale, raw). The metadata arrays are copied; each page's scale row in
    ``page_scale`` must be its extent's scale, as the reference keeps it."""
    pool_t = as_tensor(np.ascontiguousarray(pool), device)
    dev = pool_t.device

    def host(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.pin_memory() if dev.type == "cuda" else t

    pt = np.array(page_table, np.int32)
    nv = np.array(page_nvalid, np.int32)
    off = np.array(page_offset, np.int32)
    sc = None if page_scale is None else np.array(page_scale, np.float32)
    exts = tuple(PageExtent(str(e[0]), bool(e[1]), *map(int, e[2:6]),
                            None if e[6] is None else np.array(e[6], np.float32),
                            None if e[7] is None else np.array(e[7], np.float32))
                 for e in extents)
    st = PagedIndexStorage(
        pool=pool_t, tail=torch.tensor(np.ascontiguousarray(tail), device=dev),
        page_table=torch.tensor(pt, device=dev),
        page_scale=None if sc is None else torch.tensor(sc, device=dev),
        page_nvalid=torch.tensor(nv, device=dev),
        page_offset=torch.tensor(off, device=dev),
        pt_host=pt, nvalid_host=nv, offset_host=off,
        host_pages={int(s): host(p) for s, p in host_pages.items()},
        extents=exts, free_pool=tuple(int(x) for x in free_pool),
        free_tail=tuple(int(x) for x in free_tail), page_rows=int(page_rows),
        seal_rows=int(seal_rows))
    return PagedIndex(storage=st, depth=depth, wave_pages=wave_pages)


def _tensor_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensor_tree(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: carry the bits
        return as_tensor(a.view(np.uint16).copy(), device).view(torch.bfloat16)
    return as_tensor(np.array(a, copy=True), device)


def _unstacked_tree(params: dict, n_layers: int, device) -> dict:
    """A reference parameter tree as tensors on ``device``, its ``layers``
    subtree (every leaf stacked on a leading ``n_layers`` axis: the
    reference inits its layers under ``vmap``) split into one tree per
    layer (views); dtypes are kept."""
    tree = _tensor_tree(params, device)

    def layer(t, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in t.items()}

    stacked = tree.pop("layers")
    tree["layers"] = [layer(stacked, i) for i in range(n_layers)]
    return tree


def biencoder_from_numpy(params: dict, cfg: BiEncoderConfig, device=None) -> BiEncoder:
    """A port ``BiEncoder`` on ``device`` (default: the card) holding a
    reference parameter tree: ``embed``, ``pos_embed``, ``final_norm``,
    ``proj`` and the stacked ``layers``."""
    return BiEncoder(cfg, _unstacked_tree(params, cfg.n_layers, device))


def recsys_from_numpy(params: dict, cfg: RecsysConfig, device=None) -> RecsysModel:
    """A port ``RecsysModel`` on ``device`` (default: the card) holding a
    reference ``init_recsys`` tree: ``tables`` (and DeepFM's
    ``first_order``) lists of tables, MLP stacks and AutoInt's
    ``attn_layers`` lists of layers, the two-tower's ``user_embed`` /
    ``item_embed``; dtypes are kept."""
    return RecsysModel(cfg, _tensor_tree(params, device))


def lm_from_numpy(params: dict, cfg: TransformerConfig, device=None) -> LM:
    """A port ``LM`` on ``device`` (default: the card) holding a reference
    ``init_lm`` tree: ``embed``, ``final_norm``, ``unembed`` unless tied, and
    the stacked ``layers`` (MoE layers' ``moe/router/w`` (L, d, E) and
    expert leaves (L, E, d, f) included)."""
    return LM(cfg, _unstacked_tree(params, cfg.n_layers, device))


# ---------------------------------------------------------------------------
# the reference's stacked layer tree <-> the port's named tensors
# ---------------------------------------------------------------------------


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _leaves(tree, prefix=()):
    items = tree.items() if isinstance(tree, Mapping) else (
        (str(i), v) for i, v in enumerate(tree))
    for k, v in items:
        if isinstance(v, (Mapping, list)):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _listed(tree):
    """Mappings whose keys are all positions ("0", "1", ...) as lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _listed(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out) and sorted(map(int, out)) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def _stacked(name: str) -> bool:
    """Whether the parameter ``name`` is one layer's slice of a leaf that the
    reference stacks over its layers."""
    return name.split(".")[0] == "layers"


def decay_mask(named: Mapping[str, torch.Tensor]) -> dict[str, bool]:
    """The reference's AdamW decay mask (a leaf with ndim >= 2) by the port's
    names, for ``optim.adamw_init``: a stacked leaf has one dimension more
    than its ``layers.<i>.…`` tensor, so every per-layer tensor decays (the
    layer norms' ``(d,)`` scales and biases too) and ``final_norm`` does
    not."""
    return {n: t.ndim + _stacked(n) >= 2 for n, t in named.items()}


def stack_layers(named: Mapping[str, torch.Tensor]) -> dict:
    """Tensors named as ``named_parameters()`` names them, as the
    reference's tree: nested dicts, with each ``layers.<i>.<path>`` tensor
    stacked over i (on its device) into the leaf ``layers/<path>``, and a
    node of positions (``tables.0``, ``tables.1``, ...) a list."""
    tree, per_layer = {}, {}
    for name, t in named.items():
        parts = name.split(".")
        if _stacked(name):
            per_layer.setdefault(tuple(parts[2:]), {})[int(parts[1])] = t
        else:
            _put(tree, parts, t)
    for path, by_layer in per_layer.items():
        _put(tree, ("layers", *path), torch.stack([by_layer[i] for i in range(len(by_layer))]))
    return _listed(tree)


def unstack_layers(tree: Mapping) -> dict:
    """The inverse of ``stack_layers``: a reference tree's leaves by the
    port's names, each ``layers/<path>`` leaf split on its leading axis
    into ``layers.<i>.<path>`` (views, not copies)."""
    out = {}
    for path, v in _leaves(tree):
        if path[0] == "layers":
            for i in range(v.shape[0]):
                out[".".join(("layers", str(i), *path[1:]))] = v[i]
        else:
            out[".".join(path)] = v
    return out


def _numpy_tree(tree):
    """Tensors as numpy copies; bf16 widens to f32, exactly (numpy has no bf16)."""
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).to("cpu", copy=True).numpy()


def reference_shapes(named: Mapping[str, torch.Tensor]) -> dict:
    """The reference's tree of the parameters ``named``, as meta tensors of
    its (stacked) shapes and dtypes: what its sharding rules read. No
    memory is touched."""
    return stack_layers({n: t.to("meta") for n, t in named.items()})


def biencoder_to_numpy(model: BiEncoder) -> dict:
    """The model's parameters as the reference's tree of numpy arrays
    (layers stacked on a leading axis): the inverse of
    ``biencoder_from_numpy`` (bf16 parameters come back as their f32
    values)."""
    return _numpy_tree(stack_layers(dict(model.named_parameters())))


def lm_to_numpy(model: LM) -> dict:
    """The inverse of ``lm_from_numpy``, as ``biencoder_to_numpy`` is of
    ``biencoder_from_numpy``."""
    return _numpy_tree(stack_layers(dict(model.named_parameters())))


def recsys_to_numpy(model: RecsysModel) -> dict:
    """The inverse of ``recsys_from_numpy``: the model's parameters as the
    reference's tree of numpy arrays, lists as lists."""
    return _numpy_tree(stack_layers(dict(model.named_parameters())))


def adamw_state_tree(state: Mapping) -> dict:
    """An ``optim.adamw`` state as the reference's ``adamw_init`` tree of
    tensors: ``mu`` and ``nu`` stacked as the parameters are, and ``step``."""
    return {"mu": stack_layers(state["mu"]), "nu": stack_layers(state["nu"]),
            "step": state["step"]}


def adamw_state_to_numpy(state: Mapping) -> dict:
    """``adamw_state_tree`` as numpy arrays (``step`` a 0-d int32 array)."""
    return _numpy_tree(adamw_state_tree(state))


def adamw_state_from_numpy(tree: Mapping, device=None) -> dict:
    """A reference AdamW state (``mu``, ``nu`` stacked trees, ``step``) as
    the port's, on ``device`` (default: the card); each moment a fresh
    contiguous f32 tensor named as the model's parameters are, and the
    reference's decay mask."""
    def moments(t):
        return {n: as_tensor(np.array(v, dtype=np.float32, copy=True), device)
                for n, v in unstack_layers(t).items()}

    mu = moments(tree["mu"])
    return {"mu": mu, "nu": moments(tree["nu"]),
            "step": as_tensor(np.asarray(tree["step"], dtype=np.int32).reshape(()), device),
            "decay": decay_mask(mu)}


def adafactor_state_to_numpy(state: Mapping) -> dict:
    """An ``optim.adafactor`` state (already the reference's tree: ``v`` of
    ``vr`` / ``vc`` or ``v`` per stacked leaf, and ``step``) as numpy."""
    return _numpy_tree(state)


def adafactor_state_from_numpy(tree: Mapping, device=None) -> dict:
    """A reference Adafactor state as the port's, on ``device`` (default:
    the card): fresh f32 statistics and an int32 ``step``."""
    def leaf(v):
        if isinstance(v, Mapping):
            return {k: leaf(x) for k, x in v.items()}
        return as_tensor(np.array(v, dtype=np.float32, copy=True), device)

    return {"v": leaf(tree["v"]),
            "step": as_tensor(np.asarray(tree["step"], dtype=np.int32).reshape(()), device)}


def rowwise_state_tree(state: Mapping) -> dict:
    """A rowwise state (``configs.steps.rowwise_opt_init``'s: AdamW over the
    non-table parameters and one accumulator a table) as the reference's
    tree: ``{"adamw": {"mu", "nu", "step"}, "acc": [...]}``."""
    return {"adamw": adamw_state_tree(state["adamw"]), "acc": list(state["acc"])}


def rowwise_state_to_numpy(state: Mapping) -> dict:
    """``rowwise_state_tree`` as numpy arrays."""
    return _numpy_tree(rowwise_state_tree(state))


def rowwise_state_from_numpy(tree: Mapping, device=None) -> dict:
    """A reference rowwise state as the port's, on ``device`` (default: the
    card): the AdamW part as ``adamw_state_from_numpy`` gives it, each
    accumulator a fresh f32 tensor."""
    return {"adamw": adamw_state_from_numpy(tree["adamw"], device),
            "acc": [as_tensor(np.array(a, dtype=np.float32, copy=True), device)
                    for a in tree["acc"]]}


def _is_adafactor(opt_state: Mapping) -> bool:
    return "v" in opt_state


def _is_rowwise(opt_state: Mapping) -> bool:
    return "acc" in opt_state


def _restore_adamw(state: dict, tree: Mapping) -> None:
    for key in ("mu", "nu"):
        for name, t in unstack_layers(tree[key]).items():
            state[key][name].copy_(t)
    state["step"] = tree["step"].to(torch.int32)


@torch.no_grad()
def checkpoint_tree(model: torch.nn.Module, opt_state: Mapping) -> tuple[dict, dict]:
    """``(params, opt_state)`` as the reference checkpoints them: its trees,
    layers stacked, lists as lists, as tensors on the model's device. An
    AdamW state's moments are stacked as the parameters are; an Adafactor
    state is in that layout already; a rowwise state is its AdamW part and
    the accumulators (``rowwise_state_tree``)."""
    if _is_rowwise(opt_state):
        opt = rowwise_state_tree(opt_state)
    elif _is_adafactor(opt_state):
        opt = dict(opt_state)
    else:
        opt = adamw_state_tree(opt_state)
    return stack_layers(dict(model.named_parameters())), opt


@torch.no_grad()
def restore_into(model: torch.nn.Module, opt_state: dict, tree: tuple[dict, dict]) -> None:
    """Copy a ``checkpoint_tree``-shaped tree into the model's parameters
    and the optimizer state, in place."""
    params, opt = tree
    named = dict(model.named_parameters())
    for name, t in unstack_layers(params).items():
        named[name].copy_(t)
    if _is_rowwise(opt_state):
        _restore_adamw(opt_state["adamw"], opt["adamw"])
        for a, t in zip(opt_state["acc"], opt["acc"]):
            a.copy_(t)
    elif _is_adafactor(opt_state):
        have = dict(_leaves(opt_state["v"]))
        for path, t in _leaves(opt["v"]):
            have[path].copy_(t)
        opt_state["step"] = opt["step"].to(torch.int32)
    else:
        _restore_adamw(opt_state, opt)

