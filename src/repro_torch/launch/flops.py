"""Cost accounting for the roofline (port of ``repro/launch/flops.py``).

``step_cost(bundle)`` runs the bundle's step on meta tensors at the cell's
global shapes: the model the bundle holds on the meta device, its
optimizer state (``bundle.opt_init``) and the shape stand-ins of every
other argument. Nothing is allocated and nothing is computed; a
``TorchDispatchMode`` sees every aten op the step dispatches, forward and
backward, and counts:

  * FLOPs: 2·out·K for the products (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, ``mv``, ``dot``; the fused adds of ``addmm`` /
    ``baddbmm`` one a result element), the input's elements for a
    reduction, and the result's elements for an elementwise op, by the
    reference's lists of ``jax.lax`` primitives mapped to their aten
    names (``_REDUCE``, ``_ELEMENTWISE``). The products alone are
    ``matmul_flops``;
  * bytes: operand plus result bytes of the aten counterparts of the
    reference's memory ops (``_MEM``: products, gathers, scatters and
    segment reductions, concatenations, reductions, sorts, top-k), an
    HBM-traffic proxy that assumes perfect elementwise fusion, as the
    reference's does.

Counts are global (the step runs unpartitioned). The port's layer loops
are eager, so every layer is counted, and a layer recomputed under
``torch.utils.checkpoint`` is counted again in the backward: the
reference's "remat recompute is included".

The reference's ``hlo_collectives`` has no counterpart: the port compiles
no partitioned program, so there is no per-device collective to count.
Its records say so, and the roofline's collective term is not counted.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the reference's reductions: reduce_sum/max/min, cumsum, argmax/argmin,
# reduce_and/or (mean is a reduce_sum and a div there)
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "cumsum", "argmax", "argmin",
           "any", "all", "logsumexp"}
# the reference's elementwise primitives: exp, log, tanh, logistic, erf,
# rsqrt, sqrt, sin, cos, pow, integer_pow, add, sub, mul, div, max, min,
# select_n; a composite aten op counts one a primitive it stands for
_ELEMENTWISE = {"exp": 1, "log": 1, "tanh": 1, "sigmoid": 1, "erf": 1, "rsqrt": 1, "sqrt": 1,
                "sin": 1, "cos": 1, "pow": 1, "add": 1, "sub": 1, "rsub": 1, "mul": 1,
                "div": 1, "reciprocal": 1, "maximum": 1, "minimum": 1, "clamp": 1,
                "clamp_min": 1, "clamp_max": 1, "where": 1, "square": 1, "log1p": 1,
                "expm1": 1, "addcmul": 2, "addcdiv": 2, "lerp": 2,
                "sigmoid_backward": 2, "tanh_backward": 2, "threshold_backward": 1,
                "_softmax": 4, "_log_softmax": 5, "_softmax_backward_data": 3,
                "_log_softmax_backward_data": 3}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}
# the reference's _MEM_OPS: dot_general, gather, scatter(-add), dynamic
# (update) slices, concatenate, take, reductions, cumsum, sort, top_k, conv
_MEM = _MATMUL | {"index_select", "gather", "index", "embedding", "embedding_dense_backward",
                  "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_add",
                  "scatter_reduce", "index_add", "index_add_", "segment_reduce",
                  "_segment_reduce_backward", "cat", "slice_scatter", "select_scatter",
                  "index_copy",
                  "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "cumsum",
                  "sort", "topk", "convolution"}


def _base(func) -> str:
    """An aten overload's op name without its overload and in-place mark:
    ``aten.add_.Tensor`` -> ``add``."""
    name = func._overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, Mapping):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args, out) -> int:
    """2·out·K, K the first operand's last dim."""
    a = args[-2]
    return 2 * max(out.numel(), 1) * a.shape[-1]


def op_cost(func, args, kwargs, out) -> tuple[int, int, int]:
    """(FLOPs, bytes, matmul FLOPs) of one aten call."""
    name = _base(func)
    outs = list(_tensors(out))
    flops = mm = byts = 0
    if name in _MATMUL:
        mm = _matmul_flops(name, args, outs[0])
        flops = mm + (outs[0].numel() if name in ("addmm", "baddbmm") else 0)
    elif name in _REDUCE:
        ins = list(_tensors(args[:1]))
        flops = ins[0].numel() if ins else 0
        if name == "mean":
            flops += outs[0].numel()
    elif name in _ELEMENTWISE and outs and outs[0].is_floating_point():
        flops = _ELEMENTWISE[name] * outs[0].numel()
    if name in _MEM:
        byts = sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(map(_nbytes, outs))
    return flops, byts, mm


_FUNCTIONAL: dict = {}


def _functional(func) -> bool:
    """An op that neither writes nor aliases any argument: its results are
    fresh tensors, so on meta tensors they depend only on the arguments'
    shapes, strides and dtypes."""
    known = _FUNCTIONAL.get(func)
    if known is None:
        schema = func._schema
        known = _FUNCTIONAL[func] = (all(a.alias_info is None for a in schema.arguments)
                                     and all(r.alias_info is None for r in schema.returns))
    return known


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format)


class _NotMeta(Exception):
    pass


def _key(x):
    """A hashable layout of an argument tree; raises ``_NotMeta`` on a
    tensor off the meta device."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NotMeta
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, Mapping):
        return tuple((k, _key(v)) for k, v in sorted(x.items()))
    return x if isinstance(x, _SCALARS) else repr(x)


def _like(spec):
    """Fresh meta tensors of a cached result's layouts (``_spec``)."""
    if isinstance(spec, list):
        return tuple(_like(v) for v in spec)
    if isinstance(spec, tuple):
        shape, stride, dtype = spec
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    return spec


def _spec(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (tuple, list)):
        return [_spec(v) for v in out]
    return out


class CostMode(TorchDispatchMode):
    """Counts every aten op dispatched under it (``op_cost``) and remembers
    the last op (``last_op``), so a step that fails can name where it
    stopped.

    On meta tensors a functional op's results and cost depend only on its
    arguments' layouts: the first call of each (op, layouts, scalars) runs
    the op's meta kernel, later ones make fresh meta tensors of the cached
    layouts (a model's layers repeat the same calls, and meta kernels of
    elementwise ops run in Python, at ~0.25 ms a call)."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.matmul_flops = 0
        self.last_op = None
        self._cache: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.last_op = str(func)
        key = None
        if _functional(func):
            try:
                key = (func, _key(args), _key(kwargs) if kwargs else ())
            except _NotMeta:
                key = None
            hit = None if key is None else self._cache.get(key)
            if hit is not None:
                spec, cost = hit
                self._add(cost)
                return _like(spec)
        out = func(*args, **kwargs)
        cost = op_cost(func, args, kwargs, out)
        if key is not None:
            self._cache[key] = (_spec(out), cost)
        self._add(cost)
        return out

    def _add(self, cost):
        f, b, mm = cost
        self.flops += f
        self.bytes += b
        self.matmul_flops += mm


def _meta_args(bundle):
    """The step's arguments on the meta device: the bundle's model, an
    optimizer state from ``opt_init`` for a train step, then the bundle's
    stand-ins."""
    model = bundle.model
    if bundle.opt_init is not None:
        model.requires_grad_(True)
        return (model, bundle.opt_init(model), *bundle.args[2:])
    model.requires_grad_(False)
    return (model, *bundle.args[1:])


def step_cost(bundle) -> dict:
    """Global FLOPs, matmul FLOPs and the HBM-byte proxy of one call of
    ``bundle.fn`` at the cell's shapes, on meta tensors. A step whose
    output shape depends on data it cannot see on meta raises; the
    exception carries ``last_op``, the aten op it stopped in."""
    mode = CostMode()
    try:
        with mode:
            bundle.fn(*_meta_args(bundle))
    except Exception as e:
        e.last_op = mode.last_op
        raise
    finally:
        if bundle.model is not None:
            bundle.model.requires_grad_(False)
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "matmul_flops": float(mode.matmul_flops)}


def _spec_divisor(spec, mesh_sizes: Mapping[str, int], dim: int) -> int:
    part = spec[dim] if spec is not None and dim < len(spec) else None
    if part is None:
        return 1
    axes = part if isinstance(part, tuple) else (part,)
    return math.prod(mesh_sizes[a] for a in axes)


def per_device_bytes(args, specs, mesh) -> int:
    """Bytes of ``args`` (a tree of tensors or shape stand-ins) that one
    device holds when each leaf is laid out by its spec in ``specs`` on
    ``mesh``: every sharded dim split over the product of its axes, an
    uneven split rounded up (the largest shard)."""
    from repro_torch.convert import _leaves
    from repro_torch.par.sharding import PartitionSpec

    sizes = dict(zip(mesh.axis_names, mesh.shape))
    leaves = [v for _, v in _leaves(_sorted(list(args)))]
    spec_leaves = [s for _, s in _leaves(_sorted(list(specs)))]
    if len(leaves) != len(spec_leaves) or not all(
            isinstance(s, PartitionSpec) for s in spec_leaves):
        raise ValueError(f"{len(leaves)} arguments against {len(spec_leaves)} specs")
    total = 0
    for t, spec in zip(leaves, spec_leaves):
        n = 1
        for d, size in enumerate(t.shape):
            n *= -(-size // _spec_divisor(tuple(spec), sizes, d))
        total += n * t.element_size()
    return total


def _sorted(tree):
    """Dicts with sorted keys, tuples as lists: the reference's (JAX's)
    flattening order for ``convert._leaves``."""
    if isinstance(tree, (tuple, list)):
        return [_sorted(v) for v in tree]
    if isinstance(tree, Mapping):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree
