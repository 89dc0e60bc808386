"""The paged top-k's slot range [lo, hi) as 0-d device tensors, on the CPU.

``topk_score_paged_ref`` (what ``ops.topk_score_paged`` runs on CPU
tensors) with 0-d int32 tensor bounds is held bitwise to the same call with
host ints, and both to the reference's ``repro.kernels.ops.topk_score_paged``
(Pallas in interpret mode, as ``tests/test_kernels.py`` runs it) with
``jnp.int32`` bounds: ids equal, scores at rtol = atol = 1e-5. Every mode
(f32, bf16, int8 with per-page scales, the tail tier, the ``ids_pool``
rescore, a ``carry`` / ``finalize=False`` chain) at k 3 and at a k larger
than a page, over a full, an inner, an empty and an at-capacity range.
Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_score_paged_ref

TOL = dict(rtol=1e-5, atol=1e-5)
R, M, B = 8, 16, 4          # rows a page, width, queries
POOL_PAGES, TAIL_PAGES = 7, 6
NPAGES, N_LAST = 12, 5      # pages written (the last one partial)
CAP = 14                    # the table's capacity: slots 12 and 13 are empty
RANGES = {"full": (0, NPAGES), "inner": (3, 9), "empty": (6, 6), "at_capacity": (2, CAP)}
KS = (3, 12)                # 12 > R: the k > page path
MODES = ("f32", "bf16", "int8", "ids_pool")


def _layout(mode: str, seed: int = 0) -> dict:
    """NPAGES pages scattered over a pool and a tail (table entries past the
    pool address the tail), a partial last page, two empty slots at the end
    of the table; int8 pages carry per-page scales, ``ids_pool`` pages
    shuffled ids with one masked row."""
    rng = np.random.default_rng(seed)
    n = (NPAGES - 1) * R + N_LAST
    D = rng.standard_normal((n, M)).astype(np.float32)
    pt = np.full(CAP, -1, np.int32)
    pt[:NPAGES] = rng.permutation(NPAGES)
    nv = np.zeros(CAP, np.int32)
    nv[:NPAGES] = R
    nv[NPAGES - 1] = N_LAST
    off = np.zeros(CAP, np.int32)
    off[:NPAGES] = np.arange(NPAGES) * R
    store = np.int8 if mode == "int8" else np.float32
    pool = np.zeros((POOL_PAGES, R, M), store)
    tail = np.zeros((TAIL_PAGES, R, M), store)
    scale = np.zeros((CAP, M), np.float32)
    for j in range(NPAGES):
        rows = D[j * R:j * R + nv[j]]
        if mode == "int8":
            scale[j] = np.abs(rows).max(axis=0).clip(1e-12) / 127.0
            rows = np.clip(np.round(rows / scale[j]), -127, 127).astype(np.int8)
        buf, i = (pool, pt[j]) if pt[j] < POOL_PAGES else (tail, pt[j] - POOL_PAGES)
        buf[i, :nv[j]] = rows
    ids_pool = None
    if mode == "ids_pool":
        ids_pool = np.full((CAP, R), -1, np.int32)
        ids = rng.permutation(NPAGES * R).astype(np.int32) + 5
        for j in range(NPAGES):
            ids_pool[j, :nv[j]] = ids[j * R:j * R + nv[j]]
        ids_pool[4, 2] = -1
    return dict(pool=pool, tail=tail, pt=pt, nv=nv, off=off,
                Q=rng.standard_normal((B, M)).astype(np.float32),
                scale=scale if mode == "int8" else None, ids_pool=ids_pool,
                bf16=mode == "bf16")


def _torch_args(f):
    t = {k: None if v is None or isinstance(v, bool) else torch.from_numpy(v)
         for k, v in f.items()}
    if f["bf16"]:
        t["pool"], t["tail"] = t["pool"].to(torch.bfloat16), t["tail"].to(torch.bfloat16)
    return t


def _port(f, lo, hi, k, *, carry=None, finalize=True, fn=topk_score_paged_ref):
    t = _torch_args(f)
    return fn(t["pool"], t["pt"], t["nv"], t["off"], lo, hi, t["Q"], k=k, tail=t["tail"],
              page_scale=t["scale"], ids_pool=t["ids_pool"], carry=carry,
              finalize=finalize)


def _jax(f, lo, hi, k, *, carry=None, finalize=True):
    pool, tail = jnp.asarray(f["pool"]), jnp.asarray(f["tail"])
    if f["bf16"]:
        pool, tail = pool.astype(jnp.bfloat16), tail.astype(jnp.bfloat16)
    opt = {name: None if f[key] is None else jnp.asarray(f[key])
           for name, key in (("page_scale", "scale"), ("ids_pool", "ids_pool"))}
    return jops.topk_score_paged(
        pool, jnp.asarray(f["pt"]), jnp.asarray(f["nv"]), jnp.asarray(f["off"]),
        jnp.int32(lo), jnp.int32(hi), jnp.asarray(f["Q"]), k=k, tail=tail,
        carry=carry, finalize=finalize, interpret=True, **opt)


def _dev(v):
    return torch.tensor(v, dtype=torch.int32)


def _assert_bitwise(a, b, msg):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), msg


def _assert_matches_reference(want, got, msg):
    ws, wi = (np.asarray(x) for x in want)
    gs, gi = (x.numpy() for x in got)
    np.testing.assert_array_equal(gi, wi, err_msg=msg)
    np.testing.assert_allclose(gs, ws, err_msg=msg, **TOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", MODES)
def test_tensor_bounds_equal_host_ints_and_the_reference(mode, k):
    f = _layout(mode, seed=MODES.index(mode))
    for name, (lo, hi) in RANGES.items():
        msg = f"{mode} k={k} {name} [{lo}, {hi})"
        host = _port(f, lo, hi, k)
        _assert_bitwise(_port(f, _dev(lo), _dev(hi), k), host, msg)
        _assert_matches_reference(_jax(f, lo, hi, k), host, msg)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", ("f32", "int8"))
def test_tensor_bounds_carry_chain(mode, k):
    """A range split in two and chained through ``finalize=False`` and the
    carry: each step with tensor bounds is bitwise the host ints' step, the
    un-finalized pad ids included, and the chain equals the reference's."""
    f = _layout(mode, seed=7)
    for lo, mid, hi in ((0, 5, NPAGES), (2, 2, CAP), (4, 9, 9)):
        msg = f"{mode} k={k} [{lo}, {mid}) + [{mid}, {hi})"
        first = _port(f, lo, mid, k, finalize=False)
        _assert_bitwise(_port(f, _dev(lo), _dev(mid), k, finalize=False), first, msg)
        j_first = _jax(f, lo, mid, k, finalize=False)
        _assert_matches_reference(j_first, first, msg + " (first)")
        last = _port(f, mid, hi, k, carry=first)
        _assert_bitwise(_port(f, _dev(mid), _dev(hi), k, carry=first), last, msg)
        _assert_matches_reference(_jax(f, mid, hi, k, carry=j_first), last, msg)


def test_empty_tensor_range_gives_the_pads():
    f = _layout("f32")
    s, i = _port(f, _dev(9), _dev(4), 5)
    assert torch.isneginf(s).all() and (i == -1).all()
    s, i = _port(f, _dev(3), _dev(3), 5, finalize=False)
    assert torch.isneginf(s).all()
    assert i.tolist() == [[-(j + 2) for j in range(5)]] * B


def test_tensor_bounds_clamp_to_the_table():
    """Out-of-range tensor bounds act clamped to [0, capacity], as the CUDA
    kernels clamp them."""
    f = _layout("int8", seed=2)
    for lo, hi, want in ((-4, CAP + 9, (0, CAP)), (-2, 5, (0, 5)), (CAP + 1, CAP + 3, (CAP, CAP))):
        _assert_bitwise(_port(f, _dev(lo), _dev(hi), 6), _port(f, *want, 6), (lo, hi))


def test_ops_dispatch_takes_tensor_bounds_on_the_cpu():
    f = _layout("f32", seed=4)
    lo, hi = RANGES["inner"]
    _assert_bitwise(_port(f, _dev(lo), _dev(hi), 3, fn=ops.topk_score_paged),
                    _port(f, lo, hi, 3), "ops on the CPU")


@pytest.mark.parametrize("lo, hi, match", [
    (torch.tensor(0, dtype=torch.int32), 5, "must both be host ints"),
    (0, torch.tensor(5, dtype=torch.int32), "must both be host ints"),
    (torch.tensor(0), torch.tensor(5), "0-d int32"),
    (torch.tensor([0], dtype=torch.int32), torch.tensor([5], dtype=torch.int32), "0-d int32"),
    (torch.tensor(0, dtype=torch.int32, device="meta"),
     torch.tensor(5, dtype=torch.int32, device="meta"), "tensor on cpu|all be on the CPU"),
    (0.0, 5.0, "must be an int"),
])
def test_wrong_bounds_raise(lo, hi, match):
    f = _layout("f32")
    for fn in (topk_score_paged_ref, ops.topk_score_paged):
        with pytest.raises(ValueError, match=match):
            _port(f, lo, hi, 3, fn=fn)
