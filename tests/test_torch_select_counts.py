"""The large-k select with a live count a row: ``topk_select_plain`` with
``counts`` against the plain select over each row cut to its count, and
against ``jax.lax.top_k`` over the same numpy scores with the dead slots
masked. The chunk kernel's list mode hands the select one count a segment,
so a row's live keys are a prefix of its slots; counts outside [0, L] are
clamped, as the kernels clamp them.

Tolerances: none. The plain select decodes scores from the keys, so scores
and ids are compared exactly; ties go to the lowest id (``jax.lax.top_k``
puts the lower index first, and the ids here are the column indices where
JAX is the yardstick).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.topk_score import _SIGN, topk_select_plain

L = 400
COUNTS = (0, 1, 20, 150, L, L + 100, -5)      # 0, < k, = L, past L and below 0 clamp
KS = (33, 100, 300)


def _scores(case: str, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(B, L) f32 scores and int32 ids: ``ties`` (a few distinct values,
    ids the column), ``pads`` (-inf slots among them), ``dups`` (equal
    (score, id) copies, as repeated row_ids give)."""
    rng = np.random.default_rng(seed)
    B = len(COUNTS)
    ids = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    if case == "ties":
        s = rng.integers(-3, 4, size=(B, L)).astype(np.float32) / 4
    elif case == "pads":
        s = rng.standard_normal((B, L)).astype(np.float32)
        s[rng.random((B, L)) < 0.3] = -np.inf
    else:
        s = rng.integers(-2, 3, size=(B, L)).astype(np.float32)
        ids = rng.integers(0, 40, size=(B, L)).astype(np.int32)
    return s, ids


def _keys(s: np.ndarray, ids: np.ndarray) -> torch.Tensor:
    return (ref._keys(torch.from_numpy(s), torch.from_numpy(ids)) ^ _SIGN).contiguous()


def _pads(k: int, c: int, finalize: bool) -> np.ndarray:
    """The ids of slots past c finite slots: -1, or -(j - c + 2)."""
    j = np.arange(k)
    return np.where(j < c, 0, -1 if finalize else -(j - c + 2))


@pytest.mark.parametrize("finalize", [True, False], ids=["final", "unfinal"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", ["ties", "pads", "dups"])
def test_counts_equal_the_select_over_cut_rows(case, k, finalize):
    s, ids = _scores(case, 1)
    keys = _keys(s, ids)
    counts = torch.tensor(COUNTS, dtype=torch.int32)
    got_s, got_i = topk_select_plain(keys, k, finalize, counts=counts)
    for b, c in enumerate(COUNTS):
        c = min(max(c, 0), L)
        if c == 0:                       # nothing live: every slot a pad
            assert torch.isneginf(got_s[b]).all()
            np.testing.assert_array_equal(got_i[b].numpy(), _pads(k, 0, finalize))
            continue
        want_s, want_i = topk_select_plain(keys[b:b + 1, :c].contiguous(), k, finalize)
        assert torch.equal(got_s[b], want_s[0]), (b, c)
        assert torch.equal(got_i[b], want_i[0]), (b, c)


@pytest.mark.parametrize("finalize", [True, False], ids=["final", "unfinal"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", ["ties", "pads"])
def test_counts_equal_jax_top_k(case, k, finalize):
    s, ids = _scores(case, 2)
    counts = np.clip(np.array(COUNTS), 0, L)
    masked = np.where(np.arange(L)[None, :] < counts[:, None], s, -np.inf).astype(np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(masked), min(k, L))
    vals, idx = np.asarray(vals), np.asarray(idx)
    want_s = np.full((len(COUNTS), k), -np.inf, dtype=np.float32)
    want_s[:, :vals.shape[1]] = vals
    finite = np.isfinite(want_s)
    want_i = np.zeros((len(COUNTS), k), dtype=np.int64)
    want_i[:, :idx.shape[1]] = idx
    for b in range(len(COUNTS)):
        c = int(finite[b].sum())
        want_i[b] = np.where(finite[b], want_i[b], _pads(k, c, finalize))
    got_s, got_i = topk_select_plain(_keys(s, ids), k, finalize,
                                     counts=torch.tensor(COUNTS, dtype=torch.int32))
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("k", KS)
def test_full_counts_equal_no_counts(k):
    s, ids = _scores("pads", 3)
    keys = _keys(s, ids)
    full = torch.full((len(COUNTS),), L, dtype=torch.int32)
    for finalize in (True, False):
        a = topk_select_plain(keys, k, finalize, counts=full)
        b = topk_select_plain(keys, k, finalize)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_counts_past_the_row_clamp_to_the_row():
    s, ids = _scores("ties", 4)
    keys = _keys(s, ids)
    B = len(COUNTS)
    over = topk_select_plain(keys, 100, counts=torch.full((B,), 10 * L, dtype=torch.int32))
    under = topk_select_plain(keys, 100, counts=torch.full((B,), -1, dtype=torch.int32))
    full = topk_select_plain(keys, 100)
    assert torch.equal(over[0], full[0]) and torch.equal(over[1], full[1])
    assert torch.isneginf(under[0]).all() and (under[1] == -1).all()
