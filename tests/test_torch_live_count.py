"""The top-k's live count as a 0-d tensor: the plain version and the delta
search take it without a host read, equal to the host-int path at every
count (clamped outside [0, n]), and to the reference's ``_delta_topk``, which
traces the count as an operand.

Tolerances: scores at rtol = atol = 1e-5 against the reference (the port's
contract), ids equal; tensor against int count bitwise (the same code reads
the count either way).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import _delta_topk as ref_delta_topk
from repro_torch.core.index import _delta_topk
from repro_torch.kernels import ops
from repro_torch.kernels.topk_score import topk_score_plain

N, M, B, K = 300, 24, 4, 10
COUNTS = (0, 1, 137, N - 1, N, N + 5, -3)


def _inputs(seed, int8):
    rng = np.random.default_rng(seed)
    if int8:
        D = rng.integers(-127, 128, size=(N, M)).astype(np.int8)
        scale = (rng.random(M) * 0.05 + 0.01).astype(np.float32)
    else:
        D = rng.standard_normal((N, M)).astype(np.float32)
        scale = None
    Q = rng.standard_normal((B, M)).astype(np.float32)
    return D, scale, Q


@pytest.mark.parametrize("n_valid", COUNTS)
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_plain_tensor_count_equals_int_count(n_valid, int8):
    D, scale, Q = _inputs(0, int8)
    q = torch.from_numpy(Q if scale is None else Q * scale[None, :])
    Dt = torch.from_numpy(D)
    want = topk_score_plain(Dt, q, k=K, n_valid=n_valid)
    got = topk_score_plain(Dt, q, k=K, n_valid=torch.tensor(n_valid, dtype=torch.int32))
    via_ops = ops.topk_score(Dt, q, k=K, n_valid=torch.tensor(n_valid, dtype=torch.int32))
    clamped = topk_score_plain(Dt, q, k=K, n_valid=max(0, min(n_valid, N)))
    for s, i in (got, via_ops, clamped):
        assert torch.equal(s, want[0]) and torch.equal(i, want[1])
    live = max(0, min(n_valid, N))
    assert bool((want[1] < live).all())
    assert int((want[1] >= 0).sum(1).min()) == min(K, live)


@pytest.mark.parametrize("n_valid", [0, 1, 137, N - 1, N])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_delta_topk_tensor_count_equals_the_reference(n_valid, int8):
    D, scale, Q = _inputs(1, int8)
    offset = 1000
    ws, wi = ref_delta_topk(jnp.asarray(D), None if scale is None else jnp.asarray(scale),
                            jnp.asarray(Q), jnp.int32(n_valid), jnp.int32(offset), K)
    ts = None if scale is None else torch.from_numpy(scale)
    gs, gi = _delta_topk(torch.from_numpy(D), ts, torch.from_numpy(Q),
                         torch.tensor(n_valid, dtype=torch.int32), offset, K)
    hs, hi = _delta_topk(torch.from_numpy(D), ts, torch.from_numpy(Q), n_valid, offset, K)
    assert torch.equal(gs, hs) and torch.equal(gi, hi)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-5)


def test_delta_topk_runs_on_meta_without_a_host_read():
    """On meta tensors (the dry run's counting) the delta search takes the
    count as a tensor: no ``aten._local_scalar_dense``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    D = torch.empty((256, M), dtype=torch.int8, device="meta")
    with Ops():
        s, i = _delta_topk(D, torch.empty((M,), device="meta"),
                           torch.empty((1, M), device="meta"),
                           torch.empty((), dtype=torch.int32, device="meta"), 4096, K)
    assert s.shape == (1, K) and i.shape == (1, K) and i.device.type == "meta"
    assert seen and not any("_local_scalar_dense" in op for op in seen)


def test_tensor_count_must_sit_with_the_operands():
    D, _, Q = _inputs(2, False)
    with pytest.raises(ValueError, match="CPU or all on a CUDA"):
        ops.topk_score(torch.from_numpy(D), torch.from_numpy(Q), k=K,
                       n_valid=torch.empty((), dtype=torch.int32, device="meta"))
    s, i = topk_score_plain(torch.empty((50, M), device="meta"),
                            torch.empty((2, M), device="meta"), k=K,
                            n_valid=torch.empty((), dtype=torch.int32, device="meta"))
    assert s.shape == i.shape == (2, K) and s.device.type == "meta"
