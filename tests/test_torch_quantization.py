"""Int8 quantisation: the port's bytes equal ``repro``'s exactly, including
inputs that sit exactly half way between two int8 levels."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro_torch.core import quantization as tq


@pytest.mark.parametrize("n,m,seed", [(1, 3, 0), (257, 64, 1), (1000, 48, 2)])
@pytest.mark.parametrize("block_rows", [1 << 20, 100])
def test_int8_bytes_equal_reference(n, m, seed, block_rows):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, m)) * rng.uniform(0.01, 10, m)).astype(np.float32)
    q1, s1 = jq.quantize_int8_per_dim(jnp.asarray(X))
    q2, s2 = tq.quantize_int8_per_dim(torch.from_numpy(X), block_rows=block_rows)
    assert q2.dtype == torch.int8
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(q1))


def test_int8_half_way_inputs_round_to_even_like_reference():
    """x = (j + 0.5) * scale for every level j: the divide lands on .5 (or
    within an ULP of it) and both packages must round it the same way."""
    m = 8
    scale = np.float32(0.25)                   # exact in binary: x / scale exact
    j = np.arange(-127, 127, dtype=np.float32)
    X = np.repeat(((j + 0.5) * scale)[:, None], m, axis=1).astype(np.float32)
    X[0, :] = 127 * scale                      # pins the absmax, so scale = 0.25
    q1, s1 = jq.quantize_int8_per_dim(jnp.asarray(X))
    q2, s2 = tq.quantize_int8_per_dim(torch.from_numpy(X))
    assert float(s2[0]) == 0.25
    np.testing.assert_array_equal(q2.numpy(), np.asarray(q1))
    half = q2.numpy()[1:, 0].astype(np.int32)  # rows (j + 0.5), j >= -126
    assert (half % 2 == 0).all()               # half to even
    # irregular scales: whatever the f32 divide gives, both agree
    rng = np.random.default_rng(4)
    s = np.abs(rng.standard_normal(m)).astype(np.float32) + 0.1
    Y = ((rng.integers(-127, 127, (300, m)) + 0.5) * s).astype(np.float32)
    np.testing.assert_array_equal(
        tq.quantize_int8_per_dim(torch.from_numpy(Y))[0].numpy(),
        np.asarray(jq.quantize_int8_per_dim(jnp.asarray(Y))[0]))
    np.testing.assert_array_equal(tq.quantize_with_scale(Y, s),
                                  jq.quantize_with_scale(Y, s))


def test_host_helpers_equal_reference():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((64, 16)).astype(np.float32)
    np.testing.assert_array_equal(tq.scale_for(X), jq.scale_for(X))
    s = tq.scale_for(X)
    np.testing.assert_array_equal(tq.quantize_with_scale(X, s),
                                  jq.quantize_with_scale(X, s))


def test_dequantize_equals_reference():
    rng = np.random.default_rng(6)
    X = rng.standard_normal((100, 12)).astype(np.float32)
    q, s = tq.quantize_int8_per_dim(torch.from_numpy(X))
    got = tq.dequantize_int8(q, s).numpy()
    want = np.asarray(jq.dequantize_int8(jnp.asarray(q.numpy()),
                                         jnp.asarray(s.numpy())))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - X).max() <= s.numpy().max() / 2 + 1e-7


@pytest.mark.parametrize("scale_spread", [1.0, 100.0])
def test_quantization_error_equals_reference(scale_spread):
    rng = np.random.default_rng(7)
    X = (rng.standard_normal((500, 48))
         * rng.uniform(1.0, scale_spread, 48)).astype(np.float32)
    got = float(tq.quantization_error(torch.from_numpy(X)))
    want = float(jq.quantization_error(jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert 0.0 < got < 0.01
