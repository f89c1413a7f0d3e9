"""repro_torch.core.{ros, sampling, sketch} against the JAX reference on the CPU:
the same transform, the same signs and masks from the same key, and the same
sketch (identical indices, values within 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ros as jros
from repro.core import sampling as jsampling
from repro.core import sketch as jsketch
from repro.kernels import ref as jref
from repro_torch.core import ros, sampling, sketch
from repro_torch.kernels import ops
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

KEY = jax.random.PRNGKey(5)



def _kd(key):
    return np.asarray(jax.random.key_data(key))


def _x(n, p, seed=0):
    return np.random.default_rng(seed).normal(size=(n, p)).astype(np.float32)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("p", [1, 2, 16, 1024])
def test_fwht_matches(p):
    x = _x(3, p)
    _close(ros.fwht(torch.from_numpy(x)), jax.jit(jros.fwht)(x))


@pytest.mark.parametrize("transform,p", [("hadamard", 16), ("hadamard", 1000),
                                         ("dct", 16), ("dct", 1000)])
def test_precondition_and_unmix_match(transform, p):
    x = _x(4, p, seed=p)
    y = ros.precondition(torch.from_numpy(x), _kd(KEY), transform)
    yj = jros.precondition(jnp.asarray(x), KEY, transform)
    assert y.shape == (4, ros.pad_len(p, transform))
    _close(y, yj)
    back = ros.unmix(y, _kd(KEY), transform, p_orig=p)
    _close(back, jros.unmix(yj, KEY, transform, p_orig=p))
    _close(back, x, tol=1e-4)


def test_pad_len_and_signs():
    for p in [1, 2, 3, 1000, 1024, 1025]:
        assert ros.pad_len(p) == jros.pad_len(p)
        assert ros.pad_len(p, "dct") == p
    np.testing.assert_array_equal(ros.signs_for(_kd(KEY), 1024).numpy(),
                                  np.asarray(jros.signs_for(KEY, 1024)))
    np.testing.assert_array_equal(ros.hadamard_matrix(8).numpy(),
                                  np.asarray(jros.hadamard_matrix(8)))


@pytest.mark.parametrize("transform,p,gamma", [("hadamard", 1000, 0.1),
                                               ("hadamard", 256, 0.25),
                                               ("dct", 300, 0.1)])
def test_sketch_matches(transform, p, gamma):
    spec_j = jsketch.make_spec(p, KEY, gamma=gamma, transform=transform)
    spec = sketch.make_spec(p, _kd(KEY), gamma=gamma, transform=transform)
    assert (spec.m, spec.p_pad, spec.gamma) == (spec_j.m, spec_j.p_pad, spec_j.gamma)
    assert sketch.compression_ratio(spec) == jsketch.compression_ratio(spec_j)
    x = _x(16, p, seed=1)
    for step, shard in [(0, 0), (3, 1)]:
        bk = sketch.batch_key(spec, step, shard)
        bk_j = jsketch.batch_key(spec_j, jnp.int32(step), shard)
        np.testing.assert_array_equal(bk, _kd(bk_j))
        s = sketch.sketch(torch.from_numpy(x), spec, batch_key=bk)
        s_j = jsketch.sketch(jnp.asarray(x), spec_j, batch_key=bk_j)
        assert s.p == s_j.p
        np.testing.assert_array_equal(s.indices.numpy(), np.asarray(s_j.indices))
        _close(s.values, s_j.values)
        np.testing.assert_array_equal(
            sampling.counts_per_coordinate(s.indices, s.p).numpy(),
            np.asarray(jsampling.counts_per_coordinate(s_j.indices, s_j.p)))
        _close(s.to_dense(), s_j.to_dense())


def test_make_spec_validation():
    with pytest.raises(ValueError):
        sketch.make_spec(100, _kd(KEY))
    with pytest.raises(ValueError):
        sketch.make_spec(100, _kd(KEY), gamma=1.5)
    with pytest.raises(ValueError):
        sketch.make_spec(100, _kd(KEY), m=200)
    assert sketch.make_spec(100, _kd(KEY), gamma=1.0).m == 128


def test_subsample_and_gather_match():
    y = _x(6, 64, seed=2)
    s = sampling.subsample(torch.from_numpy(y), _kd(KEY), 9)
    s_j = jsampling.subsample(jnp.asarray(y), KEY, 9)
    np.testing.assert_array_equal(s.indices.numpy(), np.asarray(s_j.indices))
    np.testing.assert_array_equal(s.values.numpy(), np.asarray(s_j.values))
    v = _x(1, 64, seed=3)[0]
    np.testing.assert_array_equal(
        sampling.row_sampled_gather(torch.from_numpy(v), s.indices).numpy(),
        np.asarray(jsampling.row_sampled_gather(jnp.asarray(v), s_j.indices)))


@pytest.mark.parametrize("p", [40000, 1 << 17])
def test_sketch_above_the_single_row_ceiling_matches(p):
    """Past p_pad = 2^15, on the CPU (the plain path of the cluster sketch):
    the sketch and ops.sketch_fused against the reference's plain
    composition, p_pad = 2^16 (40000 padded) and 2^17; identical indices,
    values within 1e-5. The card's kernel meets this reference through its
    bit-equality with the port's plain version (tests/test_torch_kernels_cuda.py)."""
    spec_j = jsketch.make_spec(p, KEY, gamma=0.05)
    spec = sketch.make_spec(p, _kd(KEY), gamma=0.05)
    assert spec.p_pad == spec_j.p_pad > 1 << 15
    x = _x(3, p, seed=p)
    bk_j = jsketch.batch_key(spec_j, jnp.int32(2), 0)
    s = sketch.sketch(torch.from_numpy(x), spec, batch_key=_kd(bk_j))
    s_j = jsketch.sketch(jnp.asarray(x), spec_j, batch_key=bk_j)
    np.testing.assert_array_equal(s.indices.numpy(), np.asarray(s_j.indices))
    _close(s.values, s_j.values)
    xp = np.pad(x, [(0, 0), (0, spec.p_pad - p)])
    d = ros.signs_for(spec.signs_key(), spec.p_pad)
    idx = s.indices
    got = ops.sketch_fused(torch.from_numpy(xp), d, idx)
    _close(got, jref.ref_sketch_fused(jnp.asarray(xp), jnp.asarray(d.numpy()), jnp.asarray(idx.numpy())))
    np.testing.assert_array_equal(got.numpy(), s.values.numpy())
