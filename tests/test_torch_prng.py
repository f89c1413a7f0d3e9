"""repro_torch.utils.prng against jax.random: the same key data, bits, uniforms,
signs, integers, masks and categorical draws, bit for bit.

The port implements the partitionable threefry layout only, so every test
skips (with its reason) when JAX runs the other layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as jsampling
from repro.utils import prng as jprng
from repro_torch.core import sampling
from repro_torch.utils import prng

SHAPES = [(), (1,), (7,), (3, 1000), (2, 16384), (4, 5, 6)]
SEEDS = [0, 3, 12345, 2**31 - 1]


@pytest.fixture
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("repro_torch implements jax_threefry_partitionable=True only")


def _kd(key):
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_split(partitionable, seed):
    k = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed)
    np.testing.assert_array_equal(kt, _kd(k))
    for data in [0, 1, 7, 2**31 - 1, 2**32 - 1]:
        np.testing.assert_array_equal(prng.fold_in(kt, data), _kd(jax.random.fold_in(k, data)))
    for tag in ["ros-signs", "sample-mask", "stream-kmeans"]:
        np.testing.assert_array_equal(prng.fold_in_str(kt, tag), _kd(jprng.fold_in_str(k, tag)))
    np.testing.assert_array_equal(prng.key_for_step(kt, 5), _kd(jprng.key_for_step(k, 5)))
    for num in [1, 2, 3, 8]:
        np.testing.assert_array_equal(prng.split(kt, num), _kd(jax.random.split(k, num)))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_signs_ints(partitionable, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(11), len(shape))
    kt = _kd(k)
    np.testing.assert_array_equal(
        prng.random_bits(kt, shape).numpy(),
        np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64))
    u = prng.uniform(kt, shape).numpy()
    np.testing.assert_array_equal(u.view(np.int32),
                                  np.asarray(jax.random.uniform(k, shape)).view(np.int32))
    np.testing.assert_array_equal(prng.rademacher(kt, shape).numpy(),
                                  np.asarray(jprng.rademacher(k, shape)))
    for lo, hi in [(0, 10), (0, 1000), (-5, 70000), (3, 3)]:
        np.testing.assert_array_equal(prng.randint(kt, shape, lo, hi).numpy(),
                                      np.asarray(jax.random.randint(k, shape, lo, hi)))


def test_sample_indices_exact_at_p_2_14(partitionable):
    """Ties among the 23-bit uniforms are certain at this size; the stable
    sort must order them as lax.top_k does."""
    k = jax.random.PRNGKey(4)
    n, p, m = 8, 1 << 14, 819
    got = sampling.sample_indices(_kd(k), n, p, m).numpy()
    want = np.asarray(jsampling.sample_indices(k, n, p, m))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", [1 << 14, 3 << 14, 1 << 16])
def test_sample_indices_in_row_blocks(partitionable, monkeypatch, block):
    """Rows drawn and sorted a block at a time (1, 3 and 4 rows of p = 2^14;
    11 rows leave a ragged last block) equal the one-call draw and the
    reference's, bit for bit: the uniforms are numbered by flat index."""
    k = jax.random.PRNGKey(9)
    n, p, m = 11, 1 << 14, 1638
    monkeypatch.setattr(sampling, "SAMPLE_BLOCK", n * p)
    whole = sampling.sample_indices(_kd(k), n, p, m).numpy()
    monkeypatch.setattr(sampling, "SAMPLE_BLOCK", block)
    got = sampling.sample_indices(_kd(k), n, p, m).numpy()
    np.testing.assert_array_equal(got, whole)
    np.testing.assert_array_equal(got, np.asarray(jsampling.sample_indices(k, n, p, m)))
    np.testing.assert_array_equal(
        prng.uniform(_kd(k), (4, p), offset=5 * p).numpy(),
        prng.uniform(_kd(k), (n, p)).numpy()[5:9])


@pytest.mark.parametrize("seed", range(5))
def test_categorical_exact(partitionable, seed):
    k = jax.random.PRNGKey(seed)
    logits = jnp.log(jnp.asarray(np.random.default_rng(seed).random(64), jnp.float32) + 1e-3)
    want = np.asarray(jax.random.categorical(k, logits, shape=(5,)))
    got = prng.categorical(_kd(k), torch.from_numpy(np.array(logits)), shape=(5,)).numpy()
    np.testing.assert_array_equal(got, want)
