"""repro_torch.utils.prng against jax.random: the same key data, bits, uniforms,
normals, signs, integers, masks, choices, permutations and categorical draws,
bit for bit, in both of JAX's threefry layouts.

Each test runs once a layout: ``jax.threefry_partitionable(flag)`` beside
``prng.threefry_partitionable(flag)``, flag ``False`` (JAX's original layout,
the default of JAX 0.4) and ``True`` (the partitionable one).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as jsampling
from repro.utils import prng as jprng
from repro_torch.core import sampling
from repro_torch.utils import prng
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

SHAPES = [(), (1,), (7,), (3, 1000), (2, 16384), (4, 5, 6)]
SEEDS = [0, 3, 12345, 2**31 - 1]


@pytest.fixture(params=[False, True], ids=["original", "partitionable"])
def layout(request):
    """Both packages draw in the layout of the parameter."""
    with jax.threefry_partitionable(request.param), prng.threefry_partitionable(request.param):
        yield request.param


def _kd(key):
    return np.asarray(jax.random.key_data(key))


def _bits32(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_split(layout, seed):
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
def test_bits_uniform_signs_ints(layout, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(11), len(shape))
    kt = _kd(k)
    np.testing.assert_array_equal(
        prng.random_bits(kt, shape).numpy(),
        np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64))
    u = prng.uniform(kt, shape).numpy()
    np.testing.assert_array_equal(u.view(np.int32), _bits32(jax.random.uniform(k, shape)))
    np.testing.assert_array_equal(prng.rademacher(kt, shape).numpy(),
                                  np.asarray(jprng.rademacher(k, shape)))
    for lo, hi in [(0, 10), (0, 1000), (-5, 70000), (3, 3)]:
        np.testing.assert_array_equal(prng.randint(kt, shape, lo, hi).numpy(),
                                      np.asarray(jax.random.randint(k, shape, lo, hi)))


def _xla_fuses_multiply_add() -> bool:
    """Whether XLA's CPU code on this host rounds a·b + c once (FMA), as
    tests/test_torch_lowrank.py probes it."""
    a = np.full(8, 1 + 2 ** -12, np.float32)
    c = np.full(8, -(1 + 2 ** -11), np.float32)
    return bool(np.asarray(jax.jit(lambda a, c: a * a + c)(a, c))[0] != 0)


def test_normal_choice_permutation(layout):
    """``normal`` bit for bit where XLA's CPU code fuses its multiply-adds
    (elsewhere within 1e-6 relative, as tests/test_torch_lowrank.py holds
    it); ``choice`` on its four paths and ``permutation`` exactly."""
    k = jax.random.PRNGKey(21)
    kt = _kd(k)
    got, want = prng.normal(kt, (5, 999)).numpy(), np.asarray(jax.random.normal(k, (5, 999)))
    if _xla_fuses_multiply_add():
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(prng.permutation(kt, 1000).numpy(),
                                  np.asarray(jax.random.permutation(k, 1000)))
    w = np.random.default_rng(3).random(50).astype(np.float32)
    for replace in (True, False):
        for p in (None, w):
            np.testing.assert_array_equal(
                prng.choice(kt, 50, (20,), replace=replace,
                            p=None if p is None else torch.from_numpy(p)).numpy(),
                np.asarray(jax.random.choice(k, 50, (20,), replace=replace,
                                             p=None if p is None else jnp.asarray(p))))


def test_sample_indices_exact_at_p_2_14(layout):
    """Ties among the 23-bit uniforms are certain at this size; the stable
    sort must order them as lax.top_k does."""
    k = jax.random.PRNGKey(4)
    n, p, m = 8, 1 << 14, 819
    got = sampling.sample_indices(_kd(k), n, p, m).numpy()
    want = np.asarray(jsampling.sample_indices(k, n, p, m))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_sample_indices_exact_at_p_2_24(layout):
    """One row of p = 2^24: the original layout's pairs reach across its
    halves."""
    k = jax.random.PRNGKey(7)
    n, p, m = 1, 1 << 24, 1024
    np.testing.assert_array_equal(sampling.sample_indices(_kd(k), n, p, m).numpy(),
                                  np.asarray(jsampling.sample_indices(k, n, p, m)))


@pytest.mark.parametrize("block", [1 << 14, 3 << 14, 1 << 16])
def test_sample_indices_in_row_blocks(layout, monkeypatch, block):
    """Rows drawn and sorted a block at a time (1, 3 and 4 rows of p = 2^14;
    11 rows leave a ragged last block) equal the one-call draw and the
    reference's, bit for bit: a block is its flat range of the one draw."""
    k = jax.random.PRNGKey(9)
    n, p, m = 11, 1 << 14, 1638
    monkeypatch.setattr(sampling, "SAMPLE_BLOCK", n * p)
    whole = sampling.sample_indices(_kd(k), n, p, m).numpy()
    monkeypatch.setattr(sampling, "SAMPLE_BLOCK", block)
    got = sampling.sample_indices(_kd(k), n, p, m).numpy()
    np.testing.assert_array_equal(got, whole)
    np.testing.assert_array_equal(got, np.asarray(jsampling.sample_indices(k, n, p, m)))
    np.testing.assert_array_equal(
        prng.uniform(_kd(k), (4, p), offset=5 * p, total=n * p).numpy(),
        prng.uniform(_kd(k), (n, p)).numpy()[5:9])


def test_original_layout_in_pieces_and_blocks(monkeypatch):
    """The original layout's parts: every range of an odd draw (its pad word
    0 in the last pair) equals the one-call draw; past ``_BLOCK`` words (made
    7 here) the draw is JAX's split into blocks, each key's own draw."""
    k = jax.random.PRNGKey(5)
    with jax.threefry_partitionable(False), prng.threefry_partitionable(False):
        whole = prng.random_bits(_kd(k), (21,)).numpy()
        np.testing.assert_array_equal(
            whole, np.asarray(jax.random.bits(k, (21,), jnp.uint32)).astype(np.int64))
        for s in range(21):
            for e in range(s + 1, 22):
                u = prng.uniform(_kd(k), (e - s,), offset=s, total=21).numpy()
                np.testing.assert_array_equal(u, prng.uniform(_kd(k), (21,)).numpy()[s:e])
        monkeypatch.setattr(prng, "_BLOCK", 7)
        for total in (6, 7, 14, 20, 21):
            nb, rem = divmod(total, 7)
            keys = list(jax.random.split(k, nb + 1)) if nb else [k]
            want = np.concatenate([np.asarray(jax.random.bits(kk, (7 if i < nb else rem,),
                                                              jnp.uint32))
                                   for i, kk in enumerate(keys)]).astype(np.int64)
            np.testing.assert_array_equal(prng.random_bits(_kd(k), (total,)).numpy(), want)
            part = prng.uniform(_kd(k), (total - 3,), offset=2, total=total).numpy()
            np.testing.assert_array_equal(part, prng.uniform(_kd(k), (total,)).numpy()[2:-1])


def test_layout_switch():
    """The context manager switches every draw's layout and restores the one
    it found, also when its block raises."""
    k = prng.PRNGKey(1)
    before = prng.split(k, 3)
    np.testing.assert_array_equal(before, _kd(jax.random.split(jax.random.PRNGKey(1), 3)))
    with pytest.raises(KeyError):
        with prng.threefry_partitionable(not jax.config.jax_threefry_partitionable):
            assert not np.array_equal(prng.split(k, 3), before)
            raise KeyError
    np.testing.assert_array_equal(prng.split(k, 3), before)


@pytest.mark.parametrize("flag", ["0", "1"])
def test_layout_from_the_environment(flag):
    """A process started with REPRO_TORCH_THREEFRY_PARTITIONABLE=0 (1) draws in
    the original (partitionable) layout, as a launcher's children must."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    code = ("from repro_torch.utils import prng; "
            "print(prng.split(prng.PRNGKey(1), 3).ravel().tolist())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=src,
                                  REPRO_TORCH_THREEFRY_PARTITIONABLE=flag))
    assert out.returncode == 0, out.stderr[-2000:]
    with jax.threefry_partitionable(flag == "1"):
        want = _kd(jax.random.split(jax.random.PRNGKey(1), 3)).ravel().tolist()
    assert out.stdout.strip() == str(want)


@pytest.mark.parametrize("seed", range(5))
def test_categorical_exact(layout, seed):
    k = jax.random.PRNGKey(seed)
    logits = jnp.log(jnp.asarray(np.random.default_rng(seed).random(64), jnp.float32) + 1e-3)
    want = np.asarray(jax.random.categorical(k, logits, shape=(5,)))
    got = prng.categorical(_kd(k), torch.from_numpy(np.array(logits)), shape=(5,)).numpy()
    np.testing.assert_array_equal(got, want)
