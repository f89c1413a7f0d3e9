"""repro_torch.core.kmeans against repro.core.kmeans on the CPU: the same numpy
rows and the same key go into both.

Tolerances: labels, iteration counts and K-means++ picks are equal; centers
and distances agree to 1e-5 (the reference's jitted sums and PyTorch's take
other orders, a few float32 ulps), objectives to 1e-5 relative. The center
update's plain version (a scatter-add in row order) equals the reference's
scatter-add bit for bit, and so does K6's function on the labels' one-hot
columns, which the card runs in its place. The cases of tests/test_kmeans.py
that the port covers (all but the feature-extraction and feature-selection
baselines, which are not ported) rerun as parity tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core import sketch as jsketch
from repro_torch.core import kmeans as km
from repro_torch.core import sketch
from repro_torch.kernels import ops, ref, spmm
from repro_torch.utils import prng


@pytest.fixture
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("repro_torch implements jax_threefry_partitionable=True only")


def _blobs(n, p, k, seed=0, sep=3.0, noise=0.5):
    """Well-separated Gaussian blobs from numpy: (X, labels, centers)."""
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, p)) * sep).astype(np.float32)
    labels = rng.integers(0, k, n)
    x = (centers[labels] + noise * rng.normal(size=(n, p))).astype(np.float32)
    return x, labels, centers


@pytest.fixture(scope="module")
def blobs():
    return _blobs(1500, 128, 5)


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _center_err(c, true):
    from scipy.optimize import linear_sum_assignment

    d = np.linalg.norm(np.asarray(c)[:, None, :] - np.asarray(true)[None, :, :], axis=-1)
    ri, ci = linear_sum_assignment(d)
    return float(d[ri, ci].mean())


def _sketches(x, seed, gamma=0.25):
    """The same sketch in both packages (masks equal, values to 1e-5)."""
    jkey, tkey = _keys(seed)
    spec_j = jsketch.make_spec(x.shape[1], jkey, gamma=gamma)
    spec = sketch.make_spec(x.shape[1], tkey, gamma=gamma)
    s_j = jsketch.sketch(jnp.asarray(x), spec_j)
    s = sketch.sketch(torch.from_numpy(x), spec)
    np.testing.assert_array_equal(s.indices.numpy(), np.asarray(s_j.indices))
    return spec, s, s_j


def test_dense_distances_and_kpp_init(partitionable):
    x, _, _ = _blobs(300, 32, 4, seed=1)
    c = x[:4]
    # the expanded form ‖x‖² − 2x·c + ‖c‖² cancels: its error is ulps of ‖x‖²,
    # so the tolerance is 1e-5 of the largest distance
    want = np.asarray(jkm.dense_sq_dists(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_allclose(km.dense_sq_dists(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
                               want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    for seed in range(3):
        jkey, tkey = _keys(seed)
        np.testing.assert_array_equal(km.kpp_init_dense(tkey, torch.from_numpy(x), 4).numpy(),
                                      np.asarray(jkm.kpp_init_dense(jkey, jnp.asarray(x), 4)))


def test_lloyd_dense_and_sparse_from_one_start(partitionable):
    """Both Lloyd loops from the same start: labels, iterations and centers."""
    x, _, _ = _blobs(600, 64, 4, seed=2)
    mu0 = x[[0, 150, 300, 450]]
    mu, a, obj, it = km._lloyd_dense(torch.from_numpy(x), torch.from_numpy(mu0), 50, 1e-6)
    mu_j, a_j, obj_j, it_j = jkm._lloyd_dense(jnp.asarray(x), jnp.asarray(mu0), 50, 1e-6)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    assert int(it) == int(it_j) > 1
    _close(mu, mu_j)
    _close(obj, obj_j)

    spec, s, s_j = _sketches(x, seed=3)
    mu0 = torch.zeros((4, spec.p_pad)).scatter_(1, s.indices[[0, 150, 300, 450]].long(),
                                                  s.values[[0, 150, 300, 450]])
    want = jkm._lloyd_sparse(s_j.values, s_j.indices, spec.p_pad, jnp.asarray(mu0.numpy()),
                             50, 1e-6)
    for assign_fn in (None, ops.kernel_assign_fn("ref"), ops.kernel_assign_fn("auto")):
        mu, a, obj, it = km._lloyd_sparse(s.values, s.indices, spec.p_pad, mu0, 50, 1e-6,
                                          assign_fn=assign_fn)
        np.testing.assert_array_equal(a.numpy(), np.asarray(want[1]))
        assert int(it) == int(want[3])
        _close(mu, want[0])
        _close(obj, want[2])


def test_kernel_assign_fn_is_the_gather_distance():
    x, _, _ = _blobs(200, 64, 3, seed=4)
    spec, s, _ = _sketches(x, seed=5)
    centers = torch.from_numpy(np.random.default_rng(0).normal(size=(3, spec.p_pad))
                               .astype(np.float32))
    want = km.sparse_sq_dists(s.values, s.indices, centers)
    for mode in ("ref", "auto"):
        _close(ops.kernel_assign_fn(mode)(s.values, s.indices, centers), want, tol=1e-6)


def test_center_update_equals_the_scatter_add():
    """The update's plain version is the reference's scatter-add bit for bit;
    so are what the card runs: K6's function on the one-hot columns (over the
    rows' transposition) for the sums, the integer histogram for the counts."""
    x, _, _ = _blobs(400, 64, 5, seed=6)
    spec, s, _ = _sketches(x, seed=7)
    labels = torch.from_numpy(np.random.default_rng(1).integers(0, 5, 400).astype(np.int32))
    k, p = 5, spec.p_pad
    rows = jnp.broadcast_to(jnp.asarray(labels.numpy())[:, None], s.indices.shape)
    idx = jnp.asarray(s.indices.numpy())
    want_sums = jnp.zeros((k, p), jnp.float32).at[rows, idx].add(jnp.asarray(s.values.numpy()))
    want_counts = jnp.zeros((k, p), jnp.float32).at[rows, idx].add(1.0)
    onehot = torch.nn.functional.one_hot(labels.long(), k).float()
    pairs, starts = spmm.transpose_columns(s.values, s.indices, p)
    for sums, counts in [ops.cluster_sums(s.values, s.indices, labels, k, p, mode="ref"),
                         ops.cluster_sums(s.values, s.indices, labels, k, p),
                         (ref.ref_spmm_t(s.values, s.indices, onehot, p).T,
                          ref.ref_spmm_t(torch.ones_like(s.values), s.indices, onehot, p).T),
                         (spmm.spmm_t_columns(pairs, starts, onehot, p).T,
                          spmm.cluster_counts(s.indices, labels, k, p))]:
        np.testing.assert_array_equal(sums.numpy(), np.asarray(want_sums))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert ops.cluster_columns(s.values, s.indices, p) is None     # the CPU needs none


def test_sparse_kmeans_core_best_of_restarts(partitionable):
    x, _, _ = _blobs(800, 64, 4, seed=8)
    spec, s, s_j = _sketches(x, seed=9)
    jkey, tkey = _keys(10)
    mu, a, obj, it = km.sparse_kmeans_core(s.values, s.indices, spec.p_pad, 4, tkey,
                                           n_init=3, max_iter=50)
    mu_j, a_j, obj_j, it_j = jkm.sparse_kmeans_core(s_j.values, s_j.indices, spec.p_pad, 4,
                                                    jkey, n_init=3, max_iter=50)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    assert int(it) == int(it_j)
    _close(mu, mu_j)
    _close(obj, obj_j)


@pytest.mark.parametrize("precondition,two_pass", [(True, False), (False, False), (True, True)])
def test_sparsified_kmeans_matches(partitionable, blobs, precondition, two_pass):
    """Alg. 1 one-pass, its no-ROS ablation and Alg. 2, on test_kmeans.py's
    blobs: the reference's labels, centers and iterations, and its accuracy."""
    x, labels, centers = blobs
    jkey, tkey = _keys(2)
    res = km.sparsified_kmeans(torch.from_numpy(x), 5, tkey, gamma=0.25,
                               precondition=precondition, two_pass=two_pass, n_init=3,
                               max_iter=50)
    res_j = jkm.sparsified_kmeans(jnp.asarray(x), 5, jkey, gamma=0.25,
                                  precondition=precondition, two_pass=two_pass, n_init=3,
                                  max_iter=50)
    np.testing.assert_array_equal(res.assignments.numpy(), np.asarray(res_j.assignments))
    assert res.assignments.dtype == torch.int32
    assert int(res.n_iter) == int(res_j.n_iter)
    _close(res.centers, res_j.centers, tol=1e-4)
    _close(res.centers_pre, res_j.centers_pre)
    _close(res.objective, res_j.objective)
    assert km.clustering_accuracy(res.assignments, labels, 5) > 0.9
    if precondition:
        assert _center_err(res.centers, centers) < 2.0


def test_standard_kmeans_matches(partitionable, blobs):
    x, labels, centers = blobs
    jkey, tkey = _keys(1)
    res = km.kmeans(torch.from_numpy(x), 5, tkey, n_init=3, max_iter=50)
    res_j = jkm.kmeans(jnp.asarray(x), 5, jkey, n_init=3, max_iter=50)
    np.testing.assert_array_equal(res.assignments.numpy(), np.asarray(res_j.assignments))
    assert int(res.n_iter) == int(res_j.n_iter)
    _close(res.centers, res_j.centers)
    _close(res.objective, res_j.objective)
    assert km.clustering_accuracy(res.assignments, labels, 5) > 0.95
    assert _center_err(res.centers, centers) < 1.0


def test_two_pass_improves_centers(partitionable, blobs):
    x, _, centers = blobs
    tkey = prng.PRNGKey(3)
    r1 = km.sparsified_kmeans(torch.from_numpy(x), 5, tkey, gamma=0.15, n_init=3, max_iter=50)
    r2 = km.sparsified_kmeans(torch.from_numpy(x), 5, tkey, gamma=0.15, two_pass=True,
                              n_init=3, max_iter=50)
    assert _center_err(r2.centers, centers) <= _center_err(r1.centers, centers) + 1e-6


def test_empty_cluster_guard(partitionable):
    """K > #distinct points: counts==0 coordinates keep previous centers, no NaNs."""
    x = np.ones((10, 16), np.float32)
    jkey, tkey = _keys(0)
    res = km.kmeans(torch.from_numpy(x), 3, tkey, n_init=1, max_iter=5)
    res_j = jkm.kmeans(jnp.asarray(x), 3, jkey, n_init=1, max_iter=5)
    assert bool(torch.all(torch.isfinite(res.centers)))
    np.testing.assert_array_equal(res.centers.numpy(), np.asarray(res_j.centers))


def test_sparse_distances_match_dense_when_full():
    """γ=1 (m=p): the sparsified metric is the plain Euclidean metric."""
    x, _, _ = _blobs(50, 32, 3, seed=9)
    idx = torch.arange(32, dtype=torch.int32)[None].repeat(50, 1)
    xt = torch.from_numpy(x)
    _close(km.sparse_sq_dists(xt, idx, xt[:3]), km.dense_sq_dists(xt, xt[:3]), tol=1e-3)
    _close(ops.kernel_assign_fn()(xt, idx, xt[:3]), km.dense_sq_dists(xt, xt[:3]), tol=1e-3)


def test_clustering_accuracy_matches():
    rng = np.random.default_rng(11)
    true = rng.integers(0, 4, 300)
    pred = np.where(rng.random(300) < 0.8, (true + 1) % 4, rng.integers(0, 4, 300))
    want = jkm.clustering_accuracy(jnp.asarray(pred), jnp.asarray(true), 4)
    assert km.clustering_accuracy(torch.from_numpy(pred), torch.from_numpy(true), 4) == want
    assert km.clustering_accuracy(pred, true, 4) == want
