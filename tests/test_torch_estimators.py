"""repro_torch.core.{estimators, pca, kmeans} against the JAX reference on the
CPU, on the same sketch: moments within 1e-5, PCA eigenpairs (eigenvectors up
to sign), the sparse distances and the K-means++ seeding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as jest
from repro.core import kmeans as jkm
from repro.core import pca as jpca
from repro.core import sketch as jsketch
from repro.data.pipeline import VectorStreamSource as JSource
from repro_torch.core import estimators, kmeans, pca, sketch
from repro_torch.data.pipeline import VectorStreamSource

KEY = jax.random.PRNGKey(9)
P, N, GAMMA = 200, 96, 0.25


@pytest.fixture
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("repro_torch implements jax_threefry_partitionable=True only")


def _kd(key):
    return np.asarray(jax.random.key_data(key))


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _sketches(step):
    """One batch sketched by both packages (identical masks, values to 1e-5)."""
    x = VectorStreamSource(p=P, batch=N, seed=1).batch_at(step)
    spec = sketch.make_spec(P, _kd(KEY), gamma=GAMMA)
    spec_j = jsketch.make_spec(P, KEY, gamma=GAMMA)
    s = sketch.sketch(torch.from_numpy(x), spec, batch_key=sketch.batch_key(spec, step, 0))
    s_j = jsketch.sketch(jnp.asarray(x), spec_j,
                         batch_key=jsketch.batch_key(spec_j, jnp.int32(step), 0))
    np.testing.assert_array_equal(s.indices.numpy(), np.asarray(s_j.indices))
    return spec, spec_j, s, s_j


def test_source_bytes_match():
    a = VectorStreamSource(p=64, batch=5, seed=3)
    b = JSource(p=64, batch=5, seed=3)
    np.testing.assert_array_equal(a._u, b._u)
    for step, shard, seed in [(0, 0, None), (4, 2, None), (1, 0, 7)]:
        np.testing.assert_array_equal(a.batch_at(step, shard, seed=seed),
                                      b.batch_at(step, shard, seed=seed))


def test_mean_and_cov_estimators(partitionable):
    _, _, s, s_j = _sketches(0)
    _close(estimators.mean_estimator(s), jest.mean_estimator(s_j))
    for path in ("dense", "compact"):
        _close(estimators.cov_estimator(s, path=path), jest.cov_estimator(s_j, path=path))
    with pytest.raises(ValueError):
        estimators.cov_estimator(s, path="lowrank")


@pytest.mark.parametrize("chunk_terms", [1 << 25, 1000])
def test_compact_routes_match_the_scatter_add(partitionable, monkeypatch, chunk_terms):
    """The card's two compact routes, run on the CPU through the plain
    segment sums: the sum by key in one chunk is the reference's n·m²
    scatter-add bit for bit (each key's products added in row order), in
    chunks of fewer products within 1e-6 of its largest entry; the chunked
    products within 1e-5; both within 1e-5 of the JAX compact path."""
    _, _, s, s_j = _sketches(1)
    monkeypatch.setattr(estimators, "KEYED_CHUNK_TERMS", chunk_terms)
    monkeypatch.setattr(estimators, "OUTER_CHUNK_FLOATS", 20 * s.p)
    plain = estimators._scatter_outer_plain(s.values, s.indices, s.p)
    keyed = estimators._outer_by_keys(s.values, s.indices, s.p)
    top = plain.abs().max().item()
    if chunk_terms > s.n * s.values.shape[1] ** 2:
        assert torch.equal(keyed, plain)
    else:
        assert (keyed - plain).abs().max().item() <= 1e-6 * top
    prods = estimators._outer_by_products(s.values, s.indices, s.p)
    assert (prods - plain).abs().max().item() <= 1e-5 * top
    ref = np.asarray(jest._scatter_outer(s_j.values, s_j.indices, s_j.p))
    for got in (keyed, prods):
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * top


def test_stream_fold_and_pca(partitionable):
    state = estimators.stream_init(256)  # p_pad of P = 200
    state_j = jest.stream_init(256)
    for step in range(3):
        spec, spec_j, s, s_j = _sketches(step)
        state = estimators.stream_update(state, s)
        state_j = jest.stream_update(state_j, s_j)
    assert int(state.count) == int(state_j.count) == 3 * N
    assert state.count.dtype == torch.int32
    _close(estimators.stream_finalize_mean(state, spec.m),
           jest.stream_finalize_mean(state_j, spec_j.m))
    _close(estimators.stream_finalize_cov(state, spec.m),
           jest.stream_finalize_cov(state_j, spec_j.m))
    res = pca.pca_from_stream(state, spec, k=4)
    res_j = jpca.pca_from_stream(state_j, spec_j, k=4)
    _close(res.eigenvalues, res_j.eigenvalues)
    _close(res.mean, res_j.mean)
    comps, comps_j = res.components.numpy(), np.asarray(res_j.components)
    assert comps.shape == comps_j.shape == (4, P)
    signs = np.sign(np.sum(comps * comps_j, axis=1, keepdims=True))
    _close(comps * signs, comps_j, tol=1e-4)


def test_sparsified_pca_matches(partitionable):
    spec, spec_j, s, s_j = _sketches(1)
    res = pca.sparsified_pca(s, spec, k=3)
    res_j = jpca.sparsified_pca(s_j, spec_j, k=3)
    _close(res.eigenvalues, res_j.eigenvalues, tol=1e-4)
    x = VectorStreamSource(p=P, batch=N, seed=1).batch_at(1)
    _close(pca.explained_variance(res.components, torch.from_numpy(x)),
           jpca.explained_variance(res_j.components, jnp.asarray(x)), tol=1e-4)
    dense, dense_j = pca.pca(torch.from_numpy(x), 3), jpca.pca(jnp.asarray(x), 3)
    _close(dense.eigenvalues, dense_j.eigenvalues, tol=1e-4)
    _close(dense.mean, dense_j.mean)


def test_sparse_dists_and_kpp_init(partitionable):
    spec, _, s, s_j = _sketches(2)
    centers = np.random.default_rng(0).normal(size=(5, spec.p_pad)).astype(np.float32)
    _close(kmeans.sparse_sq_dists(s.values, s.indices, torch.from_numpy(centers)),
           jkm.sparse_sq_dists(s_j.values, s_j.indices, jnp.asarray(centers)))
    for seed in range(3):
        k = jax.random.PRNGKey(seed)
        c = kmeans.kpp_init_sparse(_kd(k), s.values, s.indices, spec.p_pad, 6)
        c_j = jkm.kpp_init_sparse(k, s_j.values, s_j.indices, spec.p_pad, 6)
        _close(c, c_j)
