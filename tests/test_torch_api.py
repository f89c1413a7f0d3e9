"""repro_torch.api — the estimator front door — against repro.api on the CPU.

Every case of tests/test_api.py without a sharded, scan-compile or
GradCompressor part reruns here with the reference and the port fed the same
numpy rows and the same key: the port's own assertions as the reference test
makes them, and the port's outputs against the reference's. Plus the README's
API example on both backends, a reference state carried into the port, and
the paths that are not ported yet.

Tolerances: means, covariances and centers 1e-5 (the port's sums and the
reference's jitted ones take other orders), eigenvalues 1e-5 relative and
eigenvectors 1e-5 after sign alignment, Lloyd's labels and iteration counts
equal, the minibatch fold's reassignment counts equal.
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import estimators as jest
from repro.data.pipeline import VectorStreamSource as JSource
from repro_torch import api
from repro_torch.api import (
    Plan,
    SparsifiedCov,
    SparsifiedKMeans,
    SparsifiedMean,
    SparsifiedPCA,
    fit_many,
)
from repro_torch.core import estimators, kmeans, pca, sketch
from repro_torch.data.pipeline import VectorStreamSource

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("repro_torch implements jax_threefry_partitionable=True only")


def _kw(kw):
    kw.setdefault("backend", "batch")
    kw.setdefault("gamma", 0.25)
    kw.setdefault("batch_size", 200)
    return kw


def _plan(**kw):
    return Plan(**_kw(kw))


def _jplan(**kw):
    return japi.Plan(**_kw(kw))


def _lowrank(n=1200, p=64, k=4, seed=0):
    """A well-separated spectrum, so eigenvectors are stable across sum orders."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(p, k)))
    lam = np.asarray([9.0, 6.0, 4.0, 2.5])
    z = rng.normal(size=(n, k)) * lam
    return (z @ u.T + 0.05 * rng.normal(size=(n, p))).astype(np.float32)


def _clusters(n, p, k, seed=0, sep=3.0, noise=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, p)) * sep
    labels = rng.integers(0, k, n)
    return (centers[labels] + noise * rng.normal(size=(n, p))).astype(np.float32), labels


def _close(a, b, tol=1e-5, rtol=None):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol if rtol is None else rtol, atol=tol)


def _aligned(a, b):
    """Eigenvector rows of ``a`` flipped to the signs of ``b``'s."""
    a, b = np.asarray(a), np.asarray(b)
    return a * np.sign(np.sum(a * b, axis=1, keepdims=True))


def _same_pca(est, ref):
    _close(est.explained_variance_, ref.explained_variance_, rtol=1e-5, tol=1e-6)
    _close(_aligned(est.components_.numpy(), ref.components_), ref.components_)
    _close(est.mean_, ref.mean_)


# ------------------------------------------------- backend equivalence ------


def test_mean_cov_backends_match_batch():
    x = np.random.default_rng(1).normal(size=(1000, 64)).astype(np.float32)
    batch = SparsifiedCov(_plan(), key=7, **CPU).fit(x)
    alt = SparsifiedCov(_plan(backend="stream"), key=7, **CPU).fit(x)
    _close(alt.mean_, batch.mean_.numpy())
    _close(alt.cov_, batch.cov_.numpy(), rtol=1e-4)
    assert alt.count_ == batch.count_ == 1000
    for backend, est in (("batch", batch), ("stream", alt)):
        ref = japi.SparsifiedCov(_jplan(backend=backend), key=7).fit(x)
        _close(est.mean_, ref.mean_)
        _close(est.cov_, ref.cov_)
        m = SparsifiedMean(_plan(backend=backend), key=7, **CPU).fit(x)
        _close(m.mean_, batch.mean_.numpy())


def test_pca_backends_match_batch():
    x = _lowrank()
    batch = SparsifiedPCA(4, _plan(), key=5, **CPU).fit(x)
    alt = SparsifiedPCA(4, _plan(backend="stream"), key=5, **CPU).fit(x)
    _close(alt.explained_variance_, batch.explained_variance_.numpy(), rtol=1e-5)
    _close(_aligned(alt.components_.numpy(), batch.components_.numpy()),
           batch.components_.numpy())
    for backend, est in (("batch", batch), ("stream", alt)):
        _same_pca(est, japi.SparsifiedPCA(4, _jplan(backend=backend), key=5).fit(x))


@pytest.mark.parametrize("algorithm", ("lloyd", "minibatch"))
def test_kmeans_backends_match_batch(algorithm):
    from scipy.optimize import linear_sum_assignment

    x, _ = _clusters(1000, 64, 4)
    batch = SparsifiedKMeans(4, _plan(), key=9, algorithm=algorithm, **CPU).fit(x)
    alt = SparsifiedKMeans(4, _plan(backend="stream"), key=9, algorithm=algorithm, **CPU).fit(x)
    _close(float(alt.objective_), float(batch.objective_), rtol=1e-5)
    d = np.linalg.norm(alt.centers_.numpy()[:, None] - batch.centers_.numpy()[None], axis=-1)
    ri, ci = linear_sum_assignment(d)
    assert float(d[ri, ci].max()) < 1e-5 * (1 + float(batch.centers_.abs().max()))
    # both folds are backend-independent in the reference: one reference fit
    ref = japi.SparsifiedKMeans(4, _jplan(backend="stream"), key=9, algorithm=algorithm).fit(x)
    for est in (batch, alt):
        _close(est.centers_, ref.centers_)
        _close(float(est.objective_), float(ref.objective_), rtol=1e-5)
        if algorithm == "lloyd":
            np.testing.assert_array_equal(est.labels_.numpy(), np.asarray(ref.labels_))
            assert est.n_iter_ == ref.n_iter_
        else:
            np.testing.assert_array_equal(est.reassign_counts_, ref.reassign_counts_)


def test_partial_fit_matches_fit():
    """Feeding the stream in batch_size pieces == one fit of the concatenation."""
    x = np.random.default_rng(2).normal(size=(600, 32)).astype(np.float32)
    plan = _plan(backend="stream", batch_size=100)
    whole = SparsifiedCov(plan, key=3, **CPU).fit(x)
    inc = SparsifiedCov(plan, key=3, **CPU)
    for i in range(6):
        inc.partial_fit(x[i * 100:(i + 1) * 100])
    inc.finalize()
    assert torch.equal(inc.cov_, whole.cov_) and torch.equal(inc.mean_, whole.mean_)
    _close(whole.cov_, japi.SparsifiedCov(_jplan(backend="stream", batch_size=100),
                                          key=3).fit(x).cov_)


def test_fit_stream_consumes_pipeline_source():
    est = SparsifiedMean(_plan(backend="stream", batch_size=128), key=2, **CPU)
    est.fit_stream(VectorStreamSource(p=64, batch=128, seed=3), steps=3)
    assert est.count_ == 384 and est.mean_.shape == (64,)
    ref = japi.SparsifiedMean(_jplan(backend="stream", batch_size=128), key=2)
    _close(est.mean_, ref.fit_stream(JSource(p=64, batch=128, seed=3), steps=3).mean_)


# --------------------------------------------- fit_many: one shared sketch --


@pytest.mark.parametrize("backend", ("batch", "stream"))
def test_fit_many_equals_separate_fits(backend):
    x, _ = _clusters(1000, 64, 4)
    plan = _plan(backend=backend)

    def consumers(mod, plan):
        return [mod.SparsifiedMean(plan, key=7, **kw(mod)), mod.SparsifiedCov(plan, key=7, **kw(mod)),
                mod.SparsifiedPCA(4, plan, key=7, **kw(mod)),
                mod.SparsifiedKMeans(4, plan, key=7, **kw(mod)),
                mod.SparsifiedKMeans(4, plan, key=7, algorithm="minibatch", **kw(mod))]

    def kw(mod):
        return CPU if mod is api else {}

    shared = consumers(api, plan)
    run = fit_many(plan, shared, x)
    assert run.count == 1000 and run.n_sketches == 5 and len(run) == 5
    separate = [c.fit(x) for c in consumers(api, plan)]
    mean_c, cov_c, pca_c, km_l, km_m = shared
    mean_s, cov_s, pca_s, km_ls, km_ms = separate
    assert torch.equal(mean_c.mean_, mean_s.mean_) and torch.equal(cov_c.cov_, cov_s.cov_)
    assert torch.equal(pca_c.components_, pca_s.components_)
    assert torch.equal(km_l.centers_, km_ls.centers_) and torch.equal(km_l.labels_, km_ls.labels_)
    assert torch.equal(km_m.centers_, km_ms.centers_)
    assert mean_c.count_ == cov_c.count_ == km_l.count_ == 1000

    jplan = _jplan(backend=backend)
    ref = consumers(japi, jplan)
    japi.fit_many(jplan, ref, x)
    _close(mean_c.mean_, ref[0].mean_)
    _close(cov_c.cov_, ref[1].cov_)
    _same_pca(pca_c, ref[2])
    _close(km_l.centers_, ref[3].centers_)
    np.testing.assert_array_equal(km_l.labels_.numpy(), np.asarray(ref[3].labels_))
    _close(km_m.centers_, ref[4].centers_)


def test_fit_many_sketches_once_per_chunk(monkeypatch):
    calls = {"n": 0}
    real = sketch.sketch

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(sketch, "sketch", counting)
    x = np.random.default_rng(3).normal(size=(600, 64)).astype(np.float32)
    plan = _plan()  # batch_size=200 → 3 chunks

    def consumers():
        return [SparsifiedPCA(4, plan, key=7, **CPU), SparsifiedCov(plan, key=7, **CPU),
                SparsifiedKMeans(4, plan, key=7, **CPU)]

    run = fit_many(plan, consumers(), x)
    assert calls["n"] == 3 == run.n_sketches
    calls["n"] = 0
    for c in consumers():
        c.fit(x)
    assert calls["n"] == 9  # separate fits: one pass per consumer


def test_fit_many_from_source():
    plan = _plan(backend="stream", batch_size=128)
    mean_c, cov_c = SparsifiedMean(plan, key=2, **CPU), SparsifiedCov(plan, key=2, **CPU)
    run = fit_many(plan, [mean_c, cov_c], source=VectorStreamSource(p=64, batch=128, seed=3),
                   steps=3)
    assert run.count == 384
    ref = SparsifiedMean(plan, key=2, **CPU).fit_stream(
        VectorStreamSource(p=64, batch=128, seed=3), steps=3)
    assert torch.equal(mean_c.mean_, ref.mean_)
    assert cov_c.cov_.shape == (64, 64)
    jplan = _jplan(backend="stream", batch_size=128)
    jcov = japi.SparsifiedCov(jplan, key=2)
    japi.fit_many(jplan, [jcov], source=JSource(p=64, batch=128, seed=3), steps=3)
    _close(cov_c.cov_, jcov.cov_)


def test_fit_many_continued_ingest():
    x = np.random.default_rng(4).normal(size=(400, 32)).astype(np.float32)
    plan = _plan(backend="stream", batch_size=100)
    mean_c, cov_c = SparsifiedMean(plan, key=3, **CPU), SparsifiedCov(plan, key=3, **CPU)
    run = fit_many(plan, [mean_c, cov_c], x[:200], finalize=False)
    run.partial_fit(x[200:]).finalize()
    whole = SparsifiedCov(plan, key=3, **CPU).fit(x)
    assert torch.equal(cov_c.cov_, whole.cov_) and torch.equal(mean_c.mean_, whole.mean_)
    assert mean_c.count_ == 400


def test_reset_detaches_from_shared_cursor():
    x = np.random.default_rng(5).normal(size=(400, 32)).astype(np.float32)
    plan = _plan(backend="stream", batch_size=100)
    mean_c, cov_c = SparsifiedMean(plan, key=3, **CPU), SparsifiedCov(plan, key=3, **CPU)
    run = fit_many(plan, [mean_c, cov_c], x[:200], finalize=False)
    mean_c.reset()
    run.partial_fit(x[200:])            # only cov_c still rides the shared pass
    assert mean_c.count_ == 0 and cov_c.count_ == 400
    run.finalize()
    assert not mean_c._fitted and cov_c._fitted
    assert torch.equal(cov_c.cov_, SparsifiedCov(plan, key=3, **CPU).fit(x).cov_)
    mean_c.fit(x[:100])
    assert mean_c.count_ == 100


def test_fit_many_validation():
    x = np.ones((8, 16), np.float32)
    plan = _plan()
    mean = SparsifiedMean(plan, key=0, **CPU)
    with pytest.raises(ValueError, match="at least one"):
        fit_many(plan, [], x)
    with pytest.raises(ValueError, match="exactly one"):
        fit_many(plan, [mean])
    with pytest.raises(ValueError, match="exactly one"):
        fit_many(plan, [mean], x, source=lambda s, t, sh: x)
    with pytest.raises(ValueError, match="steps"):
        fit_many(plan, [mean], source=lambda s, t, sh: x)
    with pytest.raises(ValueError, match="same key"):
        fit_many(plan, [mean, SparsifiedCov(plan, key=1, **CPU)], x)
    with pytest.raises(ValueError, match="gamma"):
        fit_many(plan, [SparsifiedMean(_plan(gamma=0.5), key=0, **CPU)], x)
    with pytest.raises(TypeError, match="SketchedEstimator"):
        fit_many(plan, [np.ones((4, 4))], x)
    with pytest.raises(ValueError, match="p="):
        mean.partial_fit(np.ones((8, 16)))
        mean.partial_fit(np.ones((8, 32)))


def test_fit_many_scan_validation_and_host_loop():
    """scan=True keeps the reference's validation (retained sketches and
    source-driven ingest raise); on the folds it takes, the host loop gives
    what scan=False gives."""
    x = _lowrank(n=440, p=64)
    plan = _plan(backend="stream", batch_size=100, n_shards=2)
    with pytest.raises(ValueError, match="lax.scan"):
        fit_many(plan, [SparsifiedKMeans(3, plan, key=1, **CPU)], x, scan=True)   # lloyd
    batch = _plan(backend="batch", batch_size=100)
    with pytest.raises(ValueError, match="lax.scan"):
        fit_many(batch, [SparsifiedCov(batch, key=1, **CPU)], x, scan=True)
    with pytest.raises(ValueError, match="scan=True"):
        fit_many(plan, [SparsifiedMean(plan, key=1, **CPU)],
                 source=lambda s, t, sh: x[:100], steps=2, seed=0, scan=True)
    plan_lr = plan.replace(cov_path="lowrank", rank=16)

    def consumers():
        return [SparsifiedMean(plan, key=1, **CPU), SparsifiedPCA(3, plan_lr, key=1, **CPU),
                SparsifiedKMeans(3, plan, key=1, algorithm="minibatch", **CPU)]

    host, scanned = consumers(), consumers()
    fit_many(plan, host, x)
    run = fit_many(plan, scanned, x, scan=True)
    assert run.cursor.chunk_rows == [100, 100, 100, 100, 40] and run.n_sketches == 5
    assert torch.equal(host[0].mean_, scanned[0].mean_)
    assert torch.equal(host[1].components_, scanned[1].components_)
    assert torch.equal(host[2].centers_, scanned[2].centers_)
    np.testing.assert_array_equal(host[2].reassign_counts_, scanned[2].reassign_counts_)


# -------------------------------------------------- minibatch K-means ------


def test_minibatch_tail_flush_and_interleaved_finalize():
    x, _ = _clusters(1100, 32, 3, seed=1)
    plan = _plan(backend="stream", batch_size=100, n_shards=2)
    est = SparsifiedKMeans(3, plan, key=5, algorithm="minibatch", **CPU)
    ref = japi.SparsifiedKMeans(3, _jplan(backend="stream", batch_size=100, n_shards=2),
                                key=5, algorithm="minibatch")
    est.partial_fit(x[:500])            # 5 chunks = 2 full steps + 1 pending shard
    ref.partial_fit(x[:500])
    assert est._km_pending is not None
    est.finalize()
    ref.finalize()
    assert est._km_pending is None and est.count_ == 500
    c1 = est.centers_.clone()
    _close(c1, ref.centers_)
    est.partial_fit(x[500:])            # 6 more chunks, ends on a half step again
    ref.partial_fit(x[500:])
    est.finalize()
    ref.finalize()
    assert est.count_ == 1100 and est.centers_.shape == (3, 32)
    assert not torch.allclose(est.centers_, c1)  # the tail data counted
    _close(est.centers_, ref.centers_)
    np.testing.assert_array_equal(est.reassign_counts_, ref.reassign_counts_)


def test_minibatch_ragged_tail_with_decay():
    decay = 0.8
    x, _ = _clusters(1030, 16, 3, seed=2)
    plan = _plan(backend="stream", batch_size=100, n_shards=2)
    est = SparsifiedKMeans(3, plan, key=5, algorithm="minibatch", decay=decay, **CPU)
    ref = japi.SparsifiedKMeans(3, _jplan(backend="stream", batch_size=100, n_shards=2),
                                key=5, algorithm="minibatch", decay=decay)
    bound = 100 * 2 / (1 - decay)       # decay bounds any cell's count
    for lo, hi, steps in ((0, 330, 2), (330, 1030, 6)):
        est.partial_fit(x[lo:hi])
        ref.partial_fit(x[lo:hi])
        est.finalize()
        ref.finalize()
        assert est.count_ == hi and len(est.reassign_counts_) == steps
        counts = est._km_state.counts
        assert counts.dtype == torch.float32
        assert bool((counts >= 0).all()) and float(counts.max()) <= bound + 1e-3
        np.testing.assert_array_equal(est.reassign_counts_, ref.reassign_counts_)
        _close(counts, ref._km_state.counts)
        _close(est.centers_, ref.centers_)
    assert est.reassign_fraction_.shape == (6,) and np.all(est.reassign_fraction_ <= 1.0)


def test_minibatch_zero_row_batch_is_noop():
    x, _ = _clusters(300, 32, 3, seed=3)
    plan = _plan(backend="stream", batch_size=100)
    est = SparsifiedKMeans(3, plan, key=5, algorithm="minibatch", **CPU)
    est.partial_fit(x)
    st = est._km_state
    est.partial_fit(np.zeros((0, 32), np.float32))
    assert est._km_state is st and est.count_ == 300
    est.finalize()
    assert est.count_ == 300
    est2 = SparsifiedKMeans(3, plan, key=5, algorithm="minibatch", **CPU)
    est2.partial_fit(np.zeros((0, 32), np.float32))
    with pytest.raises(RuntimeError, match="no batches"):
        est2.finalize()


# ------------------------------------------------------ sketch() utility ----


def test_sketch_on_unfitted_does_not_pin():
    est = SparsifiedMean(_plan(), key=0, **CPU)
    s = est.sketch(np.ones((4, 64), np.float32))
    assert s.n == 4
    assert est.spec_ is None and est._reducer is None
    est.partial_fit(np.ones((8, 32), np.float32))
    assert est.spec_.p == 32


def test_sketch_mask_key_per_call():
    x0 = np.random.default_rng(6).normal(size=(64, 64)).astype(np.float32)
    est = SparsifiedMean(_plan(), key=0, **CPU).fit(x0)
    ref = japi.SparsifiedMean(_jplan(), key=0).fit(x0)
    x = np.ones((16, 64), np.float32)
    s1, s2 = est.sketch(x), est.sketch(x)
    assert torch.equal(s1.indices, s2.indices)
    s3 = est.sketch(x, mask_key=1)
    assert not torch.equal(s3.indices, s1.indices)
    assert torch.equal(est.sketch(x, mask_key=1).indices, s3.indices)
    for got, mask_key in ((s1, None), (s3, 1)):
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(ref.sketch(x, mask_key=mask_key).indices))
    s4 = est.sketch(x, mask_key=jax.random.key_data(jax.random.PRNGKey(4)))
    np.testing.assert_array_equal(
        s4.indices.numpy(), np.asarray(ref.sketch(x, mask_key=jax.random.PRNGKey(4)).indices))


# ------------------------------------------------------------ DCT -----------


def test_dct_pca_end_to_end():
    x = _lowrank(p=60)  # non-power-of-two: DCT needs no padding
    plan = _plan(transform="dct", gamma=0.3)
    est = SparsifiedPCA(4, plan, key=11, **CPU).fit(x)
    assert est.components_.shape == (4, 60)
    xt = torch.from_numpy(x)
    ev = float(pca.explained_variance(est.components_, xt))
    assert ev > 0.9 * float(pca.explained_variance(pca.pca(xt, 4).components, xt))
    est_s = SparsifiedPCA(4, plan.replace(backend="stream"), key=11, **CPU).fit(x)
    _close(_aligned(est_s.components_.numpy(), est.components_.numpy()), est.components_.numpy())
    _same_pca(est, japi.SparsifiedPCA(4, _jplan(transform="dct", gamma=0.3), key=11).fit(x))


def test_dct_kmeans_end_to_end():
    x, labels = _clusters(900, 48, 3, seed=4)
    est = SparsifiedKMeans(3, _plan(transform="dct", gamma=0.4), key=13, **CPU).fit(x)
    assert kmeans.clustering_accuracy(est.labels_, labels, 3) > 0.95
    pred = est.predict(x[:200])
    assert float(torch.mean((pred == est.labels_[:200]).float())) > 0.95
    ref = japi.SparsifiedKMeans(3, _jplan(transform="dct", gamma=0.4), key=13).fit(x)
    np.testing.assert_array_equal(est.labels_.numpy(), np.asarray(ref.labels_))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(ref.predict(x[:200])))
    _close(est.centers_, ref.centers_, tol=1e-4)


# ------------------------------------------------ covariance paths ----------


@pytest.mark.parametrize("backend", ("batch", "stream"))
def test_compact_cov_path_matches_dense(backend):
    x = np.random.default_rng(7).normal(size=(500, 64)).astype(np.float32)
    dense = SparsifiedCov(_plan(backend=backend, gamma=0.1), key=4, **CPU).fit(x)
    compact = SparsifiedCov(_plan(backend=backend, gamma=0.1, cov_path="compact"), key=4,
                            **CPU).fit(x)
    _close(compact.cov_, dense.cov_.numpy(), tol=1e-4)
    ref = japi.SparsifiedCov(_jplan(backend=backend, gamma=0.1, cov_path="compact"),
                             key=4).fit(x)
    _close(compact.cov_, ref.cov_)


def test_cov_original_domain_roundtrip():
    x = _lowrank(n=4000, p=32)
    est = SparsifiedCov(_plan(gamma=0.5, batch_size=1000), key=6, **CPU).fit(x)
    c = est.cov_original()
    assert c.shape == (32, 32)
    c_emp = estimators.empirical_cov(torch.from_numpy(x)).numpy()
    assert np.linalg.norm(c.numpy() - c_emp, 2) / np.linalg.norm(c_emp, 2) < 0.15
    ref = japi.SparsifiedCov(_jplan(gamma=0.5, batch_size=1000), key=6).fit(x)
    _close(c, ref.cov_original(), tol=1e-4)
    _close(estimators.empirical_cov(torch.from_numpy(x)), jest.empirical_cov(x))


def test_plan_validation():
    with pytest.raises(ValueError, match="backend"):
        Plan(backend="nope", gamma=0.1)
    with pytest.raises(ValueError, match="cov_path"):
        Plan(gamma=0.1, cov_path="sparse")
    with pytest.raises(ValueError, match="n_shards"):
        Plan(gamma=0.1, n_shards=0)
    with pytest.raises(ValueError, match="m >= 2"):
        SparsifiedCov(Plan(m=1), key=0, **CPU).fit(np.ones((8, 16), np.float32))
    with pytest.raises(RuntimeError, match="no batches"):
        SparsifiedMean(_plan(), key=0, **CPU).finalize()
    for chunk in range(7):
        assert Plan(n_shards=3).step_shard(chunk) == japi.Plan(n_shards=3).step_shard(chunk)


# ------------------------------------------- the README's API examples -----


def test_readme_api_example_both_backends():
    """README "API: one front door": SparsifiedPCA(8, Plan(batch, γ=0.05,
    batch_size=2048, n_shards=8)).fit(x) on (20000, 1024), and its stream twin."""
    rng = np.random.default_rng(8)
    u, _ = np.linalg.qr(rng.normal(size=(1024, 8)))
    x = ((rng.normal(size=(20000, 8)) * np.linspace(10, 3, 8)) @ u.T
         + 0.05 * rng.normal(size=(20000, 1024))).astype(np.float32)
    plan = Plan(backend="batch", gamma=0.05, batch_size=2048, n_shards=8)
    jplan = japi.Plan(backend="batch", gamma=0.05, batch_size=2048, n_shards=8)
    fitted = []
    for backend in ("batch", "stream"):
        est = SparsifiedPCA(8, plan.replace(backend=backend), key=0, **CPU).fit(x)
        _same_pca(est, japi.SparsifiedPCA(8, jplan.replace(backend=backend), key=0).fit(x))
        assert est.count_ == 20000 and est._cursor.n_sketches == 10
        fitted.append(est)
    _close(fitted[1].explained_variance_, fitted[0].explained_variance_.numpy(), rtol=1e-5)
    _close(_aligned(fitted[1].components_.numpy(), fitted[0].components_.numpy()),
           fitted[0].components_.numpy())


def test_readme_fused_fit_example_both_backends():
    """README "Fused multi-consumer fit": fit_many(plan, [mean, PCA(8),
    K-means(10)], x) under Plan(gamma=0.05, batch_size=4096), one sketch a
    chunk, on rows near 10 centers along orthogonal directions of distinct
    weight (so the top eigenpairs lie well apart): the reference's mean,
    components, labels and centers."""
    rng = np.random.default_rng(10)
    q, _ = np.linalg.qr(rng.normal(size=(1024, 10)))
    scale = 4 * np.array([20, 17, 14.5, 12.5, 10.5, 9, 7.5, 6.5, 5.5, 4.5])
    x = ((q * scale).T[rng.integers(0, 10, 8192)] + 0.5 * rng.normal(size=(8192, 1024))).astype(np.float32)
    for backend in ("batch", "stream"):
        plan = Plan(backend=backend, gamma=0.05, batch_size=4096)
        jplan = japi.Plan(backend=backend, gamma=0.05, batch_size=4096)
        mean, pca_, km = (SparsifiedMean(plan, key=0, **CPU), SparsifiedPCA(8, plan, key=0, **CPU),
                          SparsifiedKMeans(10, plan, key=0, **CPU))
        run = fit_many(plan, [mean, pca_, km], x)
        assert run.n_sketches == 2
        ref = [japi.SparsifiedMean(jplan, key=0), japi.SparsifiedPCA(8, jplan, key=0),
               japi.SparsifiedKMeans(10, jplan, key=0)]
        japi.fit_many(jplan, ref, x)
        _close(mean.mean_, ref[0].mean_)
        _same_pca(pca_, ref[1])
        np.testing.assert_array_equal(km.labels_.numpy(), np.asarray(ref[2].labels_))
        _close(km.centers_, ref[2].centers_)


def test_reference_state_continues_in_the_port():
    """A reference estimator's state_arrays() load into the port's estimator
    (its spec bound), which continues the pass to the reference's result."""
    x, _ = _clusters(600, 64, 3, seed=9)
    for backend, algorithm in (("stream", "minibatch"), ("batch", "lloyd")):
        jplan = _jplan(backend=backend, batch_size=100)
        ref = japi.SparsifiedKMeans(3, jplan, key=2, algorithm=algorithm).partial_fit(x[:300])
        est = SparsifiedKMeans(3, _plan(backend=backend, batch_size=100), key=2,
                               algorithm=algorithm, **CPU)
        est._cursor.ensure_spec(64)
        est.load_state_arrays(ref.state_arrays())
        est._cursor.chunk = ref._cursor.chunk
        est.partial_fit(x[300:]).finalize()
        ref.partial_fit(x[300:]).finalize()
        assert est.count_ == ref.count_ == 600
        _close(est.centers_, ref.centers_)
        # and the other way: the port's state into the reference
        back = japi.SparsifiedKMeans(3, jplan, key=2, algorithm=algorithm)
        back._cursor.ensure_spec(64)
        back.load_state_arrays(est.state_arrays())
        _close(back.finalize().centers_, ref.centers_)
    jcov = japi.SparsifiedCov(_jplan(backend="stream", batch_size=100), key=2).partial_fit(x[:300])
    cov = SparsifiedCov(_plan(backend="stream", batch_size=100), key=2, **CPU)
    cov._cursor.ensure_spec(64)
    cov.load_state_arrays(jcov.state_arrays())
    cov._cursor.chunk = jcov._cursor.chunk
    _close(cov.partial_fit(x[300:]).finalize().cov_, jcov.partial_fit(x[300:]).finalize().cov_)


def test_lowrank_pca_estimator_matches_the_engine():
    """SparsifiedPCA on the low-rank range path folds the sketches the engine
    folds: the same RangeState, bit for bit, and the reference's top-k."""
    plan = Plan(backend="stream", gamma=0.1, batch_size=64, cov_path="lowrank", rank=16)
    est = SparsifiedPCA(4, plan, key=1, **CPU).fit_stream(
        VectorStreamSource(p=200, batch=64, seed=0), 3)
    eng = api.make_engine(plan, 200, 1, VectorStreamSource(p=200, batch=64, seed=0), device="cpu")
    eng.run(3)
    for f in ("y", "diag", "sum_w", "count"):
        assert torch.equal(getattr(est._reducer.state, f), getattr(eng.state.lowrank, f))
    ref = japi.SparsifiedPCA(4, japi.Plan(backend="stream", gamma=0.1, batch_size=64,
                                          cov_path="lowrank", rank=16), key=1)
    ref.fit_stream(JSource(p=200, batch=64, seed=0), 3)
    _close(est.explained_variance_, ref.explained_variance_, rtol=1e-4, tol=1e-5)


# --------------------------------------------------- what is not ported ------


def test_not_ported_paths_name_their_item(tmp_path):
    """What is not ported raises naming its item; what the port has (the
    sharded backend, the FD path, refinement, estimator and fused-run
    checkpoints) runs."""
    x = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    plan = _plan()
    two = plan.replace(backend="sharded", batch_size=4, n_shards=2)
    _close(SparsifiedMean(two, **CPU).fit(x).mean_,
           SparsifiedMean(two.replace(backend="stream"), **CPU).fit(x).mean_.numpy())
    cases = [
        ("LM side, last", lambda: api.GradCompressor()),
    ]
    for item, call in cases:
        with pytest.raises(NotImplementedError, match=item):
            call()
    lr = plan.replace(cov_path="lowrank", rank=8, batch_size=4)
    fd = SparsifiedPCA(2, lr.replace(lowrank_method="fd"), **CPU).fit(x)
    assert fd.components_.shape == (2, 16)
    assert SparsifiedPCA(2, lr, **CPU).fit(x).refine(x).refine_passes_ == 1
    km = SparsifiedKMeans(2, plan.replace(backend="stream", batch_size=4),
                          algorithm="minibatch", **CPU).fit_refine(x)
    assert km.refine_passes_ == 1
    run = fit_many(lr, [SparsifiedPCA(2, lr, **CPU)], x, refine=True)
    assert run[0].refine_passes_ == 1
    SparsifiedMean(plan, **CPU).fit(x).checkpoint(str(tmp_path / "est"))
    assert SparsifiedMean(plan, **CPU).restore(str(tmp_path / "est")).count_ == 8
    fit_many(plan, [SparsifiedMean(plan, **CPU)], x).checkpoint(str(tmp_path / "run"))
    assert api.restore_run(str(tmp_path / "run"), plan, [SparsifiedMean(plan, **CPU)]).count == 8
    # make_engine takes a streaming backend, as the reference's does
    with pytest.raises(ValueError, match="estimator classes"):
        api.make_engine(plan, 16, 0, lambda s, t, sh: x, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SparsifiedMean(plan)
