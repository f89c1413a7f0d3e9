"""The sharded backend of repro_torch in one process against repro's on its
one-device mesh, on the CPU: the same numpy rows and the same key go into
both packages.

In one process the port's mesh owns every shard and its all-reduce is the
identity, so ``backend="sharded"`` folds each step's shard sketches, sums
their deltas and applies them once — the reference's shard_map psum on one
device. Tolerances are the reference's: means and centers 1e-5, covariances
1e-4 (tests/test_api.py:573), eigenvalues 1e-5 relative and eigenvectors 1e-5
after sign alignment; counts, Lloyd's labels and reassignment counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.sketchserve as jserve
from repro.core import sketch as jsketch
from repro.stream import sharded as jsharded
from repro_torch import api
from repro_torch.api import Plan, SparsifiedCov, SparsifiedKMeans, SparsifiedMean, SparsifiedPCA
from repro_torch.api.plan import mesh_spec
from repro_torch.cluster import process_mesh
from repro_torch.core import estimators, sketch
from repro_torch.sketchserve import SketchService, restore_service
from repro_torch.stream import StreamKMeansConfig
from repro_torch.stream import sharded
from repro_torch.stream.engine import StreamEngine

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("repro_torch implements jax_threefry_partitionable=True only")


def _kw(kw):
    kw.setdefault("backend", "sharded")
    kw.setdefault("gamma", 0.25)
    kw.setdefault("batch_size", 200)
    return kw


def _plan(**kw):
    return Plan(**_kw(kw))


def _jplan(**kw):
    return japi.Plan(**_kw(kw))


def _close(a, b, tol=1e-5, rtol=None):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol if rtol is None else rtol, atol=tol)


def _aligned(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a * np.sign(np.sum(a * b, axis=1, keepdims=True))


def _lowrank(n=1200, p=64, seed=0):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(p, 4)))
    z = rng.normal(size=(n, 4)) * np.asarray([9.0, 6.0, 4.0, 2.5])
    return (z @ u.T + 0.05 * rng.normal(size=(n, p))).astype(np.float32)


def _clusters(n, p, k, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, p)) * 3.0
    labels = rng.integers(0, k, n)
    return (centers[labels] + 0.5 * rng.normal(size=(n, p))).astype(np.float32)


# ------------------------------------------- estimators at n_shards = 1 ------


def test_mean_cov_sharded_matches_reference():
    x = np.random.default_rng(1).normal(size=(1000, 64)).astype(np.float32)
    cov = SparsifiedCov(_plan(), key=7, **CPU).fit(x)
    ref = japi.SparsifiedCov(_jplan(), key=7).fit(x)
    _close(cov.mean_, ref.mean_)
    _close(cov.cov_, ref.cov_, rtol=1e-4)
    assert cov.count_ == ref.count_ == 1000
    stream = SparsifiedCov(_plan(backend="stream"), key=7, **CPU).fit(x)
    _close(cov.cov_, stream.cov_.numpy())
    mean = SparsifiedMean(_plan(), key=7, **CPU).fit(x)
    _close(mean.mean_, japi.SparsifiedMean(_jplan(), key=7).fit(x).mean_)


@pytest.mark.parametrize("cov_path", ["dense", "lowrank"])
def test_pca_sharded_matches_reference(cov_path):
    x = _lowrank()
    kw = dict(cov_path="lowrank", rank=16) if cov_path == "lowrank" else {}
    est = SparsifiedPCA(4, _plan(**kw), key=5, **CPU).fit(x)
    ref = japi.SparsifiedPCA(4, _jplan(**kw), key=5).fit(x)
    _close(est.explained_variance_, ref.explained_variance_, rtol=1e-5, tol=1e-6)
    _close(_aligned(est.components_.numpy(), ref.components_), ref.components_)
    _close(est.mean_, ref.mean_)


@pytest.mark.parametrize("algorithm", ["lloyd", "minibatch"])
def test_kmeans_sharded_matches_reference(algorithm):
    x = _clusters(1000, 64, 4)
    est = SparsifiedKMeans(4, _plan(), key=9, algorithm=algorithm, **CPU).fit(x)
    ref = japi.SparsifiedKMeans(4, _jplan(), key=9, algorithm=algorithm).fit(x)
    _close(est.centers_, ref.centers_)
    _close(float(est.objective_), float(ref.objective_), rtol=1e-5)
    if algorithm == "lloyd":
        assert np.array_equal(est.labels_.numpy(), np.asarray(ref.labels_))
    else:
        assert np.array_equal(est.reassign_counts_, np.asarray(ref.reassign_counts_))
        stream = SparsifiedKMeans(4, _plan(backend="stream"), key=9, algorithm=algorithm,
                                  **CPU).fit(x)
        assert torch.equal(est.centers_, stream.centers_)


def test_trailing_partial_step_flushed_at_n_shards_8():
    """1160 rows / batch 80 = 15 chunks, not a multiple of n_shards = 8: the
    trailing partial step must be all-reduced at reduce time (as
    tests/test_api.py's 8-device run checks for the reference)."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1160, 64)))
    plan = _plan(gamma=0.25, batch_size=80, n_shards=8)
    alt = SparsifiedCov(plan, key=7, **CPU).fit(x)
    assert alt.count_ == 1160
    batch = SparsifiedCov(plan.replace(backend="batch"), key=7, **CPU).fit(x)
    _close(alt.mean_, batch.mean_.numpy())
    _close(alt.cov_, batch.cov_.numpy(), tol=1e-4)
    ref = japi.SparsifiedCov(japi.Plan(backend="batch", gamma=0.25, batch_size=80, n_shards=8),
                             key=7).fit(x)
    _close(alt.cov_, ref.cov_, tol=1e-4)
    k1 = SparsifiedKMeans(4, plan.replace(backend="batch"), key=9, **CPU).fit(x)
    k8 = SparsifiedKMeans(4, plan, key=9, **CPU).fit(x)
    assert np.array_equal(k8.labels_.numpy(), k1.labels_.numpy())


# ------------------------------------------------- the one-shot reductions --


def test_one_shot_sharded_mean_cov_any_row_count():
    """n = 100 rows over an 8-shard mesh (tests/test_stream.py:167): the
    reference pads to divide the mesh; the port's process holds all rows.
    Both equal the one-shot estimators; the count is the true n."""
    p = 256
    spec = sketch.make_spec(p, np.asarray(jax.random.key_data(jax.random.PRNGKey(1))), gamma=0.25)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (100, p)))
    s = sketch.sketch(torch.from_numpy(x), spec)
    mesh = process_mesh(8)
    _close(sharded.sharded_mean(s, mesh), estimators.mean_estimator(s).numpy())
    _close(sharded.sharded_cov(s, mesh), estimators.cov_estimator(s).numpy(), tol=1e-4)
    assert int(sharded.sharded_moments(s, mesh).count) == 100
    jspec = jsketch.make_spec(p, jax.random.PRNGKey(1), gamma=0.25)
    js = jsketch.sketch(jnp.asarray(x), jspec)
    jmesh = jax.make_mesh((1,), ("data",))
    _close(sharded.sharded_mean(s, mesh), jsharded.sharded_mean(js, jmesh))
    _close(sharded.sharded_cov(s, mesh), jsharded.sharded_cov(js, jmesh), tol=1e-4)
    # a masked pad adds nothing to the K-means step
    st = api.make_engine(Plan(backend="stream", gamma=0.25), p, 1, lambda *a: x, device="cpu",
                         kmeans=StreamKMeansConfig(k=3)).init_state()
    pad = sketch.sketch(torch.from_numpy(np.concatenate([x, np.zeros((4, p), np.float32)])),
                        spec)
    a, _ = sharded.sharded_kmeans_step(st.kmeans, sketch.sketch(torch.from_numpy(x), spec), mesh)
    b, _ = sharded.sharded_kmeans_step(
        st.kmeans, pad, mesh, mask=np.r_[np.ones(100), np.zeros(4)])
    assert int(b.count) == 100 and torch.equal(a.centers, b.centers)


def test_psum_identity_without_a_group_and_bytes():
    mesh = process_mesh(2)
    tree = (torch.ones(3), torch.tensor(5, dtype=torch.int32), None)
    assert sharded.psum(tree, mesh) is tree and sharded.psum(tree, None) is tree
    assert sharded.psum_bytes(tree) == 4 * 3 + 4 * 2


# ------------------------------------------------------- engine and refine --


def test_engine_sharded_equals_stream_bit_for_bit():
    """make_engine(backend="sharded") in one process folds the stream
    engine's deltas in the same order: the same bits, replay included."""
    from repro_torch.data.pipeline import VectorStreamSource

    src = VectorStreamSource(p=96, batch=24, seed=3)
    km = StreamKMeansConfig(k=3, track_reassignments=True)
    plan = Plan(backend="stream", gamma=0.25, batch_size=24, n_shards=3)
    a = api.make_engine(plan, 96, 2, src, kmeans=km, device="cpu")
    b = api.make_engine(plan.replace(backend="sharded"), 96, 2, src, kmeans=km, device="cpu")
    ra, rb = a.run(4), b.run(4)
    assert b.mesh == process_mesh(3) and b._local == [0, 1, 2]
    for f in ("mean", "cov", "centers"):
        assert torch.equal(getattr(ra, f), getattr(rb, f))
    assert np.array_equal(ra.reassign_counts, rb.reassign_counts)
    assert torch.equal(a.replay(4).centers, b.replay(4).centers)
    with pytest.raises(ValueError, match="n_shards"):
        StreamEngine(a.spec, src, n_shards=2, mesh=process_mesh(3), device="cpu")


def test_sharded_refine_matches_stream():
    """The sharded PCA refinement over two shards and two-pass K-means
    (tests/test_refine.py:63 and :106) equal the stream backend's and the
    reference's (its stream backend where its mesh would need two devices)."""
    rng = np.random.default_rng(4)
    u, _ = np.linalg.qr(rng.normal(size=(64, 3)))
    x = ((rng.normal(size=(1100, 3)) * [10.0, 8.5, 7.0]) @ u.T
         + 1e-2 * rng.normal(size=(1100, 64))).astype(np.float32)
    kw = dict(gamma=0.5, batch_size=200, cov_path="lowrank", rank=16, n_shards=2)
    fits = {b: SparsifiedPCA(3, _plan(backend=b, **kw), key=3, **CPU).fit_refine(x, passes=2)
            for b in ("stream", "sharded")}
    # two shards need two devices for the reference's mesh: its stream backend
    ref = japi.SparsifiedPCA(3, _jplan(backend="stream", **kw), key=3).fit_refine(x, passes=2)
    _close(_aligned(fits["sharded"].components_.numpy(), fits["stream"].components_.numpy()),
           fits["stream"].components_.numpy())
    _close(_aligned(fits["sharded"].components_.numpy(), ref.components_), ref.components_)

    xk = _clusters(2100, 16, 4, seed=2)
    kw = dict(gamma=0.5, batch_size=100)
    km = {b: SparsifiedKMeans(4, _plan(backend=b, **kw), key=5, algorithm="minibatch",
                              **CPU).fit_refine(xk, passes=3) for b in ("stream", "sharded")}
    jkm = japi.SparsifiedKMeans(4, _jplan(**kw), key=5, algorithm="minibatch").fit_refine(
        xk, passes=3)
    assert torch.equal(km["sharded"].centers_, km["stream"].centers_)
    _close(km["sharded"].centers_, jkm.centers_)
    assert np.array_equal(km["sharded"].refine_reassign_counts_,
                          np.asarray(jkm.refine_reassign_counts_))


# ----------------------------------------------- a sharded tenant's snapshot --


def test_sharded_tenant_snapshot_crosses_packages(tmp_path):
    """A tenant whose plan names a mesh: the mesh's geometry goes into the
    snapshot as the reference writes it, and each package restores the
    other's with the same answers."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 32)).astype(np.float32)
    plan = Plan(backend="sharded", gamma=0.5, batch_size=64, mesh=process_mesh(1))
    jplan = japi.Plan(backend="sharded", gamma=0.5, batch_size=64,
                      mesh=jax.make_mesh((1,), ("data",)))
    assert mesh_spec(plan.mesh) == {"axis_names": ["data"], "shape": [1]}
    with SketchService(**CPU) as svc:
        svc.create_tenant("c", "cov", plan=plan, key=3)
        assert svc.ingest("c", x).result(60).ok
        mine = svc.query("c", "mean").unwrap()
        svc.snapshot(str(tmp_path / "port"))
    with jserve.SketchService(scan="never") as jsvc:
        jsvc.create_tenant("c", "cov", plan=jplan, key=3)
        assert jsvc.ingest("c", x).result(60).ok
        theirs = jsvc.query("c", "mean").unwrap()
        jsvc.snapshot(str(tmp_path / "ref"))
    _close(mine, theirs)
    with restore_service(str(tmp_path / "ref"), **CPU) as svc:
        _close(svc.query("c", "mean").unwrap(), theirs)
    with jserve.restore_service(str(tmp_path / "port"), scan="never") as jsvc:
        _close(mine, jsvc.query("c", "mean").unwrap())
