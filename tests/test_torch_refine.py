"""Second-pass refinement in repro_torch against repro on the CPU: the cases
of tests/test_refine.py as parity for the same key and the same numpy rows —
power refinement, two-pass K-means, engine replay against estimator refine
against replay_scanned, repeat refines that resume, the validation surface,
the ``tol=`` loop and fit_many(refine=) sharing one replay — and run_scanned
against run (tests/test_stream.py).

Tolerances: inside the port, what the reference holds bit-identical is
bit-identical (backends, repeat refines, engine against estimator, scanned
against looped). Against the reference: refined subspaces within a largest
principal-angle sine of 1e-5 (measured over float64 orthonormal bases; the
column signs of the two SVDs differ), the per-pass subspace changes within
1e-3 absolute (the reference's float32 √(1 − cos²) reads ≈ 5e-4 for a settled
pass), eigenvalues and K-means centers 1e-5 relative, reassignment counts and
pass counts equal. Behavioural claims that
hold for one key only (caveats R2 and R4 in ROADMAP.md: two-pass centers
closer to the truth) are asserted as parity alone.
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import sketch as jsketch
from repro.stream import StreamEngine as JEngine
from repro.stream import StreamKMeansConfig as JKMeans
from repro_torch import api
from repro_torch import refine as rf
from repro_torch.core import sketch
from repro_torch.stream import StreamEngine, StreamKMeansConfig
from repro_torch.stream import accumulators as acc
from repro_torch.utils import prng
from tests.conftest import make_clusters, max_angle_sin
from tests.conftest import spiked as _spiked

KEY = jax.random.PRNGKey(0)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("repro_torch implements jax_threefry_partitionable=True only")


def spiked(n, p, k, **kw):
    return np.asarray(_spiked(KEY, n, p, k, **kw), np.float32)


def clusters(n, p, k, **kw):
    return np.asarray(make_clusters(KEY, n=n, p=p, k=k, **kw)[0], np.float32)


def _plans(**kw):
    return api.Plan(**kw), japi.Plan(**kw)


def _rel(a, b, tol=1e-5):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(b)), 1e-30), np.max(np.abs(a - b))


def _sine(a, b) -> float:
    """Largest principal-angle sine between the row spaces of a and b, as
    ‖(I − QaQaᵀ)Qb‖₂ over float64 orthonormal bases: it resolves angles near
    1e-7, where max_angle_sin's √(1 − cos²) of float32 rows stops at ≈ 1e-3."""
    qa = np.linalg.qr(np.asarray(a, np.float64).T)[0]
    qb = np.linalg.qr(np.asarray(b, np.float64).T)[0]
    return float(np.linalg.norm(qb - qa @ (qa.T @ qb), 2))


def _same_subspace(a, b, tol=1e-5):
    assert _sine(a, b) <= tol, _sine(a, b)


# ------------------------------------------------------------ PCA algebra ---


def test_power_pass_squares_the_subspace_gap():
    """One pass shrinks dense-vs-lowrank principal angles ≥ 10× at a narrow
    rank, more passes keep shrinking, and each refined fit is the
    reference's."""
    p, k, n, ell = 64, 4, 4000, 12
    x = spiked(n, p, k)
    dense = api.SparsifiedPCA(k, api.Plan(gamma=0.5, batch_size=500), key=3, **CPU).fit(x)
    plan, jplan = _plans(backend="stream", gamma=0.5, batch_size=500, cov_path="lowrank",
                         rank=ell)
    a_one = max_angle_sin(api.SparsifiedPCA(k, plan, key=3, **CPU).fit(x).components_,
                          dense.components_)
    ref = api.SparsifiedPCA(k, plan, key=3, **CPU).fit_refine(x, passes=1)
    a_ref = max_angle_sin(ref.components_, dense.components_)
    assert a_one > 1e-2 and a_ref * 10 < a_one, (a_one, a_ref)
    assert ref.refine_passes_ == 1 and ref.count_ == n
    ref3 = api.SparsifiedPCA(k, plan, key=3, **CPU).fit_refine(x, passes=3)
    ch = ref3.refine_subspace_change_
    assert ch.shape == (3,) and ch[0] > 10 * ch[1] > 0
    jref3 = japi.SparsifiedPCA(k, jplan, key=3).fit_refine(x, passes=3)
    _same_subspace(ref3.components_, jref3.components_)
    _rel(ref3.explained_variance_, jref3.explained_variance_)
    np.testing.assert_allclose(ch, jref3.refine_subspace_change_, atol=1e-3)


def test_refined_pca_bit_identical_across_backends():
    """Replay folds the same deltas in the same order on both backends, so the
    refined components are bit-identical (ragged last chunk included)."""
    p, k, n, ell = 64, 3, 1100, 16
    x = spiked(n, p, k)
    fits = {b: api.SparsifiedPCA(k, api.Plan(backend=b, gamma=0.5, batch_size=200,
                                             cov_path="lowrank", rank=ell),
                                 key=3, **CPU).fit_refine(x, passes=2)
            for b in ("batch", "stream")}
    assert torch.equal(fits["stream"].components_, fits["batch"].components_)
    np.testing.assert_array_equal(fits["stream"].refine_subspace_change_,
                                  fits["batch"].refine_subspace_change_)
    jfit = japi.SparsifiedPCA(k, japi.Plan(backend="batch", gamma=0.5, batch_size=200,
                                           cov_path="lowrank", rank=ell),
                              key=3).fit_refine(x, passes=2)
    _same_subspace(fits["batch"].components_, jfit.components_)


def _stream_data(steps, b, p, k):
    data = spiked(steps * b, p, k).reshape(steps, 1, b, p)

    def source(seed, step, shard):
        return data[step, shard]

    return data, source


def test_fit_refine_from_stream_source():
    """fit_refine(source=) = fit_stream + replays of the same source; the
    refined subspace beats the one-pass fit and is the reference's."""
    p, k, ell, b, steps = 64, 3, 12, 100, 10
    data, source = _stream_data(steps, b, p, k)
    plan, jplan = _plans(backend="stream", gamma=0.5, batch_size=b, cov_path="lowrank",
                         rank=ell)
    dense = api.SparsifiedPCA(k, api.Plan(gamma=0.5, batch_size=b), key=9,
                              **CPU).fit(data.reshape(-1, p))
    one = api.SparsifiedPCA(k, plan, key=9, **CPU).fit_stream(source, steps=steps)
    ref = api.SparsifiedPCA(k, plan, key=9, **CPU).fit_refine(source=source, steps=steps,
                                                              passes=2)
    assert (max_angle_sin(ref.components_, dense.components_)
            < max_angle_sin(one.components_, dense.components_) / 5)
    jref = japi.SparsifiedPCA(k, jplan, key=9).fit_refine(source=source, steps=steps, passes=2)
    _same_subspace(ref.components_, jref.components_)


# --------------------------------------------------------- two-pass kmeans --


def test_two_pass_kmeans_bit_identical_and_tracked():
    """Refined centers are bit-identical across backends; one reassignment
    count per rebuild (the trailing measurement prices the last); all equal
    to the reference's."""
    x = clusters(2100, 16, 4, sep=2.0, noise=0.8)
    fits = {b: api.SparsifiedKMeans(4, api.Plan(backend=b, gamma=0.5, batch_size=100), key=5,
                                    algorithm="minibatch", **CPU).fit_refine(x, passes=3)
            for b in ("batch", "stream")}
    assert torch.equal(fits["stream"].centers_, fits["batch"].centers_)
    est = fits["stream"]
    assert est.refine_passes_ == 3 and est.refine_reassign_counts_.shape == (3,)
    assert est.refine_reassign_counts_[0] >= est.refine_reassign_counts_[-1]
    assert np.all(est.refine_reassign_fraction_ <= 1.0)
    jest = japi.SparsifiedKMeans(4, japi.Plan(backend="stream", gamma=0.5, batch_size=100),
                                 key=5, algorithm="minibatch").fit_refine(x, passes=3)
    _rel(est.centers_, jest.centers_)
    _rel(est.objective_, jest.objective_)
    np.testing.assert_array_equal(est.refine_reassign_counts_, jest.refine_reassign_counts_)
    # without tracking there is no trailing measurement replay
    off = api.SparsifiedKMeans(4, api.Plan(backend="stream", gamma=0.5, batch_size=100), key=5,
                               algorithm="minibatch", track_reassignments=False,
                               **CPU).fit_refine(x, passes=3)
    assert off.refine_reassign_counts_.shape == (2,)
    assert torch.equal(off.centers_, est.centers_)


def test_two_pass_kmeans_refined_centers_match_reference():
    """tests/test_refine.py's "beats streaming centers" fit (key=5), held
    only as parity: the refined centers and counts equal the reference's."""
    x = clusters(4000, 32, 5, sep=3.0, noise=1.0)
    plan, jplan = _plans(backend="stream", gamma=0.5, batch_size=100)
    ref = api.SparsifiedKMeans(5, plan, key=5, algorithm="minibatch", **CPU).fit_refine(
        x, passes=2)
    jref = japi.SparsifiedKMeans(5, jplan, key=5, algorithm="minibatch").fit_refine(x, passes=2)
    _rel(ref.centers_, jref.centers_)
    np.testing.assert_array_equal(ref.refine_reassign_counts_, jref.refine_reassign_counts_)


# ------------------------------------------------------------ shared replay --


def test_fit_many_refine_shares_the_replay_sketches(monkeypatch):
    """fit_many(refine=) replays each (step, shard) sketch once a pass for
    both refiners; results equal the separate fit_refine calls."""
    calls = {"n": 0}
    real = sketch.sketch

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(sketch, "sketch", counting)
    x = spiked(1000, 64, 4)          # 5 chunks of 200
    base = api.Plan(backend="stream", gamma=0.5, batch_size=200)
    plan_lr = base.replace(cov_path="lowrank", rank=12)
    pca = api.SparsifiedPCA(4, plan_lr, key=7, **CPU)
    km = api.SparsifiedKMeans(3, base, key=7, algorithm="minibatch", **CPU)
    mean = api.SparsifiedMean(base, key=7, **CPU)
    api.fit_many(base, [pca, km, mean], x, refine=2)
    # 5 forward + 2 passes × 5 + 1 trailing measurement replay × 5 = 20
    assert calls["n"] == 20
    assert pca.refine_passes_ == 2 and km.refine_passes_ == 2
    assert not hasattr(mean, "refine_passes_")
    monkeypatch.setattr(sketch, "sketch", real)
    sep_pca = api.SparsifiedPCA(4, plan_lr, key=7, **CPU).fit_refine(x, passes=2)
    assert torch.equal(pca.components_, sep_pca.components_)
    sep_km = api.SparsifiedKMeans(3, base, key=7, algorithm="minibatch", **CPU).fit_refine(
        x, passes=2)
    assert torch.equal(km.centers_, sep_km.centers_)
    np.testing.assert_array_equal(km.refine_reassign_counts_, sep_km.refine_reassign_counts_)
    jbase = japi.Plan(backend="stream", gamma=0.5, batch_size=200)
    jpca = japi.SparsifiedPCA(4, jbase.replace(cov_path="lowrank", rank=12), key=7)
    jkm = japi.SparsifiedKMeans(3, jbase, key=7, algorithm="minibatch")
    japi.fit_many(jbase, [jpca, jkm], x, refine=2)
    _same_subspace(pca.components_, jpca.components_)
    _rel(km.centers_, jkm.centers_)
    np.testing.assert_array_equal(km.refine_reassign_counts_, jkm.refine_reassign_counts_)


# ---------------------------------------------------------- engine replay ---


def test_engine_replay_matches_estimator_and_scan():
    """StreamEngine.replay() is bit-equal to the estimator's refine over the
    same chunks, replay_scanned to replay; both match the reference."""
    p, k, ell, b, steps = 64, 3, 12, 100, 8
    data, source = _stream_data(steps, b, p, k)
    plan, jplan = _plans(backend="stream", gamma=0.5, batch_size=b, cov_path="lowrank",
                         rank=ell)
    est = api.SparsifiedPCA(k, plan, key=9, **CPU).fit_refine(source=source, steps=steps,
                                                              passes=2)
    eng = api.make_engine(plan, p, 9, source, **CPU)
    res0 = eng.run(steps)
    res = eng.replay(steps, passes=2)
    assert res.refine_passes == 2 and res.cov is None
    comps = sketch.unmix_dense(res.cov_lowrank.top(k)[0], eng.spec)
    assert torch.equal(comps, est.components_)
    assert torch.equal(res.cov_lowrank.eigenvalues[:k], est.explained_variance_)
    res_scan = eng.replay_scanned(torch.from_numpy(data), passes=2)
    assert torch.equal(res_scan.cov_lowrank.eigenvalues, res.cov_lowrank.eigenvalues)
    assert torch.equal(res.mean, res0.mean) and int(res.count) == steps * b
    jeng = japi.make_engine(jplan, p, 9, source)
    jeng.run(steps)
    jres = jeng.replay(steps, passes=2)
    _rel(res.cov_lowrank.eigenvalues[:k], jres.cov_lowrank.eigenvalues[:k])
    _same_subspace(comps, jsketch.unmix_dense(jres.cov_lowrank.top(k)[0], jeng.spec))


def test_engine_replay_kmeans_two_pass():
    """Engine K-means replay: frozen-assignment rebuilds with the in-pass flip
    counts (rebuilds 1..q-1), one pass equal to a hand-rolled kmeans2 fold
    over the same sketches, and the reference's replay."""
    p, b, steps = 32, 100, 6
    data = clusters(steps * b, p, 3, sep=3.0, noise=0.8).reshape(steps, 1, b, p)

    def source(seed, step, shard):
        return data[step, shard]

    spec = sketch.make_spec(p, prng.PRNGKey(3), gamma=0.5)
    eng = StreamEngine(spec, source, track_cov=False, kmeans=StreamKMeansConfig(k=3, n_init=2),
                       **CPU)
    res0 = eng.run(steps)
    res = eng.replay(steps, passes=3)
    assert res.refine_passes == 3 and len(res.refine_reassigned) == 2
    assert res.refine_reassigned[0] >= res.refine_reassigned[-1]
    assert res.centers.shape == res0.centers.shape
    frozen, _ = acc.kmeans_finalize(eng.state.kmeans)
    st = rf.kmeans2_init(3, spec.p_pad)
    for step in range(steps):
        s = sketch.sketch(torch.from_numpy(data[step, 0]), spec,
                          batch_key=sketch.batch_key(spec, step, 0))
        st = rf.kmeans2_apply(st, rf.kmeans2_delta(s, frozen))
    res1 = eng.replay(steps, passes=1)
    assert torch.equal(res1.centers_pre, rf.kmeans2_centers(st, frozen))
    assert torch.equal(res1.kmeans_obj, st.obj)
    jeng = JEngine(jsketch.make_spec(p, jax.random.PRNGKey(3), gamma=0.5), source,
                   track_cov=False, kmeans=JKMeans(k=3, n_init=2))
    jeng.run(steps)
    jres = jeng.replay(steps, passes=3)
    _rel(res.centers, jres.centers)
    assert res.refine_reassigned == jres.refine_reassigned


def test_run_scanned_matches_run():
    """run_scanned over a staged stream is bit-identical to run() over the
    same rows (tests/test_stream.py), with reassignment tracking on, and
    matches the reference's run_scanned."""
    p, b, steps = 64, 32, 5
    data = np.random.default_rng(5).normal(size=(steps, 1, b, p)).astype(np.float32)

    def source(seed, step, shard):
        return data[step, shard]

    spec = sketch.make_spec(p, prng.PRNGKey(5), gamma=0.25)
    km = StreamKMeansConfig(k=3, n_init=2, track_reassignments=True)
    eng = StreamEngine(spec, source, kmeans=km, **CPU)
    res_loop = eng.run(steps)
    res_scan = eng.run_scanned(torch.from_numpy(data))
    for name in ("mean", "cov", "centers"):
        assert torch.equal(getattr(res_loop, name), getattr(res_scan, name))
    np.testing.assert_array_equal(res_loop.reassign_total, res_scan.reassign_total)
    jeng = JEngine(jsketch.make_spec(p, jax.random.PRNGKey(5), gamma=0.25), source,
                   kmeans=JKMeans(k=3, n_init=2, track_reassignments=True))
    jres = jeng.run_scanned(data)
    for name in ("mean", "cov", "centers"):
        _rel(getattr(res_scan, name), getattr(jres, name))
    np.testing.assert_array_equal(res_scan.reassign_total, np.asarray(jres.reassign_total))


def test_repeat_refine_resumes_not_restarts():
    """refine() twice ≡ refine(passes=2), bit for bit, for PCA and K-means;
    a re-fit resets the refinement."""
    p, k, ell = 64, 3, 12
    x = spiked(1000, p, k)
    plan = api.Plan(backend="stream", gamma=0.5, batch_size=200, cov_path="lowrank", rank=ell)
    two = api.SparsifiedPCA(k, plan, key=3, **CPU).fit_refine(x, passes=2)
    inc = api.SparsifiedPCA(k, plan, key=3, **CPU).fit_refine(x, passes=1)
    inc.refine(x, passes=1)
    assert inc.refine_passes_ == 2 and torch.equal(inc.components_, two.components_)
    np.testing.assert_array_equal(inc.refine_subspace_change_, two.refine_subspace_change_)
    base = api.Plan(backend="stream", gamma=0.5, batch_size=100)
    xc = clusters(1500, 16, 4, sep=2.0, noise=0.9)
    km2 = api.SparsifiedKMeans(4, base, key=5, algorithm="minibatch", **CPU).fit_refine(
        xc, passes=2)
    kmi = api.SparsifiedKMeans(4, base, key=5, algorithm="minibatch", **CPU).fit_refine(
        xc, passes=1)
    kmi.refine(xc, passes=1)
    assert kmi.refine_passes_ == 2 and torch.equal(kmi.centers_, km2.centers_)
    np.testing.assert_array_equal(kmi.refine_reassign_counts_, km2.refine_reassign_counts_)
    jkm = japi.SparsifiedKMeans(4, japi.Plan(backend="stream", gamma=0.5, batch_size=100),
                                key=5, algorithm="minibatch").fit_refine(xc, passes=1)
    jkm.refine(xc, passes=1)
    _rel(kmi.centers_, jkm.centers_)
    np.testing.assert_array_equal(kmi.refine_reassign_counts_, jkm.refine_reassign_counts_)
    kmi.fit(xc)
    assert kmi.refine_passes_ == 0


# -------------------------------------------------------------- validation --


def _raises_like_reference(exc, match, port_call, ref_call):
    with pytest.raises(exc, match=match):
        port_call()
    with pytest.raises(exc, match=match):
        ref_call()


def test_refine_validation_surface():
    """The reference's refusals, with the same exception types, in the port."""
    x = spiked(400, 32, 2)
    base, jbase = _plans(gamma=0.5, batch_size=100)
    lr, jlr = base.replace(cov_path="lowrank", rank=8), jbase.replace(cov_path="lowrank", rank=8)
    cases = [
        (ValueError, "refine_passes", lambda: api.Plan(gamma=0.5, refine_passes=-1),
         lambda: japi.Plan(gamma=0.5, refine_passes=-1)),
        (ValueError, "lowrank", lambda: api.SparsifiedPCA(2, base, **CPU).fit_refine(x),
         lambda: japi.SparsifiedPCA(2, jbase).fit_refine(x)),
        (ValueError, "fd",
         lambda: api.SparsifiedPCA(2, lr.replace(lowrank_method="fd"), **CPU).fit_refine(x),
         lambda: japi.SparsifiedPCA(2, jlr.replace(lowrank_method="fd")).fit_refine(x)),
        (ValueError, "lloyd", lambda: api.SparsifiedKMeans(2, base, **CPU).fit_refine(x),
         lambda: japi.SparsifiedKMeans(2, jbase).fit_refine(x)),
        (ValueError, "forget",
         lambda: api.SparsifiedKMeans(2, base.replace(backend="stream"), algorithm="minibatch",
                                      decay=0.9, **CPU).fit_refine(x),
         lambda: japi.SparsifiedKMeans(2, jbase.replace(backend="stream"),
                                       algorithm="minibatch", decay=0.9).fit_refine(x)),
        (ValueError, "refinement", lambda: api.SparsifiedMean(base, **CPU).fit_refine(x),
         lambda: japi.SparsifiedMean(jbase).fit_refine(x)),
        (RuntimeError, "fitted", lambda: api.SparsifiedPCA(2, lr, **CPU).refine(x),
         lambda: japi.SparsifiedPCA(2, jlr).refine(x)),
        (ValueError, "exactly one", lambda: api.SparsifiedPCA(2, lr, **CPU).fit_refine(),
         lambda: japi.SparsifiedPCA(2, jlr).fit_refine()),
        (ValueError, "passes", lambda: api.SparsifiedPCA(2, lr, **CPU).fit_refine(x, passes=0),
         lambda: japi.SparsifiedPCA(2, jlr).fit_refine(x, passes=0)),
        (ValueError, "steps",
         lambda: api.SparsifiedPCA(2, lr, **CPU).fit_refine(source=lambda s, t, sh: x[:100]),
         lambda: japi.SparsifiedPCA(2, jlr).fit_refine(source=lambda s, t, sh: x[:100])),
        (ValueError, "no consumer",
         lambda: api.fit_many(base, [api.SparsifiedMean(base, **CPU)], x, refine=True),
         lambda: japi.fit_many(jbase, [japi.SparsifiedMean(jbase)], x, refine=True)),
        (ValueError, "FINALIZED",
         lambda: api.fit_many(base, [api.SparsifiedPCA(2, lr, **CPU)], x, refine=True,
                              finalize=False),
         lambda: japi.fit_many(jbase, [japi.SparsifiedPCA(2, jlr)], x, refine=True,
                               finalize=False)),
    ]
    for exc, match, port_call, ref_call in cases:
        _raises_like_reference(exc, match, port_call, ref_call)
    # plan default: refine_passes drives fit_refine when passes is omitted
    est = api.SparsifiedPCA(2, lr.replace(refine_passes=2), **CPU).fit_refine(x)
    assert est.refine_passes_ == 2
    # engine: replay before run, replay with nothing to refine, passes < 1,
    # and a decayed K-means
    eng = api.make_engine(api.Plan(backend="stream", gamma=0.5, batch_size=100,
                                   cov_path="lowrank", rank=8), 32, 0,
                          lambda s, t, sh: x[:100], **CPU)
    with pytest.raises(RuntimeError, match="run"):
        eng.replay(4)
    eng.run(2)
    with pytest.raises(ValueError, match="passes"):
        eng.replay(2, passes=0)
    plain = api.make_engine(api.Plan(backend="stream", gamma=0.5, batch_size=100), 32, 0,
                            lambda s, t, sh: x[:100], **CPU)
    plain.run(2)
    with pytest.raises(ValueError, match="neither"):
        plain.replay(2)
    decayed = api.make_engine(api.Plan(backend="stream", gamma=0.5, batch_size=100), 32, 0,
                              lambda s, t, sh: x[:100], track_cov=False,
                              kmeans=StreamKMeansConfig(k=2, decay=0.9), **CPU)
    decayed.run(2)
    with pytest.raises(ValueError, match="un-forget"):
        decayed.replay(2)
    # replay data must match the fitted geometry: row count, then p
    fitted = api.SparsifiedPCA(2, lr, **CPU).fit(x)
    with pytest.raises(ValueError, match="rows"):
        fitted.refine(np.ones((100, 16), np.float32))
    with pytest.raises(ValueError, match="p="):
        fitted.refine(np.ones((400, 16), np.float32))
    # ragged partial_fit histories replay under their recorded chunk rows,
    # bit-identically to a twin with the same history
    ragged = api.SparsifiedPCA(2, lr, **CPU)
    ragged.partial_fit(x[:130]).partial_fit(x[130:]).finalize()
    assert ragged._cursor.chunk_rows == [100, 30, 100, 100, 70]
    ragged.refine(x)
    twin = api.SparsifiedPCA(2, lr, **CPU)
    twin.partial_fit(x[:130]).partial_fit(x[130:]).finalize()
    twin.refine(x)
    assert ragged.refine_passes_ == 1 and torch.equal(ragged.components_, twin.components_)
    jragged = japi.SparsifiedPCA(2, jlr)
    jragged.partial_fit(x[:130]).partial_fit(x[130:]).finalize()
    jragged.refine(x)
    _same_subspace(ragged.components_, jragged.components_)


# ------------------------------------------------------------ adaptive tol --


def test_refine_tol_converges_and_matches_fixed_passes():
    """refine(tol=) stops at the first pass whose subspace change drops to tol
    and equals refine(passes=q) for that q, bit for bit; an unreachable tol
    runs to max_passes. The reference settles on the same q."""
    p, k, ell = 64, 3, 12
    x = spiked(1000, p, k)
    plan, jplan = _plans(backend="stream", gamma=0.5, batch_size=200, cov_path="lowrank",
                         rank=ell)
    tol = 2e-3
    est = api.SparsifiedPCA(k, plan, key=3, **CPU).fit_refine(x, tol=tol)
    assert est.refine_converged_
    q = est.refine_passes_
    ch = np.asarray(est.refine_subspace_change_)
    assert 1 <= q < 16 and ch[-1] <= tol and np.all(ch[:-1] > tol)
    fixed = api.SparsifiedPCA(k, plan, key=3, **CPU).fit_refine(x, passes=q)
    assert torch.equal(est.components_, fixed.components_)
    capped = api.SparsifiedPCA(k, plan, key=3, **CPU).fit_refine(x, tol=1e-30, max_passes=2)
    assert not capped.refine_converged_ and capped.refine_passes_ == 2
    jest = japi.SparsifiedPCA(k, jplan, key=3).fit_refine(x, tol=tol)
    assert jest.refine_passes_ == q
    _same_subspace(est.components_, jest.components_)


def test_refine_tol_kmeans_and_validation():
    xc = clusters(1500, 16, 4, sep=2.0, noise=0.9)
    base, jbase = _plans(backend="stream", gamma=0.5, batch_size=100)
    km = api.SparsifiedKMeans(4, base, key=5, algorithm="minibatch", **CPU).fit_refine(
        xc, tol=0.05)
    assert km.refine_converged_ and float(km.refine_reassign_fraction_[-1]) <= 0.05
    jkm = japi.SparsifiedKMeans(4, jbase, key=5, algorithm="minibatch").fit_refine(xc, tol=0.05)
    assert km.refine_passes_ == jkm.refine_passes_
    _rel(km.centers_, jkm.centers_)
    with pytest.raises(ValueError, match="track_reassignments"):
        api.SparsifiedKMeans(4, base, key=5, algorithm="minibatch", track_reassignments=False,
                             **CPU).fit_refine(xc, tol=0.05)
    x = spiked(400, 32, 2)
    lr = api.Plan(gamma=0.5, batch_size=100, cov_path="lowrank", rank=8)
    with pytest.raises(ValueError, match="not both"):
        api.SparsifiedPCA(2, lr, **CPU).fit_refine(x, passes=2, tol=1e-3)
    with pytest.raises(ValueError, match="tol"):
        api.SparsifiedPCA(2, lr, **CPU).fit_refine(x, tol=0.0)
    with pytest.raises(ValueError, match="max_passes"):
        api.SparsifiedPCA(2, lr, **CPU).fit_refine(x, tol=1e-3, max_passes=0)
