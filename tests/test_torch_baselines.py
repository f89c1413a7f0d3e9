"""The paper's baselines, bounds and sketching pipeline in repro_torch against
repro on the CPU: the same numpy rows and the same key go into both packages.

Tolerances: ``prng.choice`` returns the reference's indices exactly; the
bounds' scalar algebra agrees to 1e-12 relative in float64 on the same
statistics, and the statistics themselves (float32 norms) to 1e-6 relative;
the K-means baselines give equal assignments and centers within 1e-5 (float32
products and a pseudo-inverse of another library); the pipeline's sketches are
bit-equal. The cases of tests/test_kmeans.py, tests/test_estimators.py,
tests/test_distance_preservation.py, tests/test_ros.py and
tests/test_sampling.py that use these rerun here as parity tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as jbounds
from repro.core import estimators as jest
from repro.core import kmeans as jkm
from repro.core import ros as jros
from repro.core import sampling as jsampling
from repro.core import sketch as jsketch
from repro.data import pipeline as jpipeline
from repro_torch.core import bounds, estimators, ros, sampling, sketch
from repro_torch.core import kmeans as km
from repro_torch.data import pipeline
from repro_torch.utils import prng
from tests.conftest import make_clusters
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

KEY = jax.random.PRNGKey(0)


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


# ------------------------------------------------------------- prng.choice --


@pytest.mark.parametrize("n,m", [(50, 10), (300, 300), (2000, 100)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("replace", [False, True])
def test_choice_bit_equal(n, m, weighted, replace):
    """Every path of jax.random.choice on an int population: the uniform
    draws (randint, and the permutation's sort rounds: one up to 1625, two
    above), the cumulative-sum search and the Gumbel top-k."""
    for seed in range(8):
        k = jax.random.PRNGKey(seed)
        pr = None
        if weighted:
            pr = np.random.default_rng(seed).random(n).astype(np.float32)
            pr /= pr.sum()
        want = jax.random.choice(k, n, (m,), replace=replace,
                                 p=None if pr is None else jnp.asarray(pr))
        got = prng.choice(_kd(k), n, (m,), replace=replace,
                          p=None if pr is None else torch.from_numpy(pr))
        assert np.array_equal(np.asarray(want), got.numpy()), (seed, n, m)


def test_choice_log_ulps():
    """The Gumbel top-k adds log p: torch.log and XLA's log of the same
    float32 probabilities, in ulps. Where they differed by an ulp, two scores
    could swap; on this host they agree on the leverage scores' range."""
    pr = np.random.default_rng(0).random(1 << 16).astype(np.float32) ** 4
    pr /= pr.sum()
    a = np.asarray(jnp.log(jnp.asarray(pr))).view(np.int32).astype(np.int64)
    b = torch.log(torch.from_numpy(pr)).numpy().view(np.int32).astype(np.int64)
    assert int(np.abs(a - b).max()) <= 1


def test_choice_refuses_oversampling():
    with pytest.raises(ValueError, match="larger sample"):
        prng.choice(_kd(KEY), 4, (5,), replace=False)


# ------------------------------------------------------------------ bounds --


def test_mean_error_within_thm4_bound():
    n, p, m = 4096, 128, 38
    xj = jax.random.normal(KEY, (n, p)) * 0.3 + 1.0
    x = _t(xj)
    s = sampling.subsample(x, _kd(jax.random.PRNGKey(3)), m)
    err = float(torch.max(torch.abs(estimators.mean_estimator(s) - estimators.empirical_mean(x))))
    x_max, x_row = float(bounds.max_abs(x)), float(bounds.max_coord_norm(x))
    assert x_max == float(jbounds.max_abs(xj))
    assert _rel(x_row, float(jbounds.max_coord_norm(xj))) <= 1e-6
    t = bounds.mean_error_bound(0.01, n, m, p, x_max, x_row)
    assert _rel(t, jbounds.mean_error_bound(0.01, n, m, p, x_max, x_row)) <= 1e-12
    assert err <= t, f"ℓ∞ err {err} exceeded Thm 4 bound {t}"


def test_cov_error_within_thm6_bound():
    """Preconditioned data: spectral error ≤ Thm 6 bound at δ₂ = 0.01; the
    bound's terms equal the reference's on the same statistics."""
    n, p, m = 2000, 128, 38
    spec = sketch.make_spec(p, _kd(KEY), m=m)
    xj = jax.random.normal(jax.random.PRNGKey(7), (n, p))
    xj = xj / jnp.linalg.norm(xj, axis=1, keepdims=True)
    y = ros.precondition(_t(xj), spec.signs_key(), "hadamard")
    s = sampling.subsample(y, spec.mask_key(), m)
    c_emp = estimators.empirical_cov(y)
    err = float(torch.linalg.matrix_norm(estimators.cov_estimator(s) - c_emp, ord=2))
    terms = bounds.cov_bound_from_data(y, m)
    t = terms.error_bound(0.01)
    assert err <= t, f"spectral err {err} exceeded Thm 6 bound {t}"
    yj = jnp.asarray(y.numpy())
    ref = jbounds.cov_bound_from_data(yj, m)
    assert _rel(terms.L, ref.L) <= 1e-5 and _rel(terms.sigma_sq, ref.sigma_sq) <= 1e-5
    stats = dict(n=n, m=m, p=p, rho=0.3, x_max=float(bounds.max_abs(y)),
                 x_maxcol=float(bounds.max_sample_norm(y)), x_fro_sq=float(torch.sum(y ** 2)),
                 cov_norm=1.7, diag_cov_norm=0.02, max_fourth=float(bounds.max_fourth_moment(y)))
    assert _rel(float(bounds.max_fourth_moment(y)), float(jbounds.max_fourth_moment(yj))) <= 1e-6
    mine, theirs = bounds.cov_bound_terms(**stats), jbounds.cov_bound_terms(**stats)
    assert _rel(mine.L, theirs.L) <= 1e-12 and _rel(mine.sigma_sq, theirs.sigma_sq) <= 1e-12
    assert _rel(mine.error_bound(0.01), theirs.error_bound(0.01)) <= 1e-12


def test_bound_inversions_consistent():
    """failure_prob(error_bound(δ)) == δ for Thm 4, 6, 7 inversions, each
    equal to the reference's to 1e-12 relative."""
    n, m, p = 1000, 30, 100
    t = bounds.mean_error_bound(0.01, n, m, p, 0.5, 3.0)
    assert np.isclose(bounds.mean_failure_prob(t, n, m, p, 0.5, 3.0), 0.01, rtol=1e-6)
    assert _rel(t, jbounds.mean_error_bound(0.01, n, m, p, 0.5, 3.0)) <= 1e-12
    assert _rel(bounds.mean_failure_prob(t, n, m, p, 0.5, 3.0),
                jbounds.mean_failure_prob(t, n, m, p, 0.5, 3.0)) <= 1e-12

    terms = bounds.CovBoundTerms(L=0.3, sigma_sq=0.02, p=p)
    t6 = terms.error_bound(0.05)
    assert np.isclose(terms.failure_prob(t6), 0.05, rtol=1e-6)
    assert _rel(t6, jbounds.CovBoundTerms(L=0.3, sigma_sq=0.02, p=p).error_bound(0.05)) <= 1e-12

    t7 = bounds.hk_error_bound(0.001, n_k=500, m=m, p=p)
    assert np.isclose(bounds.hk_failure_prob(t7, 500, m, p), 0.001, rtol=1e-6)
    assert _rel(t7, jbounds.hk_error_bound(0.001, n_k=500, m=m, p=p)) <= 1e-12
    for fn, args in [("tau", (30, 100)), ("ros_max_entry_bound", (n, p, 0.01)),
                     ("ros_max_coord_norm_bound", (n, p, 0.01, "dct")),
                     ("rho_bound", (n, p, m)), ("cor5_min_m", (n, p, 0.1)),
                     ("distance_preservation_min_m", (5.0, 4096))]:
        assert _rel(getattr(bounds, fn)(*args), getattr(jbounds, fn)(*args)) <= 1e-12, fn


# ----------------------------------------------------- distance preservation --


def test_pairwise_distance_preservation():
    """Thm D6 (tests/test_distance_preservation.py): the same ratios as the
    reference's to 1e-5, and the theorem's band holds."""
    p, n_pairs = 4096, 200
    beta = 5.0
    m = int(np.ceil(bounds.distance_preservation_min_m(beta, p)))
    assert m < p
    k1, k2, k3 = jax.random.split(KEY, 3)
    diff_j = jax.random.normal(k1, (n_pairs, p)) - jax.random.normal(k2, (n_pairs, p))
    diff = _t(diff_j)
    y = ros.precondition(diff, _kd(k3), "hadamard")
    s = sampling.subsample(y, _kd(jax.random.fold_in(k3, 1)), m)
    ratio = np.sqrt(p / m) * torch.linalg.vector_norm(s.values, dim=1) / torch.linalg.vector_norm(diff, dim=1)
    sj = jsampling.subsample(jros.precondition(diff_j, k3, "hadamard"), jax.random.fold_in(k3, 1), m)
    ratio_j = jnp.sqrt(p / m) * jnp.linalg.norm(sj.values, axis=1) / jnp.linalg.norm(diff_j, axis=1)
    assert np.array_equal(s.indices.numpy(), np.asarray(sj.indices))
    np.testing.assert_allclose(ratio.numpy(), np.asarray(ratio_j), rtol=1e-5)
    frac_ok = float(torch.mean(((ratio >= 0.40) & (ratio <= 1.48)).float()))
    assert frac_ok >= 1.0 - 3.0 / beta, f"only {frac_ok:.2f} of pairs within D6 band"


def test_distance_preservation_tighter_than_bound():
    p, m = 512, 128
    k1, k2 = jax.random.split(KEY)
    diff = _t(jax.random.normal(k1, (500, p)))
    y = ros.precondition(diff, _kd(k2), "hadamard")
    s = sampling.subsample(y, _kd(jax.random.fold_in(k2, 1)), m)
    ratio = np.sqrt(p / m) * torch.linalg.vector_norm(s.values, dim=1) / torch.linalg.vector_norm(diff, dim=1)
    assert 0.8 < float(torch.mean(ratio)) < 1.2
    assert float(torch.std(ratio)) < 0.15


# ------------------------------------------------------------ Cor. 2 and 3 --


def test_smoothing_cor2():
    """Cor. 2: after ROS, max |entry| of unit-norm samples ≲ √(2/η·log(2np/α)/p)."""
    n, p = 256, 512
    xj = jnp.zeros((n, p)).at[jnp.arange(n), jax.random.randint(KEY, (n,), 0, p)].set(1.0)
    y = ros.precondition(_t(xj), _kd(KEY), "hadamard")
    yj = jros.precondition(xj, KEY, "hadamard")
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-6)
    bound = bounds.ros_max_entry_bound(n, p, alpha=0.01)
    assert float(torch.max(torch.abs(y))) <= bound
    assert float(torch.max(torch.abs(y))) >= (1.0 - 1e-5) / np.sqrt(p)


def test_norm_reduction_cor3():
    """Cor. 3: after preconditioning, ‖w‖² ≈ (m/p)·‖x‖² up to log factors."""
    n, p, m = 128, 512, 64
    x = torch.zeros((n, p))
    x[:, 0] = 1.0
    y = ros.precondition(x, _kd(KEY), "hadamard")
    s = sampling.subsample(y, _kd(jax.random.PRNGKey(1)), m)
    ratios = torch.sum(s.values ** 2, dim=1) / torch.sum(x ** 2, dim=1)
    assert float(torch.max(ratios)) <= bounds.rho_bound(n, p, m, alpha=0.01)
    s0 = sampling.subsample(x, _kd(jax.random.PRNGKey(2)), m)
    r0 = torch.sum(s0.values ** 2, dim=1) / torch.sum(x ** 2, dim=1)
    assert set(np.unique(r0.numpy()).tolist()) <= {0.0, 1.0}


# ------------------------------------------------------ the K-means baselines --


@pytest.fixture(scope="module")
def blobs():
    return make_clusters(KEY, n=1500, p=128, k=5)


def _center_err(c, true):
    from scipy.optimize import linear_sum_assignment

    d = np.linalg.norm(np.asarray(c)[:, None, :] - np.asarray(true)[None, :, :], axis=-1)
    ri, ci = linear_sum_assignment(d)
    return float(d[ri, ci].mean())


def _same_result(mine, ref):
    assert np.array_equal(mine.assignments.numpy(), np.asarray(ref.assignments))
    np.testing.assert_allclose(mine.centers.numpy(), np.asarray(ref.centers), atol=1e-5, rtol=1e-5)
    assert int(mine.n_iter) == int(ref.n_iter)


@pytest.mark.parametrize("two_pass", [False, True])
def test_feature_extraction_center_inconsistency(blobs, two_pass):
    """Pseudo-inverse-lifted FE centers are far worse than sparsified centers
    (Fig. 9); the port's run equals the reference's."""
    x, labels, centers = blobs
    kw = dict(m=32, key=jax.random.PRNGKey(4), n_init=3, max_iter=50, two_pass=two_pass)
    ref = jkm.feature_extraction_kmeans(x, 5, **kw)
    fe = km.feature_extraction_kmeans(_t(x), 5, **dict(kw, key=_kd(kw["key"])))
    _same_result(fe, ref)
    sp = km.sparsified_kmeans(_t(x), 5, _kd(jax.random.PRNGKey(5)), gamma=0.25, n_init=3,
                              max_iter=50)
    assert km.clustering_accuracy(fe.assignments, np.asarray(labels), 5) > 0.9
    if not two_pass:
        assert _center_err(fe.centers, centers) > 3 * _center_err(sp.centers, centers)


@pytest.mark.parametrize("two_pass", [False, True])
def test_feature_selection_runs(blobs, two_pass):
    x, labels, _ = blobs
    kw = dict(m=32, key=jax.random.PRNGKey(6), n_init=3, max_iter=50, two_pass=two_pass)
    ref = jkm.feature_selection_kmeans(x, 5, **kw)
    fs = km.feature_selection_kmeans(_t(x), 5, **dict(kw, key=_kd(kw["key"])))
    _same_result(fs, ref)
    assert km.clustering_accuracy(fs.assignments, np.asarray(labels), 5) > 0.8


def test_leverage_scores_match():
    x, _, _ = make_clusters(jax.random.PRNGKey(2), n=300, p=64, k=4)
    key = jax.random.PRNGKey(8)
    got = km.leverage_scores(_t(x), 4, _kd(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(jkm.leverage_scores(x, 4, key)),
                               rtol=1e-4, atol=1e-7)
    assert abs(float(got.sum()) - 1.0) < 1e-5


# ------------------------------------------------------ the sketching pipeline --


def test_sketching_pipeline_matches_reference():
    """The pull-based pipeline's batches are the reference's bit for bit, and
    its state moves through JSON the same way."""
    p, b = 200, 16
    key = jax.random.PRNGKey(3)
    spec = sketch.make_spec(p, _kd(key), gamma=0.2)
    jspec = jsketch.make_spec(p, key, gamma=0.2)
    mine = pipeline.SketchingPipeline(pipeline.VectorStreamSource(p, b, seed=5), spec, device="cpu")
    ref = jpipeline.SketchingPipeline(jpipeline.VectorStreamSource(p, b, seed=5), jspec)
    for _ in range(3):
        s, r = mine.next_batch(), ref.next_batch()
        assert np.array_equal(s.indices.numpy(), np.asarray(r.indices))
        np.testing.assert_allclose(s.values.numpy(), np.asarray(r.values), atol=1e-6)
        assert mine.state.to_json() == ref.state.to_json()
    st = pipeline.PipelineState.from_json(ref.state.to_json())
    assert st == mine.state and st.to_json() == {"seed": 5, "step": 3}
    assert jpipeline.PipelineState.from_json(st.to_json()).to_json() == st.to_json()
