"""Frequent Directions in repro_torch against repro.lowrank.fd on the CPU: the
sketch update and finalize, Liberty's deterministic guarantee, the
estimators' ``lowrank_method="fd"`` path, and the FD merge.

Tolerances: B's rows differ between the packages by signs and rotations (two
SVDs), so BᵀB is compared, within 1e-4 of its largest entry after a dozen
sequential float32 SVD-shrinks (each shrink re-rounds the sketch; a single
shrink agrees to 1e-5); diag, Σw and the Thm-4 mean within 1e-5 relative and
the count exactly (the side sums are exact column sums); finalized
eigenvalues within 1e-4 relative and their subspace within a principal-angle
sine of 1e-4. Inside the port the batch and stream backends fold FD in the
same order and agree bit for bit, as the reference's do.
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro import lowrank as jlr
from repro.core import sketch as jsketch
from repro.stream import state as jstate
from repro_torch import api
from repro_torch import lowrank as lr
from repro_torch.core import sketch
from repro_torch.core.sampling import SparseRows
from repro_torch.data.pipeline import VectorStreamSource
from repro_torch.stream import state as tstate
from repro_torch.utils import prng
from tests.conftest import spiked as _spiked
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

CPU = dict(device="cpu")



def spiked(n, p, k, **kw):
    return np.asarray(_spiked(jax.random.PRNGKey(0), n, p, k, **kw), np.float32)


def _rel(a, b, tol):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
    assert err <= tol, err


def _sine(a, b) -> float:
    qa = np.linalg.qr(np.asarray(a, np.float64).T)[0]
    qb = np.linalg.qr(np.asarray(b, np.float64).T)[0]
    return float(np.linalg.norm(qb - qa @ (qa.T @ qb), 2))


def _folds(p=32, m=16, ell=12, chunks=6, rows=50):
    """The same sketches folded by both packages' fd_update."""
    jspec = jsketch.make_spec(p, jax.random.PRNGKey(2), m=m)
    spec = sketch.make_spec(p, prng.PRNGKey(2), m=m)
    x = spiked(chunks * rows, p, 3, noise=0.05)
    jst, st, parts = jlr.fd_init(jspec.p_pad, ell), lr.fd_init(spec.p_pad, ell), []
    for i in range(chunks):
        xi = x[i * rows:(i + 1) * rows]
        js = jsketch.sketch(xi, jspec, batch_key=jsketch.batch_key(jspec, i, 0))
        s = sketch.sketch(torch.from_numpy(xi), spec, batch_key=sketch.batch_key(spec, i, 0))
        np.testing.assert_array_equal(s.indices.numpy(), np.asarray(js.indices))
        jst, st = jlr.fd_update(jst, js), lr.fd_update(st, s)
        parts.append(s)
    return jst, st, parts, spec


def test_fd_update_matches_reference():
    jst, st, _, _ = _folds()
    b, jb = st.sketch.double().numpy(), np.asarray(jst.sketch, np.float64)
    assert b.shape == jb.shape == (12, 32)
    _rel(b.T @ b, jb.T @ jb, 1e-4)
    _rel(st.diag, jst.diag, 1e-5)
    _rel(st.sum_w, jst.sum_w, 1e-5)
    assert int(st.count) == int(jst.count) == 300
    _rel(lr.fd_finalize_mean(st, 16), jlr.fd_finalize_mean(jst, 16), 1e-5)
    # a single shrink from the same state agrees more closely
    one_j = jlr.fd_init(64, 8)
    one_t = lr.fd_init(64, 8)
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(20, 6)).astype(np.float32)
    idx = np.sort(np.argsort(rng.random((20, 64)), axis=1)[:, :6], axis=1).astype(np.int32)
    from repro.core.sampling import SparseRows as JRows

    bj = np.asarray(jlr.fd_update(one_j, JRows(jax.numpy.asarray(vals),
                                               jax.numpy.asarray(idx), 64)).sketch, np.float64)
    bt = lr.fd_update(one_t, SparseRows(torch.from_numpy(vals), torch.from_numpy(idx),
                                        64)).sketch.double().numpy()
    _rel(bt.T @ bt, bj.T @ bj, 1e-5)


def test_fd_finalize_matches_reference():
    jst, st, _, _ = _folds()
    got, want = lr.fd_finalize(st, 16), jlr.fd_finalize(jst, 16)
    ev, jev = got.eigenvalues.numpy(), np.asarray(want.eigenvalues)
    assert ev.shape == jev.shape == (12,)
    _rel(ev[:3], jev[:3], 1e-4)
    assert _sine(got.components_pre[:3], want.components_pre[:3]) <= 1e-4
    with pytest.raises(ValueError, match="m >= 2"):
        lr.fd_finalize(st, 1)


def test_fd_deterministic_guarantee():
    """Liberty's bound in the port: 0 ≼ S − BᵀB ≼ (‖A‖_F²/(l−k))·I."""
    _, st, parts, spec = _folds()
    w = np.concatenate([s.to_dense().double().numpy() for s in parts])
    gap = np.linalg.eigvalsh(w.T @ w - st.sketch.double().numpy().T @ st.sketch.double().numpy())
    fro2 = float(np.sum(w ** 2))
    assert gap.min() > -1e-2 * fro2 / 12
    assert gap.max() <= fro2 / (12 - 3) + 1e-3 * fro2


def test_fd_merge_keeps_the_guarantee_and_matches_reference():
    """Merging two halves' sketches (append, shrink back to l) keeps FD's
    bound for the union and equals the reference's merge."""
    jst_a, st_a, parts_a, _ = _folds(chunks=3)
    # the second half: other rows under other chunk keys
    jspec = jsketch.make_spec(32, jax.random.PRNGKey(2), m=16)
    spec = sketch.make_spec(32, prng.PRNGKey(2), m=16)
    x = spiked(300, 32, 3, noise=0.05)[150:]
    jb, tb, parts_b = jlr.fd_init(jspec.p_pad, 12), lr.fd_init(spec.p_pad, 12), []
    for i in range(3):
        xi = x[i * 50:(i + 1) * 50]
        jb = jlr.fd_update(jb, jsketch.sketch(xi, jspec,
                                              batch_key=jsketch.batch_key(jspec, 10 + i, 0)))
        s = sketch.sketch(torch.from_numpy(xi), spec, batch_key=sketch.batch_key(spec, 10 + i, 0))
        tb = lr.fd_update(tb, s)
        parts_b.append(s)
    merged, jmerged = tstate.merge(st_a, tb), jstate.merge(jst_a, jb)
    assert merged.sketch.shape == (12, 32) and int(merged.count) == 300
    b, jbm = merged.sketch.double().numpy(), np.asarray(jmerged.sketch, np.float64)
    _rel(b.T @ b, jbm.T @ jbm, 1e-4)
    _rel(merged.diag, jmerged.diag, 1e-5)
    w = np.concatenate([s.to_dense().double().numpy() for s in parts_a + parts_b])
    gap = np.linalg.eigvalsh(w.T @ w - b.T @ b)
    fro2 = float(np.sum(w ** 2))
    assert gap.min() > -1e-2 * fro2 / 12 and gap.max() <= fro2 / (12 - 3) + 1e-3 * fro2
    with pytest.raises(ValueError, match="widths"):
        tstate.merge(st_a, lr.fd_init(32, 8))


def test_fd_pca_estimator_matches_reference():
    """SparsifiedPCA(Plan(cov_path="lowrank", lowrank_method="fd")): batch and
    stream bit-identical (a ragged last chunk included), near the dense PCA
    as the reference test asks of FD (subspace sine < 5e-2, eigenvalues 30 %),
    and the reference's fit."""
    p, k, n, ell = 64, 4, 2150, 32
    x = spiked(n, p, k)
    dense = api.SparsifiedPCA(k, api.Plan(gamma=0.5, batch_size=200), key=3, **CPU).fit(x)
    fits = {}
    for backend in ("batch", "stream"):
        plan = api.Plan(backend=backend, gamma=0.5, batch_size=200, cov_path="lowrank",
                        rank=ell, lowrank_method="fd")
        est = api.SparsifiedPCA(k, plan, key=3, **CPU).fit(x)
        assert est.count_ == n and isinstance(est._reducer.state, lr.FDState)
        assert est.components_.shape == (k, p) and est.cov_lowrank_.rank == ell
        assert _sine(est.components_, dense.components_) < 5e-2
        np.testing.assert_allclose(est.explained_variance_.numpy(),
                                   dense.explained_variance_.numpy(), rtol=0.3)
        fits[backend] = est
    assert torch.equal(fits["stream"].components_, fits["batch"].components_)
    jplan = japi.Plan(backend="stream", gamma=0.5, batch_size=200, cov_path="lowrank",
                      rank=ell, lowrank_method="fd")
    ref = japi.SparsifiedPCA(k, jplan, key=3).fit(x)
    _rel(fits["stream"].explained_variance_, ref.explained_variance_, 1e-4)
    assert _sine(fits["stream"].components_, ref.components_) <= 1e-4
    # the reference's FD state continues in the port
    half = japi.SparsifiedPCA(k, jplan, key=3).partial_fit(x[:1000])
    est = api.SparsifiedPCA(k, api.Plan(backend="stream", gamma=0.5, batch_size=200,
                                        cov_path="lowrank", rank=ell, lowrank_method="fd"),
                            key=3, **CPU)
    est._cursor.ensure_spec(p)
    est.load_state_arrays(half.state_arrays())
    est._cursor.chunk = half._cursor.chunk
    est.partial_fit(x[1000:]).finalize()
    _rel(est.explained_variance_, ref.explained_variance_, 1e-4)


@pytest.mark.parametrize("gamma", [0.05, 0.5])
def test_fd_on_the_planted_model_matches_reference(gamma):
    """FD on 1024 rows of the planted source at full width (p = 16384, l =
    32), in both packages: the same eigenvalues (1e-4 relative) and the same
    best |cos| of each planted direction with the top 8 (1e-3). At γ = 0.05 a
    row adds ≈ γ²λ₁² = 0.25 along the strongest planted direction while each
    shrink takes a kept row's ≈ γ‖x‖² ≈ 20 from every direction, so both lose
    the model: the top-8 subspace is off the planted one (sine > 0.9) and the
    largest eigenvalue below a fifth of λ₁² = 100. At γ = 0.5 both find the
    five strongest directions (|cos| > 0.9)."""
    p = 16384
    src = VectorStreamSource(p=p, batch=1024, seed=0)
    x = src.batch_at(0)
    u = src._u.astype(np.float64)
    kw = dict(gamma=gamma, batch_size=1024, cov_path="lowrank", lowrank_method="fd", rank=32)
    ref = japi.SparsifiedPCA(8, japi.Plan(**kw), key=1).fit(x)
    est = api.SparsifiedPCA(8, api.Plan(**kw), key=1, **CPU).fit(x)
    _rel(est.explained_variance_, ref.explained_variance_, 1e-4)
    cos = np.abs(est.components_.double().numpy() @ u).max(axis=0)
    cos_ref = np.abs(np.asarray(ref.components_, np.float64) @ u).max(axis=0)
    np.testing.assert_allclose(cos, cos_ref, atol=1e-3)
    if gamma < 0.1:
        for comps, ev in ((est.components_.numpy(), est.explained_variance_.numpy()),
                          (np.asarray(ref.components_), np.asarray(ref.explained_variance_))):
            assert _sine(comps, u.T) > 0.9 and ev[0] < 0.2 * src._lam[0] ** 2
    else:
        assert cos[:5].min() > 0.9 and cos_ref[:5].min() > 0.9
