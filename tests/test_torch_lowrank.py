"""The low-rank streaming PCA path of repro_torch against the JAX reference, on
the CPU: ``normal`` and Ω, the plain versions of K3, K5 and K6, the
range-finder algebra, and ``make_engine(Plan(cov_path="lowrank"))`` end to end,
from scratch and from the reference's state carried across.

Tolerances, and why:

- Ω: ``prng.normal`` evaluates XLA's erfinv and log1p as XLA's CPU code does,
  with the multiply-adds its object code fuses, so its draws are bit-equal to
  JAX's where XLA fuses them (a host with FMA: probed, not assumed). Where it
  does not, ≥ 90 % of draws are bit-equal and all within 1e-6 relative.
- the plain transform against the reference's butterfly: 1e-6; against its
  three-pass Kronecker schedule in interpret mode: the reference's own 5e-4.
- sums (spmm, spmm_t, y, diag, sum_w, mean): 1e-5 relative to the largest
  entry — the sums run in another order in the two packages, and Ω differs by
  ≤ 1e-6.
- eigenvalues 1e-4 relative; components up to sign, |cos| ≥ 1 − 1e-4 (the
  sign of an eigenvector is the eigensolver's choice).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro import lowrank as jlowrank
from repro.core import ros as jros
from repro.core.sampling import SparseRows as JRows
from repro.data.pipeline import VectorStreamSource as JSource
from repro.kernels import fwht as jfwht
from repro.kernels import ref as jref
from repro.stream import StreamKMeansConfig as JKMeans
from repro.stream import state as jstate
from repro_torch import api, lowrank
from repro_torch.core.sampling import SparseRows
from repro_torch.data.pipeline import VectorStreamSource
from repro_torch.kernels import fwht, ops, ref
from repro_torch.stream import StreamKMeansConfig
from repro_torch.stream import state as tstate
from repro_torch.utils import prng

BATCH, STEPS, ELL = 64, 3, 16


@pytest.fixture
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("repro_torch implements jax_threefry_partitionable=True only")


def _kd(key):
    return np.asarray(jax.random.key_data(key))


def _xla_fuses_multiply_add() -> bool:
    """Whether XLA's CPU code on this host rounds a·b + c once (FMA): 1 + 2^-11
    + 2^-24 rounds to 1 + 2^-11 in float32, so only a fused a·a + c is not 0."""
    a = np.full(8, 1 + 2 ** -12, np.float32)
    c = np.full(8, -(1 + 2 ** -11), np.float32)
    return bool(np.asarray(jax.jit(lambda a, c: a * a + c)(a, c))[0] != 0)


def _draws_equal(got, want):
    """Bit-equal where XLA fuses multiply-adds as the port emulates; else
    ≥ 90 % bit-equal and all within 1e-6 relative."""
    assert got.dtype == np.float32 and got.shape == want.shape
    if _xla_fuses_multiply_add():
        np.testing.assert_array_equal(got, want)
    else:
        assert np.mean(got == want) >= 0.9
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _rel_close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(b)), 1e-30)


def _same_up_to_sign(a, b, tol=1e-4):
    """Rows of a and b are the same unit vectors up to sign."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = np.abs(np.sum(a * b, axis=1)) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert np.all(cos >= 1 - tol), cos


def _sparse(n, p, m, seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, m)).astype(np.float32)
    idx = np.sort(np.argsort(rng.random((n, p)), axis=1)[:, :m], axis=1).astype(np.int32)
    return vals, idx


# ------------------------------------------------------------- randomness --

@pytest.mark.parametrize("shape", [(1000,), (300, 16), (4, 5, 6)])
def test_normal_matches_jax(partitionable, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(7), len(shape))
    got = prng.normal(_kd(k), shape).numpy()
    _draws_equal(got, np.asarray(jax.random.normal(k, shape, jnp.float32)))


@pytest.mark.parametrize("p,ell", [(1024, 16), (65536, 8)])
def test_omega_matches_reference(partitionable, p, ell):
    k = jax.random.PRNGKey(3)
    got = lowrank.omega(_kd(k), p, ell).numpy()
    _draws_equal(got, np.asarray(jlowrank.omega(k, p, ell)))
    # drawn on the CPU, whatever the device asked for: bit-stable across calls
    np.testing.assert_array_equal(got, lowrank.omega(_kd(k), p, ell, device="cpu").numpy())


# ----------------------------------------------------- plain K3, K5, K6 ----

@pytest.mark.parametrize("p", [1 << 16, 1 << 17])
def test_chunked_transform_plain_matches_reference(p):
    rng = np.random.default_rng(p)
    x = rng.normal(size=(2, p)).astype(np.float32)
    s = np.where(rng.random(p) < 0.5, -1.0, 1.0).astype(np.float32)
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    got = fwht.hd_precondition_chunked(tx, ts)
    assert torch.equal(got, fwht.hd_precondition(tx, ts))      # dispatches to K3's path
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.ref_hd_precondition(x, s)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jfwht.hd_precondition_chunked(x, s, interpret=True)),
                               atol=5e-4)
    # the unmix direction: signs after the transform
    np.testing.assert_allclose(fwht.hd_precondition_chunked(tx, ts, signs_after=True).numpy(),
                               np.asarray(jros.fwht(x) * s[None, :]), rtol=1e-6, atol=1e-6)


def test_chunked_transform_ceiling():
    """Above 2^27 the transform raises on any device, as the reference does."""
    x = torch.zeros((1, 1)).expand(1, 1 << 28)
    with pytest.raises(ValueError, match="ceiling"):
        fwht.hd_precondition(x, torch.ones(1).expand(1 << 28))
    assert fwht.check_p(1 << 27, fwht.MAX_P) == 27


@pytest.mark.parametrize("n,p,m,ell", [(50, 512, 24, 16), (7, 1024, 100, 13), (1, 64, 64, 128)])
def test_spmm_plain_matches_reference(n, p, m, ell):
    vals, idx = _sparse(n, p, m, seed=n + ell)
    dense = np.random.default_rng(ell).normal(size=(p, ell)).astype(np.float32)
    tv, ti, td = (torch.from_numpy(a) for a in (vals, idx, dense))
    t = ref.ref_spmm(tv, ti, td)
    _rel_close(t, jref.ref_spmm(vals, idx, dense))
    _rel_close(ref.ref_spmm_t(tv, ti, t, p), jref.ref_spmm_t(vals, idx, t.numpy(), p))
    # the wrappers and the dispatch layer take the plain versions on the CPU
    assert torch.equal(ops.spmm(tv, ti, td), t)
    assert torch.equal(ops.spmm_t(tv, ti, t, p), ref.ref_spmm_t(tv, ti, t, p))
    # the column sums K6 gives beside Y: the range-finder's sum_w and diag
    y, sv, sv2 = ops.spmm_t(tv, ti, t, p, col_sums=True)
    assert torch.equal(y, ref.ref_spmm_t(tv, ti, t, p))
    want_sv, want_sv2 = np.zeros(p), np.zeros(p)
    np.add.at(want_sv, idx.reshape(-1), vals.reshape(-1).astype(np.float64))
    np.add.at(want_sv2, idx.reshape(-1), vals.reshape(-1).astype(np.float64) ** 2)
    _rel_close(sv, want_sv.astype(np.float32))
    _rel_close(sv2, want_sv2.astype(np.float32))


def test_spmm_promotion_rule():
    """Operands promote jointly; the output is at least float32 (as the reference)."""
    vals, idx = _sparse(9, 128, 8, seed=1)
    dense = np.random.default_rng(2).normal(size=(128, 4)).astype(np.float32)
    tv16 = torch.from_numpy(vals).to(torch.bfloat16)
    jv16 = jnp.asarray(vals, jnp.bfloat16)
    got = ref.ref_spmm(tv16, torch.from_numpy(idx), torch.from_numpy(dense))
    want = jref.ref_spmm(jv16, idx, dense)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _rel_close(got, want)
    t16 = got.to(torch.bfloat16)
    got_t = ref.ref_spmm_t(tv16, torch.from_numpy(idx), t16, 128)
    want_t = jref.ref_spmm_t(jv16, idx, jnp.asarray(t16.float().numpy(), jnp.bfloat16), 128)
    assert got_t.dtype == torch.float32 and want_t.dtype == jnp.float32
    _rel_close(got_t, want_t)
    assert ref.spmm_out_dtype(torch.float64, torch.float32) == torch.float64


# --------------------------------------------------- range-finder algebra --

def test_range_delta_matches_reference():
    p, m, n = 512, 40, 96
    vals, idx = _sparse(n, p, m, seed=5)
    om = np.array(jlowrank.omega(jax.random.PRNGKey(1), p, ELL))
    jd = jlowrank.range_delta(JRows(jnp.asarray(vals), jnp.asarray(idx), p), om, impl="ref")
    td = lowrank.range_delta(SparseRows(torch.from_numpy(vals), torch.from_numpy(idx), p),
                             torch.from_numpy(om))
    for f in ("y", "diag", "sum_w"):
        _rel_close(getattr(td, f), getattr(jd, f))
    assert int(td.count) == int(jd.count) == n and td.count.dtype == torch.int32
    two = lowrank.range_apply(td, td)
    assert int(two.count) == 2 * n and torch.equal(two.y, 2 * td.y)


def _spiked_state(p=512, m=128, steps=4):
    """A reference RangeState over rows with 4 planted directions."""
    src = JSource(p=p, batch=256, seed=2, k=4)
    om = jlowrank.omega(jax.random.PRNGKey(1), p, ELL)
    st = jlowrank.range_init(p, ELL)
    for step in range(steps):
        x = src.batch_at(step)
        rng = np.random.default_rng(step)
        idx = np.sort(np.argsort(rng.random(x.shape), axis=1)[:, :m], axis=1).astype(np.int32)
        vals = np.take_along_axis(x, idx, axis=1)
        st = jlowrank.range_update(st, JRows(jnp.asarray(vals), jnp.asarray(idx), p), om,
                                   impl="ref")
    return st, om, m


def _to_torch_range(st):
    return tstate.from_arrays(jstate.to_arrays(st))


def test_range_finalize_matches_reference():
    st, om, m = _spiked_state()
    want = jlowrank.range_finalize(st, m, om)
    tst = _to_torch_range(st)
    assert isinstance(tst, lowrank.RangeState) and tst.nbytes() == st.nbytes()
    got = lowrank.range_finalize(tst, m, torch.from_numpy(np.array(om)))
    assert got.rank == want.rank == ELL // 2
    np.testing.assert_allclose(got.eigenvalues.numpy()[:4], np.asarray(want.eigenvalues)[:4],
                               rtol=1e-4)
    _same_up_to_sign(got.components_pre[:4], want.components_pre[:4])
    comps, evals = got.top(3)
    assert comps.shape == (3, 512) and torch.equal(evals, got.eigenvalues[:3])
    with pytest.raises(ValueError, match="rank"):
        got.top(ELL)
    assert got.nbytes() == want.nbytes()
    _rel_close(lowrank.range_finalize_mean(tst, m), jlowrank.range_finalize_mean(st, m))


def test_eig_in_basis_matches_reference():
    rng = np.random.default_rng(9)
    p, ell = 300, 12
    q = np.linalg.qr(rng.normal(size=(p, ell)))[0].astype(np.float32)
    a = rng.normal(size=(ell, ell))
    core = (a @ a.T + np.diag(np.arange(ell) * 5.0)).astype(np.float32)
    d = np.abs(rng.normal(size=p)).astype(np.float32)
    want = jlowrank.eig_in_basis(q, core, scale=0.5, diag_s=d, corr=0.3)
    got = lowrank.eig_in_basis(torch.from_numpy(q), torch.from_numpy(core), scale=0.5,
                               diag_s=torch.from_numpy(d), corr=0.3)
    np.testing.assert_allclose(got.eigenvalues.numpy(), np.asarray(want.eigenvalues),
                               rtol=1e-4, atol=1e-5)
    _same_up_to_sign(got.components_pre, want.components_pre)
    np.testing.assert_allclose(got.dense().numpy(), np.asarray(want.dense()), atol=1e-4)


def test_fd_is_not_ported():
    """Frequent Directions is ported (tests/test_torch_fd.py holds it against
    the reference): the names the package exports build and fold a sketch."""
    st = lowrank.fd_init(64, 8)
    assert st.sketch.shape == (8, 64) and int(st.count) == 0
    rng = np.random.default_rng(0)
    idx = np.sort(np.argsort(rng.random((5, 64)), axis=1)[:, :4], axis=1).astype(np.int32)
    from repro_torch.core.sampling import SparseRows

    st = lowrank.fd_update(st, SparseRows(torch.from_numpy(rng.normal(size=(5, 4)).astype(
        np.float32)), torch.from_numpy(idx), 64))
    assert int(st.count) == 5 and lowrank.fd_finalize(st, 4).rank == 8


# ------------------------------------------------------------ the engine ---

def _engines(p, gamma):
    jplan = japi.Plan(backend="stream", gamma=gamma, batch_size=BATCH, cov_path="lowrank",
                      rank=ELL)
    jeng = japi.make_engine(jplan, p, jax.random.PRNGKey(3), JSource(p=p, batch=BATCH, seed=0),
                            kmeans=JKMeans(k=4, n_init=2))
    plan = api.Plan(backend="stream", gamma=gamma, batch_size=BATCH, cov_path="lowrank",
                    rank=ELL)
    teng = api.make_engine(plan, p, prng.PRNGKey(3), VectorStreamSource(p=p, batch=BATCH, seed=0),
                           kmeans=StreamKMeansConfig(k=4, n_init=2), device="cpu")
    return jeng, teng


def _assert_lowrank_match(res, jres, top=4):
    assert int(res.count) == int(jres.count) == STEPS * BATCH
    assert res.cov is None and jres.cov is None
    _rel_close(res.mean, jres.mean)
    np.testing.assert_allclose(res.centers_pre.numpy(), np.asarray(jres.centers_pre),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.centers.numpy(), np.asarray(jres.centers), rtol=1e-4, atol=1e-4)
    ev, jev = res.cov_lowrank.eigenvalues.numpy(), np.asarray(jres.cov_lowrank.eigenvalues)
    assert ev.shape == jev.shape == (ELL // 2,)
    np.testing.assert_allclose(ev[:top], jev[:top], rtol=1e-4)
    _same_up_to_sign(res.cov_lowrank.components_pre[:top], jres.cov_lowrank.components_pre[:top])


@pytest.mark.parametrize("p,gamma", [(1000, 0.1), (40000, 0.05)])
def test_lowrank_engine_matches_reference(partitionable, p, gamma):
    jeng, teng = _engines(p, gamma)
    jres, res = jeng.run(STEPS), teng.run(STEPS)
    _assert_lowrank_match(res, jres)
    a, b = tstate.engine_to_arrays(teng.state), jstate.engine_to_arrays(jeng.state)
    assert sorted(a) == sorted(b) and "lowrank/range.y" in a and not any("moment" in k for k in a)
    np.testing.assert_array_equal(a["lowrank/range.count"], b["lowrank/range.count"])
    np.testing.assert_array_equal(a["kmeans/km.counts"], b["kmeans/km.counts"])
    for f in ("y", "diag", "sum_w"):
        _rel_close(a[f"lowrank/range.{f}"], b[f"lowrank/range.{f}"])
    # the PCA consumer's slice, unmixed to the original domain
    from repro.core import sketch as jsketch
    from repro_torch.core import sketch

    comps = sketch.unmix_dense(res.cov_lowrank.top(4)[0], teng.spec)
    jcomps = jsketch.unmix_dense(jres.cov_lowrank.top(4)[0], jeng.spec)
    assert comps.shape == (4, p)
    _same_up_to_sign(comps, jcomps)


def test_lowrank_engine_continues_reference_state(partitionable):
    """The reference's step-1 state (RangeState + K-means) written with
    to_arrays loads into the port and continues to the reference's result."""
    jeng, teng = _engines(1000, 0.1)
    jres = jeng.run(STEPS)
    j1 = jeng.update(jeng.init_state(), jeng._host_global_batch(None, 0), 0)
    state1 = tstate.engine_from_arrays(jstate.engine_to_arrays(j1), device="cpu")
    assert isinstance(state1.lowrank, lowrank.RangeState) and state1.moments is None
    _assert_lowrank_match(teng.run(STEPS, state=state1, start_step=1), jres)


def test_lowrank_engine_validation():
    src = VectorStreamSource(p=64, batch=8)
    plan = api.Plan(backend="stream", gamma=0.25, batch_size=8, cov_path="lowrank", rank=4)
    with pytest.raises(ValueError, match="fd"):
        api.make_engine(plan.replace(lowrank_method="fd"), 64, 0, src, device="cpu")
    from repro_torch.stream import StreamEngine

    spec = plan.spec(64, prng.PRNGKey(0))
    with pytest.raises(ValueError, match="rank"):
        StreamEngine(spec, src, cov_path="lowrank", rank=65, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        StreamEngine(spec, src, cov_path="lowrank", device="cpu")
    # track_cov=False falls back to the mean-only moments, as the reference does
    eng = api.make_engine(plan, 64, 0, src, track_cov=False, device="cpu")
    res = eng.run(2)
    assert eng.state.lowrank is None and eng.state.moments.sum_wwt is None
    assert res.cov is None and res.cov_lowrank is None and int(res.count) == 16
    # the low-rank state is O(l·p): (l + 3)·p floats and the count
    eng = api.make_engine(plan, 64, 0, src, device="cpu")
    eng.run(2)
    assert eng.state.lowrank.nbytes() <= (4 + 3) * 64 * 4 + 4
