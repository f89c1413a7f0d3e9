"""Resume in repro_torch against repro on the CPU: the checkpoint protocol,
the state kinds' serialization and merge algebra, engine checkpoints carried
across the two packages in both directions, estimator and fused-run
checkpoints, refine over a restored state, and QueueSource.

Tolerances: inside the port, a restored run equals the uninterrupted one bit
for bit (as the reference asserts of itself). Across the packages, values
agree within 1e-5 relative (the reference's backend tolerance; the two
packages sum in other orders), counts, labels and reassignment counts are
equal. FD states are compared through BᵀB (the SVD's signs and rotations of
B's rows differ), within 1e-5 of its largest entry.
"""
import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import sketch as jsketch
from repro.lowrank import fd_init as jfd_init
from repro.lowrank import fd_update as jfd_update
from repro.lowrank import range_init as jrange_init
from repro.stream import accumulators as jacc
from repro.stream import state as jstate
from repro.stream.engine import StreamEngine as JEngine
from repro.stream.engine import StreamKMeansConfig as JKMeans
from repro.stream.queued import QueueSource as JQueue
from repro.train import checkpoint as jckpt
from repro_torch import api
from repro_torch import lowrank
from repro_torch.core import sketch
from repro_torch.stream import QueueSource, StreamEngine, StreamKMeansConfig
from repro_torch.stream import accumulators as acc
from repro_torch.stream import state as tstate
from repro_torch.train import checkpoint as tckpt
from repro_torch.utils import prng

P_DIM, B = 32, 24
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("repro_torch implements jax_threefry_partitionable=True only")


def _source(seed, step, shard):
    rng = np.random.default_rng([seed or 0, step, shard])
    return rng.normal(size=(B, P_DIM)).astype(np.float32)


def _specs(key=0, gamma=0.4):
    return (jsketch.make_spec(P_DIM, jax.random.PRNGKey(key), gamma=gamma),
            sketch.make_spec(P_DIM, prng.PRNGKey(key), gamma=gamma))


def _sketches(step, shard, key=0):
    jspec, spec = _specs(key)
    x = _source(0, step, shard)
    return (jsketch.sketch(x, jspec, batch_key=jsketch.batch_key(jspec, step, shard)),
            sketch.sketch(torch.from_numpy(x), spec, batch_key=sketch.batch_key(spec, step, shard)))


def _rel(a, b, tol=1e-5):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(b)), 1e-30), np.max(np.abs(a - b))


def _equal(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------------------------- the protocol --


def test_checkpoint_protocol_roundtrip(tmp_path):
    """save_arrays / load_arrays in the reference's layout: step directories,
    the latest pointer, keep_last, async writes; each package reads the
    other's checkpoints."""
    d = str(tmp_path / "ck")
    arrays = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": torch.tensor([1, 2, 3])}
    for step in range(5):
        tckpt.save_arrays(d, step, arrays, extra={"step": step}, keep_last=2)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == [
        "step_000000003", "step_000000004"]
    assert tckpt.latest_step_dir(d).endswith("step_000000004")
    for load in (tckpt.load_arrays, jckpt.load_arrays):
        got, extra = load(d)
        assert extra == {"step": 4}
        np.testing.assert_array_equal(got["a"], arrays["a"])
        np.testing.assert_array_equal(got["b"], np.array([1, 2, 3]))
    # the reference's checkpoint in the port, an async write waited for
    d2 = str(tmp_path / "ck2")
    jckpt.save_arrays(d2, 7, {"x": np.ones(4, np.int32)}, extra={"k": "v"})
    got, extra = tckpt.load_arrays(d2)
    assert extra == {"k": "v"} and got["x"].dtype == np.int32
    tckpt.save_arrays(d2, 8, {"x": np.zeros(2)}, async_=True)
    tckpt.wait_for_pending()
    assert jckpt.load_arrays(d2)[0]["x"].shape == (2,)
    with pytest.raises(FileNotFoundError):
        tckpt.load_arrays(str(tmp_path / "none"))
    assert tckpt.latest_step_dir(str(tmp_path / "none")) is None


def test_to_from_arrays_roundtrip_all_kinds():
    js, s = _sketches(0, 0)
    spec = _specs()[1]
    st_m = acc.moment_apply(acc.moment_init(spec.p_pad), acc.moment_delta(s))
    km0 = acc.kmeans_init(prng.PRNGKey(1), s, 3)
    st_k = acc.kmeans_apply(km0, acc.kmeans_delta(km0, s))
    st_f = lowrank.fd_update(lowrank.fd_init(spec.p_pad, 8), s)
    for st in (st_m, st_k, st_f, lowrank.range_init(spec.p_pad, 8)):
        back = tstate.from_arrays(tstate.to_arrays(st))
        assert type(back) is type(st)
        for f in tstate.kind_of(st).fields:
            assert torch.equal(getattr(st, f), getattr(back, f))
    # a mean-only MomentState drops sum_wwt and restores None
    arrs = tstate.to_arrays(acc.moment_init(spec.p_pad, track_cov=False))
    assert "moment.sum_wwt" not in arrs and tstate.from_arrays(arrs).sum_wwt is None
    assert tstate.from_arrays({}) is None
    assert tstate.from_arrays(tstate.to_arrays(st_k), kinds=("moment",)) is None
    # the reference's fd state in the port, and the port's in the reference
    jf = jfd_update(jfd_init(spec.p_pad, 8), js)
    tf = tstate.from_arrays(jstate.to_arrays(jf))
    assert isinstance(tf, lowrank.FDState)
    assert type(jstate.from_arrays(tstate.to_arrays(st_f))).__name__ == "FDState"
    with pytest.raises(TypeError, match="not a registered"):
        tstate.kind_of(object())


@pytest.mark.parametrize("kind", ["moment", "km", "range", "fd"])
def test_merge_matches_reference(kind):
    """merge() of two states folded from disjoint sub-streams, the port's
    against repro.stream.state.merge on the same folds."""
    (j1, t1), (j2, t2) = _sketches(0, 0), _sketches(0, 1)
    p_pad = _specs()[1].p_pad
    if kind == "moment":
        def fold_j(s):
            return jacc.moment_apply(jacc.moment_init(p_pad), jacc.moment_delta(s))

        def fold_t(s):
            return acc.moment_apply(acc.moment_init(p_pad), acc.moment_delta(s))
    elif kind == "km":
        jkm0 = jacc.kmeans_init(jax.random.PRNGKey(2), j1, 3)
        tkm0 = tstate.from_arrays(jstate.to_arrays(jkm0))

        def fold_j(s):
            return jacc.kmeans_apply(jkm0, jacc.kmeans_delta(jkm0, s))

        def fold_t(s):
            return acc.kmeans_apply(tkm0, acc.kmeans_delta(tkm0, s))
    elif kind == "range":
        jom = jax.numpy.asarray(np.random.default_rng(0).normal(size=(p_pad, 8)), jax.numpy.float32)
        tom = torch.from_numpy(np.asarray(jom))
        from repro.lowrank import range_update as jrange_update

        def fold_j(s):
            return jrange_update(jrange_init(p_pad, 8), s, jom)

        def fold_t(s):
            return lowrank.range_update(lowrank.range_init(p_pad, 8), s, tom)
    else:
        def fold_j(s):
            return jfd_update(jfd_init(p_pad, 8), s)

        def fold_t(s):
            return lowrank.fd_update(lowrank.fd_init(p_pad, 8), s)
    jm, tm = jstate.merge(fold_j(j1), fold_j(j2)), tstate.merge(fold_t(t1), fold_t(t2))
    ja, ta = jstate.to_arrays(jm), tstate.to_arrays(tm)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        if k == "fd.sketch":
            _rel(ta[k].T @ ta[k], ja[k].T @ ja[k])
        elif ja[k].dtype.kind in "iu" or k.endswith("count"):
            _equal(ta[k], ja[k])
        else:
            _rel(ta[k], ja[k])
    other = lowrank.range_init(p_pad, 8) if kind != "range" else acc.moment_init(p_pad)
    with pytest.raises(TypeError, match="cannot merge"):
        tstate.merge(fold_t(t1), other)


# ----------------------------------------------- engine checkpoint/restore --


def _engines(n_shards=2):
    jspec, spec = _specs()
    jeng = JEngine(jspec, _source, n_shards=n_shards,
                   kmeans=JKMeans(k=3, n_init=2, track_reassignments=True))
    teng = StreamEngine(spec, _source, n_shards=n_shards,
                        kmeans=StreamKMeansConfig(k=3, n_init=2, track_reassignments=True), **CPU)
    return jeng, teng


def _same_result(res, ref):
    assert int(res.count) == int(ref.count)
    for name in ("mean", "cov", "centers"):
        _rel(getattr(res, name), getattr(ref, name))
    _equal(res.reassign_total, ref.reassign_total)


def test_engine_checkpoint_restore_continue_bit_identical(tmp_path):
    """Stop at step 3 of 7 (checkpoints every 3 steps), restore the latest
    (step 6) in a fresh engine and continue: bit-identical to the
    uninterrupted run, reassignment totals included."""
    _, mk = _engines()
    full = mk.run(7, seed=5)
    _, eng = _engines()
    eng.run(7, seed=5, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    _, eng2 = _engines()
    state, next_step = eng2.restore_state(str(tmp_path))
    assert next_step == 6 and state.kmeans.centers.device.type == "cpu"
    res = eng2.run(7, seed=5, state=state, start_step=next_step)
    for name in ("mean", "cov", "centers"):
        assert torch.equal(getattr(res, name), getattr(full, name))
    np.testing.assert_array_equal(res.reassign_total, full.reassign_total)
    assert int(res.count) == int(full.count) == 7 * 2 * B
    with pytest.raises(ValueError, match="checkpoint_dir"):
        eng2.run(2, checkpoint_every=1)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_engine_checkpoint_crosses_packages(tmp_path, writer):
    """One package checkpoints at step 3 of 7; the other restores it and
    continues: its result matches the writer's uninterrupted run."""
    jeng, teng = _engines()
    jfull, tfull = jeng.run(7, seed=5), teng.run(7, seed=5)
    _same_result(tfull, jfull)   # the two uninterrupted runs agree
    jeng, teng = _engines()
    if writer == "repro":
        jeng.run(3, seed=5)
        jeng.save_state(str(tmp_path), 3, seed=5)
        state, next_step = teng.restore_state(str(tmp_path))
        res, want = teng.run(7, seed=5, state=state, start_step=next_step), jfull
    else:
        teng.run(3, seed=5)
        teng.save_state(str(tmp_path), 3, seed=5)
        state, next_step = jeng.restore_state(str(tmp_path))
        res, want = jeng.run(7, seed=5, state=state, start_step=next_step), tfull
    assert next_step == 3
    _same_result(res, want)


def test_engine_reassign_counts_from_run():
    """run() surfaces the per-step reassignment counts: (steps, n_init), their
    sum the running total, equal to the reference's."""
    jeng, teng = _engines()
    res, jres = teng.run(5, seed=1), jeng.run(5, seed=1)
    assert res.reassign_counts.shape == (5, 2)
    np.testing.assert_array_equal(res.reassign_counts.sum(0), res.reassign_total)
    np.testing.assert_array_equal(res.reassign_counts[-1], res.reassign_last)
    assert (res.reassign_counts <= 2 * B).all()
    np.testing.assert_array_equal(res.reassign_counts, jres.reassign_counts)


def test_engine_state_arrays_and_merge():
    """engine_to_arrays / engine_from_arrays round trip the tracked state,
    and engine_merge matches the reference's on the same two states."""
    jeng, teng = _engines()
    teng.run(3, seed=2)
    jeng.run(3, seed=2)
    arrs = tstate.engine_to_arrays(teng.state)
    assert "reassign/total" in arrs and "reassign/last" in arrs
    assert sorted(arrs) == sorted(jstate.engine_to_arrays(jeng.state))
    back = tstate.engine_from_arrays(arrs, **CPU)
    for k, v in tstate.engine_to_arrays(back).items():
        np.testing.assert_array_equal(v, arrs[k])
    merged = tstate.engine_to_arrays(tstate.engine_merge(teng.state, back))
    jm = jstate.engine_to_arrays(jstate.engine_merge(
        jeng.state, jstate.engine_from_arrays(jstate.engine_to_arrays(jeng.state))))
    for k in jm:
        if jm[k].dtype.kind in "iu":
            _equal(merged[k], jm[k])
        else:
            _rel(merged[k], jm[k])
    with pytest.raises(ValueError, match="one side only"):
        tstate.engine_merge(teng.state, dataclasses.replace(back, reassign=None))


# ------------------------------------------------- estimator crash recovery --


def _rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, P_DIM)).astype(np.float32)


@pytest.mark.parametrize("backend", ["batch", "stream"])
def test_estimator_checkpoint_restore_continue(backend, tmp_path):
    """Checkpoint after half the rows, restore into a fresh estimator and fold
    the rest: bit-identical to the uninterrupted fit. Then across the
    packages: the reference's checkpoint continues in the port to the
    reference's fit, and the port's in the reference to the port's."""
    x = _rows(8 * B, 0)
    plan = api.Plan(backend=backend, gamma=0.4, batch_size=B)
    jplan = japi.Plan(backend=backend, gamma=0.4, batch_size=B)
    ref = api.SparsifiedCov(plan, key=3, **CPU).fit(x)
    api.SparsifiedCov(plan, key=3, **CPU).partial_fit(x[:4 * B]).checkpoint(str(tmp_path / "t"))
    est = api.SparsifiedCov(plan, key=3, **CPU).restore(str(tmp_path / "t"))
    est.partial_fit(x[4 * B:]).finalize()
    assert torch.equal(est.cov_, ref.cov_) and torch.equal(est.mean_, ref.mean_)
    assert est.count_ == ref.count_ == 8 * B
    jref = japi.SparsifiedCov(jplan, key=3).fit(x)
    japi.SparsifiedCov(jplan, key=3).partial_fit(x[:4 * B]).checkpoint(str(tmp_path / "j"))
    est = api.SparsifiedCov(plan, key=3, **CPU).restore(str(tmp_path / "j"))
    _rel(est.partial_fit(x[4 * B:]).finalize().cov_, jref.cov_)
    back = japi.SparsifiedCov(jplan, key=3).restore(str(tmp_path / "t"))
    _rel(back.partial_fit(x[4 * B:]).finalize().cov_, ref.cov_.numpy())


def test_kmeans_minibatch_checkpoint_restore(tmp_path):
    """The K-means fold state and the reassignment history survive the round
    trip; continuation is bit-identical, and equals the reference's fit
    restored from the port's checkpoint."""
    x = _rows(8 * B, 1)
    plan = api.Plan(backend="stream", gamma=0.4, batch_size=B, n_shards=2)
    ref = api.SparsifiedKMeans(3, plan, key=5, algorithm="minibatch", **CPU).fit(x)
    est = api.SparsifiedKMeans(3, plan, key=5, algorithm="minibatch", **CPU)
    est.partial_fit(x[:4 * B]).checkpoint(str(tmp_path))
    est2 = api.SparsifiedKMeans(3, plan, key=5, algorithm="minibatch", **CPU)
    est2.restore(str(tmp_path)).partial_fit(x[4 * B:]).finalize()
    assert torch.equal(est2.centers_, ref.centers_)
    np.testing.assert_array_equal(est2.reassign_counts_, ref.reassign_counts_)
    jplan = japi.Plan(backend="stream", gamma=0.4, batch_size=B, n_shards=2)
    jest = japi.SparsifiedKMeans(3, jplan, key=5, algorithm="minibatch").restore(str(tmp_path))
    jest.partial_fit(x[4 * B:]).finalize()
    _rel(ref.centers_, jest.centers_)
    np.testing.assert_array_equal(ref.reassign_counts_, jest.reassign_counts_)


def test_refine_over_restored_state(tmp_path):
    """refine() on a restored estimator == refine() on the original, and the
    reference's refine of the same checkpoint agrees."""
    x = _rows(8 * B, 2)
    plan = api.Plan(backend="stream", gamma=0.5, batch_size=B)
    ref = api.SparsifiedKMeans(3, plan, key=7, algorithm="minibatch", **CPU).fit(x)
    ref.refine(x, passes=1)
    est = api.SparsifiedKMeans(3, plan, key=7, algorithm="minibatch", **CPU).fit(x)
    est.checkpoint(str(tmp_path))
    est2 = api.SparsifiedKMeans(3, plan, key=7, algorithm="minibatch", **CPU)
    est2.restore(str(tmp_path)).finalize()
    est2.refine(x, passes=1)
    assert torch.equal(est2.centers_, ref.centers_)
    assert est2.refine_passes_ == ref.refine_passes_ == 1
    jplan = japi.Plan(backend="stream", gamma=0.5, batch_size=B)
    jest = japi.SparsifiedKMeans(3, jplan, key=7, algorithm="minibatch")
    jest.restore(str(tmp_path)).finalize()
    jest.refine(x, passes=1)
    _rel(ref.centers_, jest.centers_)
    np.testing.assert_array_equal(ref.refine_reassign_counts_, jest.refine_reassign_counts_)


def test_fused_run_checkpoint_restore(tmp_path):
    """A SharedSketchRun checkpoints every consumer and the one shared cursor;
    restore_run resumes the pass bit-identically, and the reference's
    restore_run continues the port's checkpoint to the same result."""
    x = _rows(8 * B, 3)
    plan = api.Plan(backend="stream", gamma=0.4, batch_size=B)

    def mk():
        return [api.SparsifiedMean(plan, key=1, **CPU),
                api.SparsifiedKMeans(3, plan, key=1, algorithm="minibatch", **CPU)]

    ref = mk()
    api.fit_many(plan, ref, x)
    run = api.fit_many(plan, mk(), x[:4 * B], finalize=False)
    run.checkpoint(str(tmp_path))
    c2 = mk()
    run2 = api.restore_run(str(tmp_path), plan, c2)
    assert run2.count == 4 * B
    run2.partial_fit(x[4 * B:]).finalize()
    assert torch.equal(c2[0].mean_, ref[0].mean_) and torch.equal(c2[1].centers_, ref[1].centers_)
    with pytest.raises(ValueError, match="consumers"):
        api.restore_run(str(tmp_path), plan, [api.SparsifiedMean(plan, key=1, **CPU)])
    jplan = japi.Plan(backend="stream", gamma=0.4, batch_size=B)
    jc = [japi.SparsifiedMean(jplan, key=1),
          japi.SparsifiedKMeans(3, jplan, key=1, algorithm="minibatch")]
    japi.restore_run(str(tmp_path), jplan, jc).partial_fit(x[4 * B:]).finalize()
    _rel(ref[0].mean_, jc[0].mean_)
    _rel(ref[1].centers_, jc[1].centers_)


# ---------------------------------------------------------- QueueSource ----


def test_queue_source():
    """Push order maps to (step, shard); retain=False drops served chunks; a
    closed stream fails fast; the port's class behaves as the reference's."""
    for cls in (QueueSource, JQueue):
        q = cls(n_shards=2, timeout=5.0)
        chunks = [np.full((2, 3), i, np.float32) for i in range(5)]

        def produce():
            for c in chunks:
                q.push(c)

        t = threading.Thread(target=produce)
        t.start()
        assert q.batch_at(2, 0)[0, 0] == 4      # blocks until pushed
        t.join()
        assert q.batch_at(0, 1)[0, 0] == 1 and q.steps() == 2
        q.close()
        with pytest.raises(RuntimeError, match="past the end"):
            q.batch_at(2, 1)
        with pytest.raises(RuntimeError, match="after close"):
            q.push(chunks[0])
        once = cls(retain=False)
        once.push(chunks[0])
        once.batch_at(0, 0)
        with pytest.raises(RuntimeError, match="dropped"):
            once.batch_at(0, 0)
        with pytest.raises(ValueError):
            cls(n_shards=0)
    # an engine pulls the pushed chunks as the (seed, step, shard) contract
    q = QueueSource(n_shards=1)
    for step in range(2):
        q.push(_source(0, step, 0))
    q.close()
    spec = _specs()[1]
    res = StreamEngine(spec, q, **CPU).run(2)
    ref = StreamEngine(spec, _source, **CPU).run(2)
    assert torch.equal(res.cov, ref.cov)
