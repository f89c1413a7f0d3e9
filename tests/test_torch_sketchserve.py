"""repro_torch.sketchserve — the port's sketch service — on the CPU.

Served answers against the port's own direct fits (bit for bit: requests in
batch_size multiples keep fit(x)'s chunk boundaries), the port's service
against the reference's for the same requests and key, snapshots within the
port and across the two packages in both directions, the worker pool, tensor
ingest, admission control, eviction with lazy restore, refinement through
the service, the serve.* metrics, and the launcher's crash-and-resume.

Tolerances (tests/test_torch_api.py's): against the reference, means,
covariances and centers 1e-5, eigenvalues 1e-5 relative, eigenvectors 1e-5
after sign alignment, labels equal; within the port, bits.
"""
import os
import queue
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.sketchserve as jserve
from repro_torch import obs
from repro_torch.api import Plan, SparsifiedMean, SparsifiedPCA, fit_many
from repro_torch.sketchserve import (ESTIMATORS, AdminRequest, QueryRequest, SketchService,
                                     restore_service)
from repro_torch.sketchserve.snapshot import plan_from_json, plan_to_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 32
BS = 64
CPU = dict(device="cpu")
TIMEOUT = 60


@pytest.fixture(autouse=True)
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("repro_torch implements jax_threefry_partitionable=True only")


def _kw(**kw):
    base = dict(backend="stream", gamma=0.5, batch_size=BS)
    base.update(kw)
    return base


def _plan(**kw):
    return Plan(**_kw(**kw))


def _jplan(**kw):
    return japi.Plan(**_kw(**kw))


def _x(n=256, p=P, seed=0):
    """Planted rows with a well-separated spectrum (eigenvectors stable
    across sum orders), from numpy."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(p, 3)))
    z = rng.normal(size=(n, 3)) * np.array([9.0, 5.0, 2.5])
    return (z @ u.T + 0.05 * rng.normal(size=(n, p))).astype(np.float32)


def _clusters(n=256, p=P, k=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, p)) * 3.0
    return (centers[rng.integers(0, k, n)] + 0.5 * rng.normal(size=(n, p))).astype(np.float32)


def _aligned(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a * np.sign(np.sum(a * b, axis=1, keepdims=True))


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _same_components(got, want):
    _close(got["explained_variance"], want["explained_variance"])
    _close(_aligned(got["components"], want["components"]), want["components"])


def _drain(svc):
    """Serve everything queued through one worker sweep (an unstarted
    service: deterministic micro-batch contents)."""
    items = []
    while True:
        try:
            items.append(svc._queue.get_nowait())
        except queue.Empty:
            break
    svc._process(items)


# the four estimator kinds, each with a plan its query reads
KINDS = [
    ("mean", {}, "mean", "mean_", {}),
    ("cov", {}, "cov", "cov_", {}),
    ("pca", {"n_components": 3}, "components", None, dict(cov_path="lowrank", rank=12)),
    ("kmeans", {"k": 3}, "centers", "centers_", {}),
]


# ------------------------------------------------------------ fit parity ----


@pytest.mark.parametrize("kind,params,op,attr,plan_kw", KINDS, ids=[k[0] for k in KINDS])
def test_served_tenant_matches_direct_fit(kind, params, op, attr, plan_kw):
    """Queue → coalesce → fold → lazy finalize ends bit-identical to the
    port's direct fit of the same rows, plan and key."""
    x = _x(256) if kind != "kmeans" else _clusters(256)
    plan = _plan(**plan_kw)
    direct = ESTIMATORS[kind](plan=plan, key=3, **CPU, **params).fit(x)
    with SketchService(**CPU) as svc:
        svc.create_tenant("t", kind, plan=plan, key=3, **params)
        futs = [svc.ingest("t", x[i:i + 2 * BS]) for i in range(0, 256, 2 * BS)]
        assert all(f.result(TIMEOUT).ok for f in futs)
        got = svc.query("t", op).unwrap()
        if kind == "kmeans":
            labels = svc.query("t", "predict", x[:32]).unwrap()
            assert np.array_equal(labels, direct.predict(x[:32]).numpy())
        if kind == "pca":
            proj = svc.query("t", "transform", x[:8]).unwrap()
            assert np.array_equal(proj, direct.transform(x[:8]).numpy())
    if kind == "pca":
        assert np.array_equal(got["components"], direct.components_.numpy())
        assert np.array_equal(got["explained_variance"], direct.explained_variance_.numpy())
    else:
        assert np.array_equal(got, getattr(direct, attr).numpy())


@pytest.mark.parametrize("kind,params,op,attr,plan_kw", KINDS, ids=[k[0] for k in KINDS])
def test_service_matches_reference_service(kind, params, op, attr, plan_kw):
    """The same requests and key through the reference's service and the
    port's: answers within the front door's tolerances, labels equal, and the
    stats (rows, chunks, sketches, finalizes, state bytes) equal."""
    x = _x(256) if kind != "kmeans" else _clusters(256)
    if kind == "kmeans":
        params = dict(params, algorithm="minibatch")
    answers = []
    for mod, plan in ((jserve, _jplan(**plan_kw)), (None, _plan(**plan_kw))):
        svc = (jserve.SketchService(scan="never") if mod is jserve
               else SketchService(**CPU))
        with svc:
            svc.create_tenant("t", kind, plan=plan, key=5, group="g", **params)
            futs = [svc.ingest("g", x[i:i + BS]) for i in range(0, 256, BS)]
            assert all(f.result(TIMEOUT).ok for f in futs)
            ans = {"main": svc.query("t", op).unwrap()}
            if kind == "kmeans":
                ans["labels"] = svc.query("t", "predict", x[:64]).unwrap()
            ans["stats"] = svc.query("t", "stats").unwrap()
            answers.append(ans)
    ref, got = answers
    if kind == "pca":
        _same_components(got["main"], ref["main"])
    else:
        _close(got["main"], ref["main"])
    if kind == "kmeans":
        assert np.array_equal(got["labels"], np.asarray(ref["labels"]))
    assert got["stats"] == ref["stats"]


# ------------------------------------------------------- groups and ingest --


def test_group_shares_one_pass_and_tensor_ingest():
    """Co-registered tenants ride one cursor (one sketch a chunk) and equal
    their fit_many twins; a tensor ingest folds the same bits as numpy."""
    x = _x(256)
    plan = _plan(cov_path="lowrank", rank=12)
    results = []
    for rows in (x, torch.from_numpy(x)):
        with SketchService(**CPU) as svc:
            svc.create_tenant("p", "pca", plan=plan, key=7, n_components=3, group="g")
            svc.create_tenant("k", "kmeans", plan=_plan(), key=7, k=3, group="g",
                              algorithm="minibatch")
            assert svc.ingest("g", rows[:BS]).result(TIMEOUT).ok
            assert svc.ingest("g", rows[BS:]).result(TIMEOUT).ok
            st = svc.query("p", "stats").unwrap()
            assert st["n_sketches"] == st["chunks"] == 4
            results.append((svc.query("p", "components").unwrap()["components"],
                            svc.query("k", "centers").unwrap()))
    pca = SparsifiedPCA(3, plan, key=7, **CPU)
    km = ESTIMATORS["kmeans"](3, _plan(), key=7, algorithm="minibatch", **CPU)
    fit_many(plan, [pca, km], x)
    for comps, centers in results:
        assert np.array_equal(comps, pca.components_.numpy())
        assert np.array_equal(centers, km.centers_.numpy())


def test_coalesced_mixed_blocks_fold_like_one_block():
    """A coalesced run of numpy and tensor blocks folds as their
    concatenation does; a mismatched width answers errors and the worker
    lives on."""
    x = _x(3 * BS)
    svc = SketchService(**CPU)
    svc.create_tenant("t", "mean", plan=_plan(), key=1)
    futs = [svc.ingest("t", x[:BS]), svc.ingest("t", torch.from_numpy(x[BS:2 * BS])),
            svc.ingest("t", x[2 * BS:].astype(np.float64))]
    _drain(svc)
    assert all(f.result(0).ok and f.result(0).info["coalesced"] == 3 for f in futs)
    assert svc.stats["ingest_folds"] == 1
    bad = [svc.ingest("t", x[:4]), svc.ingest("t", torch.zeros((4, P)))]
    _drain(svc)
    assert all(f.result(0).ok for f in bad)
    with svc:
        got = svc.query("t", "mean").unwrap()
    want = SparsifiedMean(_plan(), key=1, **CPU).fit(np.concatenate([x, x[:4], np.zeros((4, P),
                                                                              np.float32)]))
    assert np.array_equal(got, want.mean_.numpy())


def test_workers_four_against_one_per_group():
    n_groups, plan = 6, _plan(cov_path="lowrank", rank=12)
    blocks = [(f"g{r % n_groups}", _x(BS, seed=r)) for r in range(18)]

    def run(workers):
        with SketchService(workers=workers, **CPU) as svc:
            for g in range(n_groups):
                svc.create_tenant(f"t{g}", "pca", plan=plan, key=7, n_components=3,
                                  group=f"g{g}")
            futs = [svc.ingest(gid, b) for gid, b in blocks]
            assert all(f.result(TIMEOUT).ok for f in futs)
            return {g: svc.query(f"t{g}", "components").unwrap()["components"]
                    for g in range(n_groups)}

    one, four = run(1), run(4)
    for g in range(n_groups):
        assert np.array_equal(one[g], four[g])


# ------------------------------------------------------- admission control --


def test_admission_rejects_with_backpressure():
    svc = SketchService(max_pending_rows=2 * BS, max_queue=3, **CPU)
    svc.create_tenant("t", "mean", plan=_plan(), key=1)
    a = svc.ingest("t", _x(2 * BS))
    b = svc.ingest("t", _x(BS))
    assert b.result(0).status == "rejected" and "pending" in b.result(0).error
    assert svc.ingest("unknown", _x(1)).result(0).status == "error"
    _drain(svc)
    assert a.result(0).ok
    d = svc.ingest("t", _x(BS))
    assert not d.done()
    e = [svc.ingest("t", _x(1)) for _ in range(3)]
    assert e[-1].result(0).status == "rejected" and "queue full" in e[-1].result(0).error
    assert svc.stats["rejected"] == 2
    svc.stop()
    assert d.result(0).status == "error" and "stopped" in d.result(0).error
    assert svc._groups["t"].pending_rows == 0
    assert svc.registry.gauge("serve.pending_rows").value == 0


def test_metrics_reconcile_and_lazy_finalize():
    n_req, rows_per = 24, 8
    with SketchService(max_batch=16, **CPU) as svc:
        svc.create_tenant("t0", "pca", plan=_plan(cov_path="lowrank", rank=4), key=1,
                          n_components=2, group="g")
        svc.create_tenant("t1", "mean", plan=_plan(cov_path="lowrank", rank=4), key=1,
                          group="g")
        assert "no ingested rows" in svc.query("t0", "components").error
        futs = [svc.ingest("g", _x(rows_per, seed=i)) for i in range(n_req)]
        assert all(f.result(TIMEOUT).ok for f in futs)
        svc.query("t0", "components").unwrap()
        svc.query("t0", "transform", _x(4)).unwrap()
        st = svc.query("t0", "stats").unwrap()
        assert st["finalize_count"] == 1 and st["rows"] == n_req * rows_per
        assert svc.query("t0", "centers").status == "error"
        stats, reg = svc.stats, svc.registry
    assert stats["ingest_requests"] == n_req and stats["ingest_rows"] == n_req * rows_per
    assert stats["queries"] == 5 and stats["finalizes"] == 1
    assert stats["requests"] == n_req + 5 + 2
    h = reg.histogram("serve.coalesced_requests")
    assert h.sum == n_req and h.count == stats["ingest_folds"]
    assert (reg.counter("serve.tenant_folds", tenant="t0").value
            == reg.counter("serve.tenant_folds", tenant="t1").value == stats["ingest_folds"])
    assert reg.gauge("serve.pending_rows").value == 0
    assert reg.histogram("serve.request_seconds").count >= n_req + 5
    text = obs.render_exposition(reg)
    assert f"serve_ingest_requests {n_req}" in text


# ------------------------------------------------------- snapshot/restore ---


def test_snapshot_restore_bit_identical_and_resumable(tmp_path):
    x, more = _x(4 * BS), _x(2 * BS, seed=9)
    plan = _plan(cov_path="lowrank", rank=12)
    with SketchService(**CPU) as svc:
        svc.create_tenant("p", "pca", plan=plan, key=7, n_components=3, group="g",
                          retain_ingest=True)
        svc.create_tenant("k", "kmeans", plan=_plan(), key=7, k=3, group="g",
                          algorithm="minibatch")
        svc.create_tenant("solo", "cov", plan=_plan(gamma=0.25), key=5)
        svc.ingest("g", x).result(TIMEOUT)
        svc.ingest("solo", x).result(TIMEOUT)
        comps = svc.query("p", "components").unwrap()
        assert svc.snapshot(str(tmp_path)) == 1
        svc.ingest("g", more).result(TIMEOUT)
        cont = svc.query("p", "components").unwrap()
        cont_k = svc.query("k", "centers").unwrap()
    with restore_service(str(tmp_path), **CPU) as svc2:
        comps2 = svc2.query("p", "components").unwrap()
        assert np.array_equal(comps["components"], comps2["components"])
        assert svc2.query("solo", "stats").unwrap()["rows"] == 4 * BS
        svc2.ingest("g", more).result(TIMEOUT)
        assert np.array_equal(cont["components"],
                              svc2.query("p", "components").unwrap()["components"])
        assert np.array_equal(cont_k, svc2.query("k", "centers").unwrap())
        r = svc2.refine("p", passes=1)
        assert r.ok and r.result["passes"] == 1
        assert svc2.snapshot(str(tmp_path)) == 2


def test_snapshots_cross_both_ways(tmp_path):
    """A reference snapshot restores in the port and a port snapshot in the
    reference: answers within 1e-5, and ingest continued on both sides after
    the crossing agrees too (the restored cursors resume the same chunk
    keys)."""
    x, more = _x(4 * BS), _x(2 * BS, seed=9)
    xk = _clusters(4 * BS)

    def fill(svc, plan_of):
        svc.create_tenant("p", "pca", plan=plan_of(cov_path="lowrank", rank=12), key=7,
                          n_components=3, group="g", retain_ingest=True)
        svc.create_tenant("m", "mean", plan=plan_of(cov_path="lowrank", rank=12), key=7,
                          group="g")
        svc.create_tenant("k", "kmeans", plan=plan_of(), key=4, k=3, algorithm="minibatch")
        assert svc.ingest("g", x).result(TIMEOUT).ok
        assert svc.ingest("k", xk).result(TIMEOUT).ok

    def read(svc):
        return {"comps": svc.query("p", "components").unwrap(),
                "mean": svc.query("m", "mean").unwrap(),
                "centers": svc.query("k", "centers").unwrap(),
                "labels": svc.query("k", "predict", xk[:64]).unwrap()}

    def continue_(svc):
        assert svc.ingest("g", more).result(TIMEOUT).ok
        assert svc.ingest("k", _clusters(2 * BS, seed=3)).result(TIMEOUT).ok
        return read(svc)

    def same(a, b):
        _same_components(a["comps"], b["comps"])
        _close(a["mean"], b["mean"])
        _close(a["centers"], b["centers"])
        assert np.array_equal(np.asarray(a["labels"]), np.asarray(b["labels"]))

    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    with jserve.SketchService(scan="never") as jsvc:
        fill(jsvc, _jplan)
        jsvc.snapshot(ref_dir)
        j_before, j_after = read(jsvc), continue_(jsvc)
    with SketchService(**CPU) as svc:
        fill(svc, _plan)
        svc.snapshot(port_dir)
        t_before = read(svc)
    same(t_before, j_before)
    with restore_service(ref_dir, **CPU) as svc:           # reference → port
        same(read(svc), j_before)
        same(continue_(svc), j_after)
        assert svc.refine("p", passes=1).ok
    with jserve.restore_service(port_dir, scan="never") as jsvc:   # port → reference
        same(read(jsvc), t_before)
        same(continue_(jsvc), j_after)


def test_snapshot_plan_codec_across_packages(tmp_path):
    """Plan JSON: dtype as its numpy name, impl "auto" round-trips both ways,
    the group key is uint32[2] on both sides, and a reference plan with an
    impl the port refuses fails naming the field."""
    for dtype in ("float32", torch.float32, np.float32):
        d = plan_to_json(_plan(dtype=dtype))
        assert d["dtype"] == "float32" and d["mesh"] is None
    d = plan_to_json(_plan(cov_path="lowrank", rank=12))
    assert d == jserve.snapshot.plan_to_json(_jplan(cov_path="lowrank", rank=12))
    assert plan_from_json(jserve.snapshot.plan_to_json(_jplan())) == _plan()
    assert jserve.snapshot.plan_from_json(plan_to_json(_plan())) == _jplan()
    with pytest.raises(ValueError, match="impl"):
        plan_from_json(jserve.snapshot.plan_to_json(_jplan(impl="jnp")))
    with SketchService(**CPU) as svc:
        svc.create_tenant("t", "mean", plan=_plan(), key=2**32 + 5)
        svc.ingest("t", _x(BS)).result(TIMEOUT)
        svc.snapshot(str(tmp_path))
    arrays, _ = jserve.snapshot.checkpoint.load_arrays(str(tmp_path))
    key = arrays["t/__key__"]
    assert key.dtype == np.uint32 and key.shape == (2,)
    assert np.array_equal(key, np.asarray(jax.random.PRNGKey(2**32 + 5)))
    # a mesh travels as its geometry, the reference's encoding, both ways
    spec = {"axis_names": ["data"], "shape": [1]}
    meshed = plan_from_json(dict(plan_to_json(_plan()), mesh=spec))
    assert meshed.mesh.shape == {"data": 1} and plan_to_json(meshed)["mesh"] == spec
    assert plan_to_json(meshed) == jserve.snapshot.plan_to_json(
        jserve.snapshot.plan_from_json(plan_to_json(meshed)))


# ---------------------------------------------------------- tenant eviction --


def test_ttl_eviction_and_lazy_restore(tmp_path):
    with SketchService(ttl_s=0.25, evict_dir=str(tmp_path), **CPU) as svc:
        svc.create_tenant("idle", "pca", plan=_plan(cov_path="lowrank", rank=12), key=3,
                          n_components=3)
        svc.create_tenant("hot", "mean", plan=_plan(), key=1)
        svc.ingest("idle", _x(2 * BS)).result(TIMEOUT).unwrap()
        ref = svc.query("idle", "components").unwrap()["components"]
        deadline = time.monotonic() + 30
        while "idle" not in svc.evicted():
            assert time.monotonic() < deadline, "TTL eviction never fired"
            svc.ingest("hot", _x(BS)).result(TIMEOUT)
            time.sleep(0.03)
        assert "idle" not in svc.tenants() and "hot" in svc.tenants()
        got = svc.query("idle", "components").unwrap()["components"]
        assert np.array_equal(ref, got)
        assert "idle" in svc.tenants() and svc.stats["evict_restores"] == 1
        assert svc.ingest("idle", _x(BS, seed=5)).result(TIMEOUT).ok


# ---------------------------------------------------------------- refine ----


def test_refine_through_the_service():
    """refine over the retained ingest equals the port's fit + refine of the
    same rows, bit for bit; without retained ingest it answers an error."""
    x = _x(4 * BS)
    plan = _plan(cov_path="lowrank", rank=12)
    with SketchService(**CPU) as svc:
        svc.create_tenant("p", "pca", plan=plan, key=3, n_components=3, retain_ingest=True)
        svc.create_tenant("k", "kmeans", plan=_plan(), key=3, k=3, algorithm="minibatch",
                          retain_ingest=True)
        svc.create_tenant("q", "pca", plan=plan, key=3, n_components=3)
        for t in ("p", "k", "q"):
            for i in range(0, 4 * BS, 2 * BS):
                svc.ingest(t, x[i:i + 2 * BS]).result(TIMEOUT).unwrap()
        r = svc.refine("p", passes=2)
        assert r.ok and r.result["passes"] == 2
        comps = svc.query("p", "components").unwrap()["components"]
        assert svc.refine("k", passes=1).ok
        centers = svc.query("k", "centers").unwrap()
        assert "retain_ingest=False" in svc.refine("q").error
        assert svc.refine("q", x=x, passes=2).ok
        assert np.array_equal(svc.query("q", "components").unwrap()["components"], comps)
    direct = SparsifiedPCA(3, plan, key=3, **CPU).fit(x).refine(x, passes=2)
    assert np.array_equal(comps, direct.components_.numpy())
    km = ESTIMATORS["kmeans"](3, _plan(), key=3, algorithm="minibatch", **CPU).fit(x)
    assert np.array_equal(centers, km.refine(x, passes=1).centers_.numpy())


def test_stop_and_internal_errors_resolve_every_future(monkeypatch):
    with SketchService(**CPU) as svc:
        svc.create_tenant("t", "mean", plan=_plan(), key=1)

        def boom(req):
            raise RuntimeError("boom")

        monkeypatch.setattr(svc, "_handle_query", boom)
        r = svc.query("t", "stats", timeout=TIMEOUT)
        assert r.status == "error" and "boom" in r.error
        monkeypatch.undo()
        assert svc._thread.is_alive()
        assert svc.ingest("t", _x(BS)).result(TIMEOUT).ok
    for f in (svc.ingest("t", _x(BS)), svc.submit(QueryRequest("t", "stats")),
              svc.submit(AdminRequest("delete_tenant", dict(tid="t")))):
        assert f.done() and "stopped" in f.result(0).error
    with pytest.raises(RuntimeError, match="stopped"):
        svc.start()


# -------------------------------------------------------------- launcher ----


def test_launcher_crash_and_resume_matches_uninterrupted(tmp_path):
    """--supervise with --crash-after, at the reference launcher's default
    sizes, writes the same --out as an uninterrupted run."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    base = [sys.executable, "-m", "repro_torch.launch.sketch_serve", "--device", "cpu"]
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    crashed = subprocess.run(
        base + ["--supervise", "--crash-after", "100", "--snapshot", str(tmp_path / "snap"),
                "--snapshot-every-rows", "512", "--out", a],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert crashed.returncode == 0, crashed.stdout + crashed.stderr
    assert "crash-after: dying with 100 acked requests" in crashed.stdout
    assert "workload completed after 1 restart(s)" in crashed.stdout
    plain = subprocess.run(base + ["--out", b], capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=600)
    assert plain.returncode == 0, plain.stderr
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
