"""repro_torch.obs — the port's telemetry — against repro.obs on the CPU.

The cases of tests/test_obs.py for the port: the registry's exact totals
under threads, the exposition text byte-equal to the reference's for the
same registry operations, the JSONL round trip (each package reads the
other's), span nesting and totals (and the spans' names in a
``torch.profiler`` capture), ``EngineTelemetry`` bit-identical to an
uninstrumented run with the reference's step-record keys, rows, steps and
state bytes, the launcher's telemetry flags, and the per-call
``kernels.dispatch`` series with ``path="ref"`` on the CPU.

Tolerances: none — counts, bytes, text and bits are compared exactly.
"""
import io
import json
import math
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro import obs as jobs
from repro.data.pipeline import VectorStreamSource as JSource
from repro.stream import EngineTelemetry as JTelemetry
from repro.stream import StreamKMeansConfig as JKMeans
from repro_torch import api, obs
from repro_torch.core import sketch
from repro_torch.data.pipeline import VectorStreamSource
from repro_torch.kernels import ops
from repro_torch.stream import EngineTelemetry, StreamEngine, StreamKMeansConfig
from repro_torch.utils import prng
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



@pytest.fixture
def fresh_default():
    """A fresh default registry for the test, the previous one put back."""
    reg = obs.MetricsRegistry()
    prev = obs.set_default_registry(reg)
    try:
        yield reg
    finally:
        obs.set_default_registry(prev)


# ------------------------------------------------------------- registry -----


def test_registry_exact_totals_under_threads():
    """8 threads hammer one counter, one gauge and one histogram with a short
    switch interval: every total is exact (a lost update would show)."""
    reg = obs.MetricsRegistry()
    c, g = reg.counter("hammer.count"), reg.gauge("hammer.level")
    h = reg.histogram("hammer.obs", window=64)
    n_threads, n_iter = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(tid):
            for _ in range(n_iter):
                c.inc()
                g.inc(1.0)
                h.observe(float(tid))
                reg.counter("hammer.count", worker=str(tid % 2)).inc()

        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_iter
    assert c.value == total and g.value == float(total)
    assert h.count == total and h.sum == n_iter * sum(range(n_threads))
    assert (reg.counter("hammer.count", worker="0").value
            + reg.counter("hammer.count", worker="1").value) == total


def test_registry_semantics_match_reference():
    """Label sets, the histogram window and summary, the disabled registry and
    the quantiles helper read as the reference's do."""
    snaps = []
    for mod in (obs, jobs):
        reg = mod.MetricsRegistry()
        reg.counter("c", group="a").inc(2)
        reg.counter("c", group="b").inc(5)
        assert reg.counter("c", group="a") is reg.counter("c", group="a")
        h = reg.histogram("lat", window=8)
        for v in range(100):
            h.observe(float(v))
        assert 92.0 <= h.summary()["p50"] <= 99.0     # the last 8 observations
        off = mod.MetricsRegistry(enabled=False)
        assert off.counter("a") is off.gauge("b") is off.histogram("c")
        off.counter("a").inc()
        assert off.metrics() == [] and off.snapshot() == {}
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert obs.quantiles([1.0, 2.0, 3.0, 4.0], (0.5, 0.99)) == jobs.quantiles(
        [1.0, 2.0, 3.0, 4.0], (0.5, 0.99))
    assert all(math.isnan(v) for v in obs.quantiles([], (0.5, 0.9)))


def _same_ops(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve.requests", tenant="t0").inc(3)
    reg.counter("serve.requests", tenant='we"ird\\na\nme').inc()
    reg.counter("kernels.dispatch", op="spmm_t", path="ref").inc(7)
    reg.gauge("queue.depth").set(2)
    reg.gauge("ratio.up").set(float("inf"))
    reg.gauge("ratio.down").set(float("-inf"))
    reg.gauge("ratio.nan").set(float("nan"))
    reg.gauge("rate").set(1234.5)
    h = reg.histogram("lat.s")
    for v in (0.5, 1.0, 1.5, 2.0):
        h.observe(v)
    w = reg.histogram("weird.s", path="a.b")
    w.observe(float("inf"))
    w.observe(1.0)
    reg.histogram("empty.s")
    return reg


def test_render_exposition_byte_equal_to_reference():
    text = obs.render_exposition(_same_ops(obs))
    assert text == jobs.render_exposition(_same_ops(jobs))
    assert 'serve_requests{tenant="t0"} 3' in text and "ratio_up +Inf" in text
    assert "weird_s_sum{path=\"a.b\"} +Inf" in text and "lat_s_count 4" in text
    assert obs.render_exposition(obs.MetricsRegistry()) == ""


def test_metrics_server_endpoint():
    reg = obs.MetricsRegistry()
    reg.counter("up").inc()
    srv = obs.serve_metrics(reg)
    try:
        text = urllib.request.urlopen(srv.url, timeout=10).read().decode()
        assert text == obs.render_exposition(reg) and "up 1" in text
        js = json.loads(urllib.request.urlopen(srv.url + ".json", timeout=10).read().decode())
        assert js["up"]["value"] == 1
    finally:
        srv.close()


# ---------------------------------------------------------------- JSONL -----


def test_steplogger_jsonl_roundtrip_both_ways(tmp_path):
    buf = io.StringIO()
    log = obs.StepLogger(stream=buf, every=3, static={"run": "t"})
    logged = [log.log(step=s, loss=float(s)) for s in range(10)]
    assert logged == [s % 3 == 0 for s in range(10)]
    log.log(step=98, force=True, note="final")
    recs = obs.read_jsonl(io.StringIO(buf.getvalue()))
    assert [r["step"] for r in recs] == [0, 3, 6, 9, 98]
    assert recs[-1]["note"] == "final"
    assert jobs.read_jsonl(io.StringIO(buf.getvalue())) == recs
    path = str(tmp_path / "steps.jsonl")
    with obs.StepLogger(path=path) as log:
        log.log(step=np.int64(0), v=np.float32(1.5), arr=np.arange(3),
                t0=torch.tensor(2.5), t1=torch.arange(2))
    (rec,) = jobs.read_jsonl(path)
    assert rec["step"] == 0 and rec["v"] == 1.5 and rec["arr"] == [0, 1, 2]
    assert rec["t0"] == 2.5 and rec["t1"] == [0, 1]
    assert obs.read_jsonl(path) == [rec]


# ---------------------------------------------------------------- spans -----


def test_span_nesting_totals_and_timed():
    reg = obs.MetricsRegistry()
    with obs.span("outer", reg):
        assert obs.current_path() == "outer"
        with obs.span("inner", reg):
            assert obs.current_path() == "outer.inner"
        with obs.span("inner", reg):
            pass
    assert obs.current_path() is None
    totals = obs.span_totals(reg)
    assert totals["outer"]["count"] == 1 and totals["outer.inner"]["count"] == 2
    assert totals["outer"]["total_s"] >= totals["outer.inner"]["total_s"]

    @obs.timed("fn", reg)
    def fn(x):
        return x + 1

    assert [fn(i) for i in range(3)] == [1, 2, 3]
    totals = obs.span_totals(reg)
    assert totals["fn"]["count"] == 3 and totals["fn.first"]["count"] == 1

    # spans on other threads nest on their own stacks
    seen = []

    def worker():
        with obs.span("w", reg):
            seen.append(obs.current_path())

    with obs.span("main", reg):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert seen == ["w"] and obs.span_totals(reg)["w"]["count"] == 1


def test_spans_appear_in_a_profiler_capture():
    """A span passes through torch.profiler.record_function: its path is an
    event of the capture, beside the work it enclosed."""
    reg = obs.MetricsRegistry()
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("probe", reg):
            with obs.span("matmul", reg):
                x @ x
    names = {e.key for e in prof.key_averages()}
    assert {"probe", "probe.matmul"} <= names


# ----------------------------------------------- engine: observe-only -------


def _fields_equal(a, b):
    for f in ("mean", "cov", "centers", "centers_pre", "kmeans_obj", "count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_engine_telemetry_is_bit_identical():
    """Telemetry on vs off on the CPU: every finalized output and the state
    are bit-identical; the registry and JSONL agree with the known totals."""
    p, b, steps = 64, 32, 5
    spec = sketch.make_spec(p, prng.PRNGKey(1), gamma=0.25)
    data = np.random.default_rng(0).normal(size=(steps, b, p)).astype(np.float32)

    def make_engine():
        return StreamEngine(spec, lambda seed, step, shard: data[step], track_cov=True,
                            kmeans=StreamKMeansConfig(k=3, n_init=2, track_reassignments=True),
                            device="cpu")

    plain = make_engine()
    res_plain = plain.run(steps)
    reg = obs.MetricsRegistry()
    buf = io.StringIO()
    seen = []
    tel = EngineTelemetry(registry=reg, step_logger=obs.StepLogger(stream=buf), log_every=2,
                          on_step=seen.append)
    eng = make_engine()
    res_tel = eng.run(steps, telemetry=tel)
    _fields_equal(res_plain, res_tel)
    assert np.array_equal(res_plain.reassign_counts, res_tel.reassign_counts)
    a, b2 = eng.state, plain.state
    assert torch.equal(a.moments.sum_wwt, b2.moments.sum_wwt)
    assert torch.equal(a.kmeans.counts, b2.kmeans.counts)

    assert reg.counter("engine.steps").value == steps
    assert reg.counter("engine.rows").value == steps * b
    assert reg.counter("engine.reassigned").value == int(res_tel.reassign_counts.sum())
    assert reg.histogram("engine.step_seconds").count == steps
    totals = obs.span_totals(reg)
    assert totals["engine.update"]["count"] == totals["engine.source"]["count"] == steps
    recs = obs.read_jsonl(io.StringIO(buf.getvalue()))
    assert [r["step"] for r in recs] == [0, 2, 4] and [r["step"] for r in seen] == list(range(5))
    assert recs[-1]["rows_total"] == steps * b
    assert all("reassign_frac" in r for r in recs)
    assert reg.gauge("engine.state_bytes").value == recs[-1]["state_bytes"] > 0


def test_engine_telemetry_matches_reference(tmp_path):
    """The same stream through both packages' engines with telemetry: the
    same counters, histogram counts, step-record keys, rows, steps and state
    bytes (the reference's tree_leaves sum), checkpoints included."""
    p, batch, steps = 300, 32, 4
    plan = dict(backend="stream", gamma=0.1, batch_size=batch, n_shards=2)
    km = dict(k=3, n_init=2, track_reassignments=True)
    jreg, treg = jobs.MetricsRegistry(), obs.MetricsRegistry()
    jrec, trec = [], []
    jeng = japi.make_engine(japi.Plan(**plan), p, jax.random.PRNGKey(3),
                            JSource(p=p, batch=batch, seed=0), kmeans=JKMeans(**km))
    teng = api.make_engine(api.Plan(**plan), p, prng.PRNGKey(3),
                           VectorStreamSource(p=p, batch=batch, seed=0),
                           kmeans=StreamKMeansConfig(**km), device="cpu")
    jres = jeng.run(steps, telemetry=JTelemetry(registry=jreg, on_step=jrec.append),
                    checkpoint_dir=str(tmp_path / "j"), checkpoint_every=2)
    tres = teng.run(steps, telemetry=EngineTelemetry(registry=treg, on_step=trec.append),
                    checkpoint_dir=str(tmp_path / "t"), checkpoint_every=2)
    np.testing.assert_allclose(tres.mean.numpy(), np.asarray(jres.mean), rtol=1e-5, atol=1e-5)
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    for key in ("step", "rows", "rows_total", "state_bytes", "checkpoint_step"):
        assert [r.get(key) for r in trec] == [r.get(key) for r in jrec], key
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()
    assert sorted(tsnap) == sorted(jsnap)
    for name in ("engine.steps", "engine.rows", "engine.checkpoints", "engine.state_bytes"):
        assert tsnap[name]["value"] == jsnap[name]["value"], name
    for name in ("engine.step_seconds", "engine.checkpoint_seconds", "span{path=engine.update}"):
        assert tsnap[name]["count"] == jsnap[name]["count"], name


def test_launcher_telemetry_flags(tmp_path):
    log = str(tmp_path / "run.jsonl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream", "--device", "cpu", "--p", "200",
         "--gamma", "0.1", "--batch", "32", "--steps", "4", "--log-every", "2",
         "--log-file", log, "--metrics-port", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "metrics at http://127.0.0.1:" in out.stdout and "streamed 128 rows" in out.stdout
    recs = obs.read_jsonl(log)
    assert [r["step"] for r in recs] == [0, 2]
    assert all(r["device"] == "cpu" and r["p"] == 200 and r["rows"] == 32 for r in recs)


# ------------------------------------------------------ kernel dispatch -----


def test_kernel_dispatch_series_on_the_cpu(fresh_default):
    """Every dispatch on the CPU is a path="ref" series of the default
    registry, counted per call, equal to ops.DISPATCH call for call; "ref"
    asked for on any device counts as "ref" too."""
    ops.reset_counts()
    x = torch.randn(4, 64)
    signs = torch.where(torch.arange(64) % 2 == 0, 1.0, -1.0)
    ops.hd_precondition(x, signs)
    ops.hd_precondition(x, signs, mode="ref")
    idx = torch.sort(torch.randperm(64)[:8]).values.repeat(4, 1).to(torch.int32)
    vals = ops.sketch_fused(x, signs, idx)
    ops.sparse_assign(vals, idx, torch.randn(3, 64))
    ops.spmm_t(vals, idx, torch.randn(4, 5), 64)
    assert fresh_default.counter("kernels.dispatch", op="hd_precondition",
                                 path="ref").value == 2
    series = {(m.labels["op"], m.labels["path"]): m.value for m in fresh_default.metrics()
              if m.name == "kernels.dispatch"}
    assert series == dict(ops.DISPATCH) == {
        ("hd_precondition", "ref"): 2, ("sketch_fused", "ref"): 1,
        ("sparse_assign", "ref"): 1, ("spmm_t", "ref"): 1}
    assert sum(ops.launch_counts().values()) == 0
    assert 'kernels_dispatch{op="hd_precondition",path="ref"} 2' in obs.render_exposition(
        fresh_default)


def test_dispatch_tally_exact_under_threads(fresh_default):
    """Four threads dispatching at once: the tally and the registry series
    both count every call."""
    ops.reset_counts()
    x, signs = torch.randn(2, 16), torch.ones(16)
    n_iter = 300

    def work():
        for _ in range(n_iter):
            ops.hd_precondition(x, signs)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert ops.DISPATCH[("hd_precondition", "ref")] == 4 * n_iter
    assert fresh_default.counter("kernels.dispatch", op="hd_precondition",
                                 path="ref").value == 4 * n_iter
