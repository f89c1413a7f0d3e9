"""The whole slice against the reference on the CPU: ``make_engine(...).run(3)``
in both packages, from scratch and from the reference's state carried across;
the launcher; and the options that are not ported yet."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.data.pipeline import VectorStreamSource as JSource
from repro.stream import StreamKMeansConfig as JKMeans
from repro.stream import state as jstate
from repro_torch import api, obs
from repro_torch.data.pipeline import VectorStreamSource
from repro_torch.stream import EngineTelemetry, StreamKMeansConfig
from repro_torch.stream import state as tstate
from repro_torch.utils import prng

P, BATCH, STEPS = 1000, 64, 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("repro_torch implements jax_threefry_partitionable=True only")


def _engines():
    jeng = japi.make_engine(japi.Plan(backend="stream", gamma=0.1, batch_size=BATCH, n_shards=2),
                            P, jax.random.PRNGKey(3), JSource(p=P, batch=BATCH, seed=0),
                            kmeans=JKMeans(k=4, n_init=2))
    teng = api.make_engine(api.Plan(backend="stream", gamma=0.1, batch_size=BATCH, n_shards=2),
                           P, prng.PRNGKey(3), VectorStreamSource(p=P, batch=BATCH, seed=0),
                           kmeans=StreamKMeansConfig(k=4, n_init=2), device="cpu")
    return jeng, teng


def _assert_results_match(res, jres):
    def close(a, b, tol):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)

    assert int(res.count) == int(jres.count) == STEPS * 2 * BATCH
    close(res.mean, jres.mean, 1e-5)
    close(res.cov, jres.cov, 1e-5)
    close(res.centers_pre, jres.centers_pre, 1e-4)
    close(res.centers, jres.centers, 1e-4)
    close(res.kmeans_obj, jres.kmeans_obj, 1e-4)


def test_stream_engine_matches_reference(partitionable):
    jeng, teng = _engines()
    jres = jeng.run(STEPS)
    res = teng.run(STEPS)
    _assert_results_match(res, jres)
    assert res.centers.shape == (4, P) and res.centers_pre.shape == (4, 1024)
    # the final states agree field by field in the shared layout
    a, b = tstate.engine_to_arrays(teng.state), jstate.engine_to_arrays(jeng.state)
    assert sorted(a) == sorted(b)
    np.testing.assert_array_equal(a["kmeans/km.counts"], b["kmeans/km.counts"])
    np.testing.assert_array_equal(a["moments/moment.count"], b["moments/moment.count"])
    # and label the same sketched rows alike
    x = VectorStreamSource(p=P, batch=BATCH, seed=0).batch_at(9)
    s = teng._sketch_local(torch.from_numpy(x), 9, 0)
    js = jeng._sketch_local(x, jax.numpy.int32(9), 0)
    np.testing.assert_array_equal(teng.assign(s).numpy(), np.asarray(jeng.assign(js)))


def test_run_from_carried_reference_state(partitionable):
    """Start the port from the reference engine's init_state() (and resume
    mid-stream from the reference's step-1 state): same result."""
    jeng, teng = _engines()
    jres = jeng.run(STEPS)
    state0 = tstate.engine_from_arrays(jstate.engine_to_arrays(jeng.init_state()), device="cpu")
    _assert_results_match(teng.run(STEPS, state=state0), jres)
    j1 = jeng.update(jeng.init_state(), jeng._host_global_batch(None, 0), 0)
    state1 = tstate.engine_from_arrays(jstate.engine_to_arrays(j1), device="cpu")
    _assert_results_match(teng.run(STEPS, state=state1, start_step=1), jres)


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream", "--device", "cpu", "--p", "300",
         "--gamma", "0.1", "--batch", "32", "--steps", "2", "--shards", "2", "--kmeans-k", "3"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "device: cpu" in out.stdout
    assert "streamed 128 rows" in out.stdout
    assert "kmeans: K=3" in out.stdout


def test_options_not_ported_raise(tmp_path):
    """The options the port has (the sharded backend, refine_passes,
    reassignment tracking, checkpoints, run_scanned, replay, telemetry) run."""
    src = VectorStreamSource(p=64, batch=8)
    plan = api.Plan(backend="stream", gamma=0.25, batch_size=8)
    sharded = api.make_engine(plan.replace(backend="sharded"), 64, 0, src, device="cpu")
    assert torch.equal(sharded.run(2).cov, api.make_engine(plan, 64, 0, src, device="cpu").run(2).cov)
    assert api.make_engine(plan.replace(refine_passes=1), 64, 0, src, device="cpu").run(1)
    # the batch backend runs through the estimators, as in the reference
    with pytest.raises(ValueError, match="estimator classes"):
        api.make_engine(plan.replace(backend="batch"), 64, 0, src, device="cpu")
    # the engine's low-rank path is the range-finder only, as the reference's
    with pytest.raises(ValueError, match="lowrank_method='fd'"):
        api.make_engine(plan.replace(cov_path="lowrank", rank=4, lowrank_method="fd"), 64, 0,
                        src, device="cpu")
    eng = api.make_engine(plan, 64, 0, src, device="cpu",
                          kmeans=StreamKMeansConfig(k=2, track_reassignments=True))
    res = eng.run(2, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert res.reassign_counts.shape == (2, 3)
    state, next_step = eng.restore_state(str(tmp_path))
    assert next_step == 2 and int(eng.run(3, state=state, start_step=2).count) == 24
    eng.save_state(str(tmp_path / "again"), 3)
    xs = np.stack([[src.batch_at(t)] for t in range(2)])
    assert torch.equal(eng.run_scanned(xs).cov, eng.run(2).cov)
    assert eng.replay(2).refine_passes == 1
    reg = obs.MetricsRegistry()
    eng.run(1, telemetry=EngineTelemetry(registry=reg))
    assert reg.counter("engine.steps").value == 1
    with pytest.raises(ValueError):
        api.Plan(backend="stream", gamma=0.1, impl="interpret")


def test_cuda_default_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.make_engine(api.Plan(backend="stream", gamma=0.5), 16, 0,
                        VectorStreamSource(p=16, batch=4))
