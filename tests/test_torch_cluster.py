"""repro_torch.cluster against repro.cluster on the CPU: the bootstrap units,
the mesh geometry both packages serialize, the elastic remap, the heartbeat,
and a 2-process gloo run of the sharded fit against the reference's run on 2
forced host devices.

The processes exchange only each step's all-reduced delta; the data
regenerates in every process from the (seed, step, shard) contract.
Tolerances are the reference's (tests/test_cluster.py): means and centers
1e-5, the covariance trace 1e-5 relative; counts and reassignment counts
equal.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import cluster as jcluster
from repro.api.plan import mesh_from_spec as jmesh_from_spec
from repro.api.plan import mesh_spec as jmesh_spec
from repro_torch import cluster, obs
from repro_torch.api.plan import mesh_from_spec, mesh_spec
from repro_torch.cluster.bootstrap import free_port
from repro_torch.core import sketch
from repro_torch.stream import StreamKMeansConfig
from repro_torch.stream import state as state_mod
from repro_torch.stream.engine import StreamEngine
from repro_torch.utils import prng
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# --------------------------------------------------------- bootstrap units --


def test_initialize_single_process_is_noop():
    assert cluster.initialize(device="cpu") is False
    assert cluster.initialize(num_processes=1, device="cpu") is False
    assert cluster.is_multiprocess() is False
    assert cluster.process_index() == 0 and cluster.process_count() == 1


def test_process_mesh_contiguous_and_cached():
    m = cluster.process_mesh(1)
    assert m.axis_names == ("data",) and m.shape == {"data": 1}
    assert cluster.process_mesh(1) is m       # cached: callers share one mesh
    assert cluster.process_mesh(4).owners == (0, 0, 0, 0)
    assert not m.collective
    with pytest.raises(ValueError, match="n_shards"):
        cluster.process_mesh(0)
    assert cluster.bootstrap.contiguous_blocks(5, 2) == [[0, 1, 2], [3, 4]]


def test_local_shards_single_process_owns_all():
    assert cluster.local_shards(cluster.process_mesh(3)) == [0, 1, 2]
    with pytest.raises(ValueError, match="1-D"):
        cluster.local_shards(cluster.make_mesh((1, 1), ("a", "b")))


def test_global_rows_single_process():
    m = cluster.process_mesh(1)
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(cluster.global_rows(arr, m).numpy(), arr)
    jm = jcluster.process_mesh(1)
    np.testing.assert_array_equal(np.asarray(jcluster.global_rows(arr, jm)), arr)
    batch = cluster.global_shard_batch(lambda seed, step, shard: arr + shard, None, 0,
                                       cluster.process_mesh(2))
    assert batch.shape == (2, 4, 3) and float(batch[1, 0, 0]) == 1.0


def test_mesh_spec_roundtrip_both_packages():
    m = cluster.process_mesh(1)
    spec = mesh_spec(m)
    assert spec == {"axis_names": ["data"], "shape": [1]} == jmesh_spec(jax.make_mesh((1,), ("data",)))
    m2 = mesh_from_spec(spec)
    assert m2.axis_names == ("data",) and m2.shape == {"data": 1} and m2 == m
    assert jmesh_spec(jmesh_from_spec(mesh_spec(m2))) == spec
    assert mesh_spec(None) is None and mesh_from_spec(None) is None
    assert mesh_spec(mesh_from_spec({"axis_names": ["x", "y"], "shape": [2, 3]})) == {
        "axis_names": ["x", "y"], "shape": [2, 3]}


# -------------------------------------------------------------- elastic ----


def _source(seed, step, shard):
    return np.random.default_rng((seed, step, shard)).normal(size=(16, 48)).astype(np.float32)


def test_worker_shards_blocks():
    for n_shards, n_workers in [(4, 2), (5, 2), (8, 3), (3, 3)]:
        blocks = [cluster.worker_shards(n_shards, n_workers, w) for w in range(n_workers)]
        assert [s for b in blocks for s in b] == list(range(n_shards))
        assert blocks == [jcluster.worker_shards(n_shards, n_workers, w)
                          for w in range(n_workers)]
    with pytest.raises(ValueError, match="idle"):
        cluster.worker_shards(2, 4, 0)
    with pytest.raises(ValueError, match="worker must be"):
        cluster.worker_shards(4, 2, 2)


def test_elastic_remap_4_to_2_parity(tmp_path):
    """Checkpoint a 4-shard run at step 3, finish it under 2 workers
    (tests/test_engine_state.py:179): equal to the uninterrupted run to 1e-5,
    and bit-equal where 2 → 1 workers keeps the sums' order."""
    spec = sketch.make_spec(48, prng.PRNGKey(2), gamma=0.3)
    km = StreamKMeansConfig(k=3, n_init=2)

    def mk(n=4):
        return StreamEngine(spec, _source, n_shards=n, kmeans=km, device="cpu")

    full = mk().run(6, seed=9)
    eng = mk()
    eng.run(3, seed=9)
    eng.save_state(str(tmp_path), 3, seed=9)
    eng2 = mk()
    state, next_step = eng2.restore_state(str(tmp_path))
    assert next_step == 3
    cluster.continue_elastic(eng2, 6, state=state, start_step=3, n_workers=2, seed=9)
    res = eng2.finalize()
    for f in ("mean", "cov", "centers"):
        np.testing.assert_allclose(getattr(res, f).numpy(), getattr(full, f).numpy(), atol=1e-5)
    assert int(res.count) == int(full.count)

    two = mk(2).run(4, seed=9)
    eng3 = mk(2)
    eng3.run(2, seed=9)
    cluster.continue_elastic(eng3, 4, state=eng3.state, start_step=2, n_workers=1, seed=9)
    for f in ("mean", "cov", "centers"):
        assert torch.equal(getattr(eng3.finalize(), f), getattr(two, f))


# ------------------------------------------------------------ heartbeat ----


def test_heartbeat_merge_wire_publish():
    """tests/test_obs.py:303's numbers, and the wire format equal to the
    reference's (keys, dtypes, values)."""
    a = cluster.beat(5, rows=100, t=1000.0)
    b = cluster.beat(7, rows=50, t=1002.5)
    m = state_mod.merge(a, b)
    assert int(m.hosts) == 2 and int(m.step) == 7 and int(m.rows) == 150

    rt = state_mod.from_arrays(state_mod.to_arrays(m), kinds=("hb",))
    assert int(rt.hosts) == 2 and float(rt.t_first) == 1000.0
    from repro.stream import state as jstate

    want = jstate.to_arrays(jstate.merge(jcluster.beat(5, rows=100, t=1000.0),
                                         jcluster.beat(7, rows=50, t=1002.5)))
    got = state_mod.to_arrays(m)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype and got[k] == want[k], k

    reg = obs.MetricsRegistry()
    vals = cluster.publish(cluster.gather(m), registry=reg, now=1010.0)
    assert vals["cluster.hosts"] == 2.0
    assert vals["cluster.heartbeat_age_s"] == pytest.approx(7.5)
    assert vals["cluster.straggler_lag_s"] == pytest.approx(2.5)
    cluster.publish_local(a, host=3, registry=reg)
    assert reg.gauge("cluster.host_step", host="3").value == 5.0


# ------------------------------------------------- the 2-process gloo run --

_SOURCE = """
import numpy as np
B, P = 32, 24

def source(seed, step, shard):
    rng = np.random.default_rng((seed or 0, step, shard))
    return rng.normal(size=(B, P)).astype(np.float32)
"""

_PORT = _SOURCE + """
import json, sys
import torch
torch.set_num_threads(2)
from repro_torch import cluster
from repro_torch.api import Plan, SparsifiedCov, SparsifiedKMeans, fit_many
from repro_torch.core import sketch as sketch_mod
from repro_torch.stream.engine import StreamEngine, StreamKMeansConfig
from repro_torch.utils import prng

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cluster.initialize(f"127.0.0.1:{port}", nproc, pid, device="cpu")
plan = Plan(backend="sharded", gamma=0.4, batch_size=B, n_shards=2)
cov = SparsifiedCov(plan, key=7, device="cpu")
km = SparsifiedKMeans(3, plan, key=7, algorithm="minibatch", device="cpu")
fit_many(plan, [cov, km], source=source, steps=5, seed=11)
spec = sketch_mod.make_spec(P, prng.PRNGKey(7), gamma=0.4)
eng = StreamEngine(spec, source, n_shards=2, mesh=cluster.process_mesh(2),
                   kmeans=StreamKMeansConfig(3, n_init=2, track_reassignments=True), device="cpu")
res = eng.run(5, seed=11)
out = {"mean": cov.mean_.tolist(), "cov_tr": float(cov.cov_.trace()), "count": int(cov.count_),
       "centers": km.centers_.tolist(), "reassign": km.reassign_counts_.tolist(),
       "eng_mean": res.mean.tolist(), "eng_cov_tr": float(res.cov.trace()),
       "eng_centers": res.centers.tolist(), "eng_count": int(res.count),
       "eng_reassign": res.reassign_counts.tolist(), "owned": eng._local}
print("RESULT" + json.dumps(out), flush=True)
cluster.shutdown()
"""

_REF = _SOURCE + """
import json
import jax
import numpy as np
from repro.api import Plan, SparsifiedCov, SparsifiedKMeans, fit_many
from repro.core import sketch as sketch_mod
from repro.stream.engine import StreamEngine, StreamKMeansConfig

mesh = jax.make_mesh((2,), ("data",))
plan = Plan(backend="sharded", gamma=0.4, batch_size=B, n_shards=2)
cov = SparsifiedCov(plan, key=7)
km = SparsifiedKMeans(3, plan, key=7, algorithm="minibatch")
fit_many(plan, [cov, km], source=source, steps=5, seed=11)
spec = sketch_mod.make_spec(P, jax.random.PRNGKey(7), gamma=0.4)
eng = StreamEngine(spec, source, n_shards=2, mesh=mesh,
                   kmeans=StreamKMeansConfig(3, n_init=2, track_reassignments=True))
res = eng.run(5, seed=11)
out = {"mean": np.asarray(cov.mean_).tolist(), "cov_tr": float(np.trace(np.asarray(cov.cov_))),
       "count": int(cov.count_), "centers": np.asarray(km.centers_).tolist(),
       "reassign": np.asarray(km.reassign_counts_).tolist(),
       "eng_mean": np.asarray(res.mean).tolist(), "eng_cov_tr": float(np.trace(np.asarray(res.cov))),
       "eng_centers": np.asarray(res.centers).tolist(), "eng_count": int(res.count),
       "eng_reassign": np.asarray(res.reassign_counts).tolist()}
print("RESULT" + json.dumps(out))
"""


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    # the port's workers draw in the layout the reference's subprocess runs with
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_TORCH_THREEFRY_PARTITIONABLE=str(int(jax.config.jax_threefry_partitionable)),
               **kw)
    return env


@pytest.mark.slow
def test_two_process_gloo_matches_reference_two_devices(tmp_path):
    """Two OS processes over gloo, each folding its own shard, against the
    reference's sharded run on 2 forced host devices (the subprocess pattern
    of tests/test_cluster.py:132)."""
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(_PORT))
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid), "2", str(port)],
                              env=_env(OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for pid in range(2)]
    ref_out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=2"))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, e) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{e[-4000:]}"
    assert ref_out.returncode == 0, ref_out.stderr[-4000:]
    got = [json.loads(o.split("RESULT", 1)[1]) for o, _ in outs]
    ref = json.loads(ref_out.stdout.split("RESULT", 1)[1])

    assert got[0]["owned"] == [0] and got[1]["owned"] == [1]
    for k in ("mean", "centers", "eng_mean", "eng_centers", "cov_tr", "eng_cov_tr"):
        assert got[0][k] == got[1][k], k             # every process holds the same state
    for k in ("mean", "centers", "eng_mean", "eng_centers"):
        np.testing.assert_allclose(got[0][k], ref[k], atol=1e-5)
    for k in ("cov_tr", "eng_cov_tr"):
        np.testing.assert_allclose(got[0][k], ref[k], rtol=1e-5)
    assert got[0]["count"] == ref["count"] == 5 * 2 * 32
    assert got[0]["eng_count"] == ref["eng_count"]
    assert got[0]["reassign"] == ref["reassign"]
    assert got[0]["eng_reassign"] == ref["eng_reassign"]


@pytest.mark.slow
def test_launcher_two_processes_resume_and_heartbeat(tmp_path):
    """python -m repro_torch.launch.cluster on the CPU: 2 ranks over gloo
    equal the one-process sharded engine; a checkpoint after step 2 and
    --resume to step 4 give the uninterrupted run's bits; --log-every
    publishes cluster.hosts == 2; a failing rank fails the coordinator."""
    from repro_torch import api
    from repro_torch.data.pipeline import VectorStreamSource

    base = [sys.executable, "-m", "repro_torch.launch.cluster", "--nproc", "2",
            "--device", "cpu", "--p", "64", "--batch", "32", "--steps", "4",
            "--kmeans-k", "3", "--track-reassignments"]

    def run(*extra, timeout=240):
        return subprocess.run(base + list(extra), cwd=ROOT, env=_env(), capture_output=True,
                              text=True, timeout=timeout)

    full = run("--out", str(tmp_path / "full.npz"), "--log-every", "2")
    assert full.returncode == 0, full.stderr[-4000:]
    assert "dist backend: gloo, world 2" in full.stdout
    assert "heartbeat: hosts=2 step=4" in full.stdout
    ck = str(tmp_path / "ck")
    first = run("--steps", "2", "--ckpt-dir", ck, "--ckpt-every", "2")
    assert first.returncode == 0, first.stderr[-4000:]
    resumed = run("--ckpt-dir", ck, "--resume", "--out", str(tmp_path / "resumed.npz"))
    assert resumed.returncode == 0, resumed.stderr[-4000:]
    a, b = np.load(tmp_path / "full.npz"), np.load(tmp_path / "resumed.npz")
    for k in ("mean", "centers", "cov_diag", "cov_sha256", "count", "reassign_total"):
        assert np.array_equal(a[k], b[k]), k

    plan = api.Plan(backend="sharded", gamma=0.1, batch_size=32, n_shards=2)
    one = api.make_engine(plan, 64, 1, VectorStreamSource(p=64, batch=32, seed=0),
                          kmeans=StreamKMeansConfig(k=3, track_reassignments=True),
                          device="cpu").run(4, seed=0)
    np.testing.assert_allclose(a["mean"], one.mean.numpy(), atol=1e-5)
    np.testing.assert_allclose(a["centers"], one.centers.numpy(), atol=1e-5)
    np.testing.assert_allclose(a["cov_trace"], float(one.cov.trace()), rtol=1e-5)
    assert np.array_equal(a["reassign_total"], one.reassign_total)

    bad = run("--resume", timeout=120)           # --resume without --ckpt-dir
    assert bad.returncode != 0
