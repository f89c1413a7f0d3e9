"""Data-parallel training in repro_torch against the reference's
single-device run on the CPU: the trainer over 2 gloo ranks
(``tests/torch_dp_worker.py``), and ``python -m repro_torch.launch.train
--devices 2`` with its checkpoints.

The reference cannot run across devices here (its ``tests/
test_distributed.py`` multi-device tests fail on this host), so the ranks
are held against its single-device step on the global batch, which is what
the data-parallel step computes in exact arithmetic: each rank's gradient is
its block's, the shared-mask exchange averages the kept values, and the
ranks' mean residual is the single-device residual. The bounds are
``tests/test_torch_train.py::test_train_steps_match_reference``'s (its
module docstring derives them), in both threefry layouts: under JAX's
original one each compared step starts from the port's state, the ranks'
mean residual carried into the reference.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker
from repro.configs.registry import get_arch as jget_arch
from repro.core.grad_compress import CompressConfig as JCompressConfig
from repro.data.pipeline import SyntheticLMSource as JSource
from repro.launch import train as jlaunch
from repro.models.api import get_api as jget_api
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.cluster.bootstrap import Mesh
from repro_torch.configs.registry import get_arch
from repro_torch.core.grad_compress import CompressConfig
from repro_torch.models.api import get_api, params_from_reference
from repro_torch.train import checkpoint, fsdp, optimizer, trainer
from repro_torch.utils.tree import tree_leaves_with_path, tree_map
from test_torch_train import LR, _as_jax, _as_torch, _params_close, _params_near_eps, _rel
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads, as tests/test_torch_train.py's."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mean_residual(outs, step):
    """The ranks' mean residual after ``step``, leaf by leaf, in float32 and
    cast back to the leaves' dtype (as ``checkpoint.save`` stores it)."""
    trees = [o["steps"][step]["state"]["residual"] for o in outs]
    return tree_map(lambda *r: (sum(t.float() for t in r) / len(r)).to(r[0].dtype), *trees)


@pytest.mark.parametrize("accum,gamma,dtype", [(1, 0.1, "float32"), (2, 0.1, "float32"),
                                               (1, 0.0, "float32"), (1, 0.1, "bfloat16")])
def test_dp_trainer_matches_reference(accum, gamma, dtype, tmp_path):
    """3 steps of a reduced gemma3-1b on 2 ranks (blocks of 2 of the 4 rows)
    against the reference's make_train_fn on the 4 rows, compressed (the
    shared-mask exchange) or not (the gradient all-reduced whole): loss,
    grad_norm (and nll) within 1e-5 relative (bf16: 1e-3, 2e-3), lr and
    wire_floats equal, the ranks' parameters and moments bit-equal, their
    mean residual within 1e-5 of the reference residual's largest entry
    (bf16: 3e-2 of its norm), the parameters within test_torch_train's
    bounds."""
    _dp_against_reference("gemma3-1b", {"dtype": dtype}, accum, gamma, tmp_path)


@pytest.mark.parametrize("arch,accum", [("qwen3-moe-235b-a22b", 1), ("kimi-k2-1t-a32b", 2)])
def test_dp_trainer_moe_matches_reference(arch, accum, tmp_path):
    """The moe family on 2 ranks against the reference's one call over the
    global batch, at capacity factor 100 (nothing drops, so the ranks'
    capacities change nothing): the routers' statistics averaged over the
    ranks give the global (micro-)batch's aux — within 1e-5 relative like
    the loss and nll — and its gradient, through the trainer's mean of the
    ranks' gradients; the rest as test_dp_trainer_matches_reference's."""
    _dp_against_reference(arch, {"capacity_factor": 100.0}, accum, 0.1, tmp_path)


def _dp_against_reference(arch, changes, accum, gamma, tmp_path):
    """3 steps of ``arch``'s reduced config (with ``changes``) on 2 ranks
    against the reference's single device, as test_dp_trainer_matches_reference
    states."""
    jcfg = dataclasses.replace(jget_arch(arch, reduced=True), **changes)
    cfg = dataclasses.replace(get_arch(arch, reduced=True), **changes)
    bf16 = cfg.dtype == "bfloat16"
    key = jax.random.PRNGKey(0)
    opt = dict(peak_lr=LR, warmup_steps=1, total_steps=3)
    jt = jtrainer.TrainerConfig(opt=jopt.OptConfig(**opt), accum_steps=accum, q_chunk=16,
                                kv_chunk=16, compress=JCompressConfig(gamma=gamma) if gamma else None)
    tkw = dict(opt=optimizer.OptConfig(**opt), accum_steps=accum, q_chunk=16, kv_chunk=16,
               compress=CompressConfig(gamma=gamma) if gamma else None, dp_only=True)
    japi = jget_api(jcfg)
    jstate = jtrainer.init_state(japi, jt, key)
    kd = np.asarray(jax.random.key_data(key))
    state = trainer.init_state(get_api(cfg), trainer.TrainerConfig(**tkw), kd, device="cpu")
    state["params"] = params_from_reference(jax.tree.map(np.asarray, jstate["params"]), cfg,
                                            device="cpu")
    source = JSource(cfg.vocab_size, 32, 4, seed=0)
    batches = [{k: torch.from_numpy(np.array(v)) for k, v in source.next_batch().items()}
               for _ in range(3)]
    outs = torch_dp_worker.run("train", dict(cfg=cfg, tcfg=tkw, key=kd, state=state,
                                             batches=batches), 2, str(tmp_path),
                               jax.config.jax_threefry_partitionable)
    jfn = jtrainer.make_train_fn(japi, jt, jtrainer.NO_DIST, key)
    carried = not jax.config.jax_threefry_partitionable
    before = state
    for step, batch in enumerate(batches):
        got = outs[0]["steps"][step]
        for name, a in tree_leaves_with_path({k: v for k, v in got["state"].items()
                                              if k != "residual"}):
            b = dict(tree_leaves_with_path(outs[1]["steps"][step]["state"]))[name]
            assert torch.equal(a, b), f"the ranks' {name} differ at step {step}"
        assert got["metrics"] == outs[1]["steps"][step]["metrics"]
        start = tree_map(_as_jax, before) if carried else jstate
        jstate, jm = jfn(start, {k: v.numpy() for k, v in batch.items()})
        m = got["metrics"]
        assert sorted(m) == sorted(jm)
        extra = () if accum > 1 else ("nll", "aux") if cfg.family == "moe" else ("nll",)
        for name in ("loss", "grad_norm") + extra:
            tol = (2e-3 if name == "grad_norm" else 1e-3) if bf16 else 1e-5
            assert _rel(m[name], jm[name]) < tol, (step, name, m[name], float(jm[name]))
        assert m["lr"] == float(jm["lr"])
        assert not gamma or m["wire_floats"] == float(jm["wire_floats"])
        mean = _mean_residual(outs, step) if gamma else None
        num = den = 0.0
        for (name, r), (_, q) in zip(tree_leaves_with_path(mean),
                                     tree_leaves_with_path(jstate.get("residual"))):
            q = _as_torch(q)
            assert r.dtype == q.dtype, name
            if bf16:
                num += float(((r.float() - q.float()) ** 2).sum())
                den += float((q.float() ** 2).sum())
            else:
                np.testing.assert_allclose(r.numpy(), q.numpy(), rtol=0,
                                           atol=1e-5 * float(q.abs().max()), err_msg=name)
        assert num <= (3e-2) ** 2 * den, (step, (num / den) ** 0.5 if den else num)
        if carried:
            flipped, total = _params_near_eps(got["state"]["params"], jstate["params"],
                                              jstate["opt"]["v"], step, tkw["opt"])
            assert not bf16 or flipped <= 3e-2 * total, (step, flipped, total)
        else:
            flipped, total = _params_close(got["state"]["params"], jstate["params"], step + 1,
                                           bf16)
            assert flipped <= (3e-2 if bf16 else 1e-4) * total, (step, flipped, total)
        before = dict(got["state"], residual=mean) if gamma else got["state"]


def test_bf16_residual_resumes_bit_equal(tmp_path):
    """A bf16 model trained without accumulation keeps its residual's
    matrices in bf16 (the gradients' dtype, as the reference's); its
    checkpoint restores into init_state's float32 residual exactly, and the
    next step equals the uninterrupted one bit for bit."""
    from repro_torch.data.pipeline import SyntheticLMSource

    cfg = dataclasses.replace(get_arch("gemma3-1b", reduced=True), dtype="bfloat16")
    api = get_api(cfg)
    tcfg = trainer.TrainerConfig(compress=CompressConfig(gamma=0.1), q_chunk=16, kv_chunk=16)
    key = np.zeros(2, np.uint32)
    fn = trainer.make_train_fn(api, tcfg, trainer.NO_DIST, key, device="cpu")
    src = SyntheticLMSource(cfg.vocab_size, 16, 2, seed=0)
    state, _ = fn(trainer.init_state(api, tcfg, key, device="cpu"), src.batch_for(0))
    assert state["residual"]["embed"].dtype == torch.bfloat16
    checkpoint.save(str(tmp_path), 1, state, async_=False)
    restored, _ = checkpoint.restore(str(tmp_path),
                                     trainer.init_state(api, tcfg, key, device="cpu"))
    assert restored["residual"]["embed"].dtype == torch.float32
    assert torch.equal(restored["residual"]["embed"], state["residual"]["embed"].float())
    a, ma = fn(state, src.batch_for(1))
    b, mb = fn(restored, src.batch_for(1))
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    for (name, x), (_, y) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b)):
        assert torch.equal(x, y), name


def _losses(text: str) -> list[tuple[int, float]]:
    return [(int(w[1]), float(w[3])) for w in (line.split() for line in text.splitlines())
            if w and w[0] == "step"]


def _summaries(text: str) -> list[dict]:
    return sorted((json.loads(line.split(" ", 1)[1]) for line in text.splitlines()
                   if line.startswith("rank-summary ")), key=lambda s: s["rank"])


def _launch(*flags) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2",
               REPRO_TORCH_THREEFRY_PARTITIONABLE=str(int(jax.config.jax_threefry_partitionable)))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          *flags], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _copy_step(src, dst, step):
    name = f"step_{step:09d}"
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(dst, "latest"), "w") as f:
        f.write(name)


def test_dp_launcher_matches_reference_and_resumes(tmp_path, capsys):
    """``launch.train --devices 2 --device cpu`` from the reference
    launcher's initial checkpoint prints the reference launcher's losses at
    one device (to its log line's 4 decimals); it places the state (FSDP),
    so each rank's collectives move its layout's bytes; its step-2
    checkpoint is the reference's tree (one residual), restores in the
    reference, resumes at 2 ranks bit for bit (losses, and the final
    checkpoint's every array) and restores at 1 rank, which continues with
    the 2-rank run's losses."""
    flags = ["--arch", "gemma3-1b", "--reduced", "--grad-compress-gamma", "0.1",
             "--batch", "4", "--seq", "32", "--log-every", "1"]
    jlaunch.main(flags + ["--steps", "0", "--ckpt-dir", str(tmp_path / "init")])
    for d in ("ref", "port"):
        shutil.copytree(tmp_path / "init", tmp_path / d)
    capsys.readouterr()
    jlaunch.main(flags + ["--steps", "4", "--ckpt-dir", str(tmp_path / "ref")])
    ref = capsys.readouterr().out
    port = _launch("--devices", "2", *flags, "--steps", "4", "--ckpt-dir", str(tmp_path / "port"),
                   "--ckpt-every", "2")
    assert "restored checkpoint at step 0" in port and port.rstrip().endswith("done")
    got, want = _losses(port), _losses(ref)
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2, 3]
    assert all(abs(a - b) <= 2e-4 for (_, a), (_, b) in zip(got, want)), (got, want)
    runs = _summaries(port)
    assert [s["rank"] for s in runs] == [0, 1] and runs[0]["losses"] == runs[1]["losses"]
    assert runs[0]["params_sha256"] == runs[1]["params_sha256"]
    api = get_api(get_arch("gemma3-1b", reduced=True))
    tcfg = trainer.TrainerConfig(compress=CompressConfig(gamma=0.1))
    mesh = Mesh((1, 2), ("data", "model"), owners=(0, 1), collective=True)
    for r, run in enumerate(runs):
        layout = dataclasses.replace(fsdp.Layout.of(trainer.abstract_state(api, tcfg), mesh),
                                     rank=r)
        assert layout.n_chunks == 11
        moved = run["exchange_bytes"]
        assert {k: moved[k] for k in ("fsdp-to-chunks", "fsdp-from-chunks")} == \
            {k: 4 * v for k, v in layout.chunk_bytes().items()}
        assert {"fsdp-all-gather", "fsdp-reduce-scatter", "fsdp-all-reduce"} < set(moved)

    # the step-2 checkpoint: the reference's layout, one residual
    ck = str(tmp_path / "port")
    _copy_step(ck, str(tmp_path / "at2"), 2)
    arrays, extra = checkpoint.load_arrays(str(tmp_path / "at2"))
    assert extra["pipeline"]["step"] == 2
    assert not any("rank_residual" in k for k in arrays)
    like = jtrainer.abstract_state(jget_api(jget_arch("gemma3-1b", reduced=True)),
                                   jtrainer.TrainerConfig(compress=JCompressConfig(gamma=0.1)))
    jstate, jextra = jckpt.restore(str(tmp_path / "at2"), like)
    assert jextra == extra and int(jstate["opt"]["step"]) == 2
    for k, v in jax.tree_util.tree_leaves_with_path(jstate):
        np.testing.assert_array_equal(np.asarray(v), arrays[jax.tree_util.keystr(k)])

    # resumed at 2 ranks: bit for bit
    _copy_step(ck, str(tmp_path / "resume"), 2)
    resumed = _launch("--devices", "2", *flags, "--steps", "4",
                      "--ckpt-dir", str(tmp_path / "resume"))
    assert "restored checkpoint at step 2" in resumed
    assert _summaries(resumed)[0]["losses"] == runs[0]["losses"][2:]
    final, _ = checkpoint.load_arrays(ck)
    again, _ = checkpoint.load_arrays(str(tmp_path / "resume"))
    assert sorted(final) == sorted(again) and not any("rank_residual" in k for k in final)
    for k in final:
        assert final[k].tobytes() == again[k].tobytes(), k

    # restored at 1 rank: the one residual, then the 2-rank run's losses
    _copy_step(ck, str(tmp_path / "one"), 2)
    state = trainer.init_state(api, tcfg, np.zeros(2, np.uint32), device="cpu")
    state, _ = checkpoint.restore(str(tmp_path / "one"), state)
    for name, t in tree_leaves_with_path(state["residual"]):
        np.testing.assert_array_equal(t.numpy(), arrays[f"['residual']{name}"])
    one = _launch(*flags, "--steps", "4", "--ckpt-dir", str(tmp_path / "one"))
    assert "restored checkpoint at step 2" in one
    got1 = _losses(one)
    assert [s for s, _ in got1] == [2, 3]
    assert all(abs(a - b) <= 2e-4 for (_, a), b in zip(got1, runs[0]["losses"][2:])), got1
