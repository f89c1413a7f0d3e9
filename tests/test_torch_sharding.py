"""repro_torch.launch.mesh, repro_torch.train.sharding, the trainer's
``make_dist`` / ``abstract_state`` / ``state_shardings`` and
``grad_compress.perworker_mean_estimate`` against the reference on the CPU.

The reference's sharding functions read a mesh only through ``.shape`` and
``.axis_names``, so both packages get the same stand-in object; its
``NamedSharding`` wrapper is replaced by the bare spec for the test, which
then holds the port's specs (tuples) to the reference's ``PartitionSpec``s
entry for entry, on every leaf of each ported config's full-width
parameters and state, on meshes (4, 2), (2, 4), (8, 1) and (2, 16, 16),
with and without ``dp_only``. The per-worker estimator runs on 2 and 4 gloo
ranks (``tests/torch_dp_worker.py``) against the reference's explicit
per-worker formula (``tests/test_distributed.py``'s), within 1e-5 of max
|value|.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from repro.configs.registry import get_arch as jget_arch
from repro.core import ros as jros
from repro.core.grad_compress import CompressConfig as JCompressConfig
from repro.core.grad_compress import mask_spec as jmask_spec
from repro.core.sampling import sample_indices as jsample
from repro.core.sketch import batch_key as jbatch_key
from repro.launch import mesh as jmesh
from repro.models.api import get_api as jget_api
from repro.train import sharding as jsharding
from repro.train import trainer as jtrainer
from repro_torch.cluster.bootstrap import Mesh
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.grad_compress import CompressConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.api import get_api
from repro_torch.train import sharding, trainer
from repro_torch.utils.tree import tree_leaves_with_path
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

PORTED = sorted(ARCHS)
MESHES = [((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((8, 1), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


def _standin(shape, axes):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=tuple(axes))


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's sharding functions return their PartitionSpecs."""
    for mod in (jsharding, jtrainer):
        monkeypatch.setattr(mod, "NamedSharding", lambda mesh, spec: spec)


def _pairs(got, want, path=""):
    """(name, port spec, reference spec) over two spec trees of dicts and
    lists (kimi's ``pre_layers``)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            yield from _pairs(g, w, f"{path}/{i}")
    else:
        yield path, got, want


def _assert_specs(got, want):
    n = 0
    for name, g, w in _pairs(got, want):
        assert isinstance(g, tuple) and w == g and len(w) == len(g), (name, g, w)
        n += 1
    return n


def test_host_mesh_geometry():
    """make_host_mesh over the one live process, dp_axes_of / tp_axis_of
    as the reference's, and the pod meshes refused without 256 / 512 ranks."""
    for shape in ((4, 2), (2, 4), (8, 1)):
        m = mesh_mod.make_host_mesh(*shape)
        assert isinstance(m, Mesh) and m.axis_names == ("data", "model")
        assert m.shape == dict(zip(("data", "model"), shape)) and m.size == 8
        assert m.owners == (0,) * 8 and not m.collective
    assert mesh_mod.make_host_mesh().shape == {"data": 4, "model": 2}
    for shape, axes in MESHES + [((4,), ("data",)), ((2, 2), ("pod", "data"))]:
        s = _standin(shape, axes)
        assert mesh_mod.dp_axes_of(s) == jmesh.dp_axes_of(s)
        assert mesh_mod.tp_axis_of(s) == jmesh.tp_axis_of(s)
    for multi in (False, True):
        with pytest.raises(ValueError, match="needs 256 ranks" if not multi else "needs 512"):
            mesh_mod.make_production_mesh(multi_pod=multi)


@pytest.mark.parametrize("arch", PORTED)
def test_param_and_state_specs_match_reference(arch, bare_specs):
    """Every leaf of the full-width parameters (shapes on the meta device,
    the reference's from jax.eval_shape) and of the compressed trainer's
    state, on every mesh, both dp_only values."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    tcfg = trainer.TrainerConfig(compress=CompressConfig(gamma=0.1))
    jtcfg = jtrainer.TrainerConfig(compress=JCompressConfig(gamma=0.1))
    state = trainer.abstract_state(get_api(cfg), tcfg)
    jstate = jtrainer.abstract_state(jget_api(jcfg), jtcfg)
    leaves = tree_leaves_with_path(state)
    assert all(t.device.type == "meta" for _, t in leaves)
    jleaves = jax.tree_util.tree_leaves_with_path(jstate)
    assert [n for n, _ in leaves] == [jax.tree_util.keystr(k) for k, _ in jleaves]
    assert [tuple(t.shape) for _, t in leaves] == [tuple(v.shape) for _, v in jleaves]
    n = 0
    for shape, axes in MESHES:
        mesh = _standin(shape, axes)
        for dp_only in (False, True):
            n += _assert_specs(sharding.param_shardings(state["params"], mesh, dp_only),
                               jsharding.param_shardings(jstate["params"], mesh, dp_only))
            n += _assert_specs(trainer.state_shardings(state, mesh, dp_only),
                               jtrainer.state_shardings(jstate, mesh, dp_only))
            for name, t in tree_leaves_with_path(state["params"]):
                path = "/".join(name[2:-2].split("']['"))
                scanned = path.startswith(("layers/", "enc_layers/", "dec_layers/"))
                assert jsharding.spec_for(path, tuple(t.shape), mesh, scanned, dp_only) == \
                    sharding.spec_for(path, tuple(t.shape), mesh, scanned, dp_only), path
    assert n >= 8 * len(leaves)


def test_factored_state_specs_match_reference(bare_specs):
    """Factored second moments take the reference's greedy specs."""
    from repro.train.optimizer import OptConfig as JOptConfig
    from repro_torch.train.optimizer import OptConfig

    cfg, jcfg = get_arch("gemma3-1b"), jget_arch("gemma3-1b")
    state = trainer.abstract_state(get_api(cfg), trainer.TrainerConfig(
        opt=OptConfig(factored=True)))
    jstate = jtrainer.abstract_state(jget_api(jcfg), jtrainer.TrainerConfig(
        opt=JOptConfig(factored=True)))
    for shape, axes in MESHES:
        mesh = _standin(shape, axes)
        _assert_specs(trainer.state_shardings(state, mesh), jtrainer.state_shardings(jstate, mesh))


def _batch(b):
    f = lambda *s: types.SimpleNamespace(shape=s)  # noqa: E731
    return {"tokens": f(b, 16), "labels": f(b, 16), "positions": f(3, b, 16),
            "vision_embeds": f(b, 4, 8), "frames": f(b, 16, 8), "scale": f()}


def _cache(b, s):
    f = lambda *sh: types.SimpleNamespace(shape=sh)  # noqa: E731
    return {"k": f(2, b, s, 2, 8), "v": f(2, b, s, 2, 8), "xk": f(2, b, s, 2, 8),
            "pre_v": f(2, b, s, 2, 8), "ssm": f(2, b, 8, 4, 4), "conv": f(2, b, 3, 16),
            "pos": f(b, 4), "len": f(3)}


def test_batch_and_cache_specs_match_reference(bare_specs):
    for shape, axes in MESHES:
        mesh = _standin(shape, axes)
        for b in (1, 6, 8, 32, 512):
            for dp_only in (False, True):
                _assert_specs(sharding.batch_shardings(_batch(b), mesh, dp_only),
                              jsharding.batch_shardings(_batch(b), mesh, dp_only))
            for s in (4, 16, 48):
                for seq in (False, True):
                    _assert_specs(sharding.cache_shardings(_cache(b, s), mesh, seq),
                                  jsharding.cache_shardings(_cache(b, s), mesh, seq))


def test_local_batch_blocks():
    """One process owns every position: the whole batch; a mesh whose
    positions two ranks own in turn gives rank 0 the first rows."""
    batch = {"tokens": np.arange(24).reshape(8, 3), "positions": np.zeros((3, 8, 3)),
             "scale": np.float32(2.0)}
    whole = sharding.local_batch(batch, mesh_mod.make_host_mesh(4, 2))
    np.testing.assert_array_equal(whole["tokens"].numpy(), batch["tokens"])
    halves = Mesh((4, 2), ("data", "model"), owners=[0, 0, 0, 0, 1, 1, 1, 1])
    got = sharding.local_batch(batch, halves)
    np.testing.assert_array_equal(got["tokens"].numpy(), batch["tokens"][:4])
    assert tuple(got["positions"].shape) == (3, 4, 3) and float(got["scale"]) == 2.0


def test_make_dist_fields():
    """make_dist's fields equal the reference's for every mesh, config and
    knob; a mesh with a model axis of more than one position refuses to
    train unless every axis carries data."""
    for shape, axes in MESHES:
        mesh = _standin(shape, axes)
        for arch in ("gemma3-1b", "glm4-9b", "qwen2-vl-2b", "mamba2-1.3b", "qwen3-moe-235b-a22b"):
            for sp, use_ep, dp_only in [(False, True, False), (True, False, False),
                                        (True, True, True)]:
                got = trainer.make_dist(mesh, get_arch(arch), sp=sp, use_ep=use_ep,
                                        dp_only=dp_only)
                want = jtrainer.make_dist(mesh, jget_arch(arch), sp=sp, use_ep=use_ep,
                                          dp_only=dp_only)
                for f in dataclasses.fields(want):
                    assert getattr(got, f.name) == getattr(want, f.name), (shape, arch, f.name)
                assert got.seq_axis == want.seq_axis
    assert trainer.make_dist(None, get_arch("gemma3-1b")) is trainer.NO_DIST
    cfg = get_arch("gemma3-1b", reduced=True)
    with pytest.raises(NotImplementedError, match="Expert and TP placement"):
        trainer.make_train_fn(get_api(cfg), trainer.TrainerConfig(),
                              trainer.make_dist(mesh_mod.make_host_mesh(4, 2), cfg),
                              np.zeros(2, np.uint32), device="cpu")


def test_trainer_config_fields_and_donate():
    """TrainerConfig has the reference's fields and defaults; with
    ``donate=False`` a step leaves the caller's state as it was and returns
    the state the donating step gives."""
    assert ([(f.name, f.default) for f in dataclasses.fields(trainer.TrainerConfig)
             if f.name not in ("opt", "compress")]
            == [(f.name, f.default) for f in dataclasses.fields(jtrainer.TrainerConfig)
                if f.name not in ("opt", "compress")])
    api = get_api(get_arch("gemma3-1b", reduced=True))
    batch = {k: np.random.default_rng(0).integers(0, api.cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    out = {}
    for donate in (True, False):
        tcfg = trainer.TrainerConfig(compress=CompressConfig(gamma=0.1), q_chunk=16, kv_chunk=16,
                                     donate=donate)
        state = trainer.init_state(api, tcfg, np.zeros(2, np.uint32), device="cpu")
        before = [t.clone() for _, t in tree_leaves_with_path(state)]
        new, _ = trainer.make_train_fn(api, tcfg, trainer.NO_DIST, np.zeros(2, np.uint32),
                                       device="cpu")(state, batch)
        kept = all(torch.equal(a, b) for a, (_, b) in zip(before, tree_leaves_with_path(state)))
        assert kept == (not donate)
        out[donate] = new
    for (name, a), (_, b) in zip(tree_leaves_with_path(out[True]), tree_leaves_with_path(out[False])):
        assert torch.equal(a, b), name


def _perworker_reference(grads, key, step, cfg, peers):
    """tests/test_distributed.py's explicit per-worker formula over the
    rows ``peers`` (shard id w ↦ row), padded to whole chunks."""
    spec = jmask_spec(cfg, key)
    signs_key = spec.signs_key()
    acc = 0.0
    for w, row in enumerate(peers):
        v = jnp.pad(jnp.asarray(grads[row]), (0, -grads.shape[1] % cfg.chunk_p))
        y = jros.precondition(v.reshape(-1, cfg.chunk_p), signs_key, "hadamard")
        idx = jsample(jbatch_key(spec, step, w), y.shape[0], cfg.chunk_p, cfg.m)
        vals = jnp.take_along_axis(y, idx, -1)
        scat = jnp.zeros_like(y).at[jnp.arange(y.shape[0])[:, None], idx].set(vals)
        acc = acc + scat * (cfg.chunk_p / cfg.m)
    return np.asarray(jros.unmix(acc / len(peers), signs_key, "hadamard").reshape(-1))


@pytest.mark.parametrize("world,mesh,axes", [
    (2, None, ("data",)),                                   # the default process group
    (4, ((4, 1), ("data", "model")), ("data",)),
    (4, ((2, 2), ("data", "model")), ("data",)),            # a mean over each model column
])
def test_perworker_estimate_matches_reference(world, mesh, axes, tmp_path):
    key = jax.random.PRNGKey(0)
    kw = dict(gamma=0.25, chunk_p=1 << 10, error_feedback=False, mode="per-worker")
    cfg = JCompressConfig(**kw)
    grads = np.random.default_rng(world).normal(size=(world, 3000)).astype(np.float32)
    job = dict(cfg=kw, key=np.asarray(jax.random.key_data(key)), step=3, mesh=mesh, axes=axes,
               grads=torch.from_numpy(grads))
    outs = torch_dp_worker.run("perworker", job, world, str(tmp_path),
                               jax.config.jax_threefry_partitionable)
    for rank, out in enumerate(outs):
        if mesh is None or mesh[0] == (4, 1):
            peers = list(range(world))
        else:                       # ranks (d, m): the ranks of this model column, by d
            peers = [d * 2 + rank % 2 for d in range(2)]
        want = _perworker_reference(grads, key, jnp.int32(3), cfg, peers)[:3000]
        est = out["est"].numpy()
        assert est.shape == (3000,)
        np.testing.assert_allclose(est, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
        # the ranks of one mean agree bit for bit
        np.testing.assert_array_equal(est, outs[peers[0]]["est"].numpy())
