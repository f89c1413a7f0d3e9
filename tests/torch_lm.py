"""Helpers shared by the CPU parity tests of repro_torch's ssm, hybrid and
audio model families (``tests/test_torch_{ssm,hybrid,encdec}.py``).

Each test carries the reference's weights into the port, runs the same
numpy-seeded inputs through both and compares; the tolerances are the
callers'. The trainer comparison holds a compressed step from the reference's
state to ``tests/test_torch_train.py``'s bounds: losses, nll and grad_norm
within 1e-5 relative, ``lr`` and ``wire_floats`` exactly, the residual
within 1e-5 of its largest entry, and the parameters within 1e-6 except
where Adam's first step meets ε (at most 1e-4 of them, each within 2·lr).
"""
import contextlib
import dataclasses
import functools
import io
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core.grad_compress import CompressConfig as JCompressConfig
from repro.data.pipeline import SyntheticLMSource as JSource
from repro.launch import serve as jserve_launch
from repro.launch import train as jtrain_launch
from repro.models.api import get_api as jget_api
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs.registry import get_arch
from repro_torch.core.grad_compress import CompressConfig
from repro_torch.models import api as api_mod
from repro_torch.models.api import get_api, params_from_reference, params_to_reference
from repro_torch.models.transformer import NO_DIST
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import checkpoint, optimizer, trainer
from repro_torch.utils.host import from_host
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the models' many small ops slow down several
    times over when test workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def to_t(a) -> torch.Tensor:
    """A numpy array as a CPU tensor (copied where it is not contiguous)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def as_np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, rel, what=""):
    """|got − want| ≤ rel · max |want|, shapes equal."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1e-30, float(np.abs(want).max())),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str, dtype: str, seed: int):
    jcfg = dataclasses.replace(jget_arch(arch, reduced=True), dtype=dtype)
    return jcfg, jax.jit(jget_api(jcfg).init_params)(jax.random.PRNGKey(seed))


def models(arch: str, dtype: str = "float32", seed: int = 1):
    """(reference cfg, port cfg, reference params, the port's carried copy);
    the reference's draw is made once a process."""
    jcfg, jparams = _reference_params(arch, dtype, seed)
    cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype=dtype)
    return jcfg, cfg, jparams, carry(jparams, cfg)


def carry(jparams, cfg):
    return params_from_reference(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def same_tree(own, carried):
    """The port's own init has the reference's leaves: names, shapes, dtypes."""
    assert [(n, tuple(l.shape), l.dtype) for n, l in tree_leaves_with_path(own)] == \
        [(n, tuple(l.shape), l.dtype) for n, l in tree_leaves_with_path(carried)]


def grads_match(jloss_of, loss_of, jparams, params, rel=1e-5):
    """The loss, its nll and every gradient leaf within ``rel``; the leaves
    in the reference's order under the reference's names."""
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jloss_of, has_aux=True))(jparams)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, m = loss_of(params)
    grads = torch.autograd.grad(loss, leaves)
    close(loss, jloss, rel, "loss")
    close(m["nll"], jm["nll"], rel, "nll")
    for (jk, jg), (name, _), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                                      tree_leaves_with_path(params), grads):
        assert jax.tree_util.keystr(jk) == name
        close(g, jg, rel, name)
    for leaf in leaves:
        leaf.requires_grad_(False)


def carry_state(jstate, cfg) -> dict:
    """The reference's trainer state (params, AdamW's moments and step, the
    residual) as the port's tensors on the CPU."""
    return {k: carry(v, cfg) if k == "params" else
            tree_map(lambda a: from_host(np.asarray(a)), v) for k, v in jstate.items()}


def train_steps_match(arch: str, extra=None, steps: int = 1):
    """``steps`` compressed trainer steps of a reduced ``arch`` beside the
    reference's ``make_train_fn``, each from the reference's state before
    it (carried into the port): an entry where Adam's first step meets ε
    moves by up to lr on the last bits of its gradient, and a step taken
    from such a state would carry that into every gradient after it.
    ``extra(step, B, S)`` adds inputs (numpy) to a batch."""
    jcfg, cfg = jget_arch(arch, reduced=True), get_arch(arch, reduced=True)
    key = jax.random.PRNGKey(0)
    opt = dict(peak_lr=LR, warmup_steps=1, total_steps=steps)
    jt = jtrainer.TrainerConfig(opt=jopt.OptConfig(**opt), q_chunk=16, kv_chunk=16,
                                compress=JCompressConfig(gamma=0.1))
    t = trainer.TrainerConfig(opt=optimizer.OptConfig(**opt), q_chunk=16, kv_chunk=16,
                              compress=CompressConfig(gamma=0.1))
    japi, api = jget_api(jcfg), get_api(cfg)
    jstate = jtrainer.init_state(japi, jt, key)
    state = trainer.init_state(api, t, np.asarray(jax.random.key_data(key)), device="cpu")
    assert sorted(state) == sorted(jstate) and sorted(state["opt"]) == sorted(jstate["opt"])
    same_tree(state["params"], carry(jstate["params"], cfg))
    # run eagerly, as tests/test_torch_train.py runs it: jitted, XLA sums the
    # gradient norm in another order (4e-5 off in the reduced mamba2-1.3b)
    jfn = jtrainer.make_train_fn(japi, jt, jtrainer.NO_DIST, key)
    fn = trainer.make_train_fn(api, t, NO_DIST, np.asarray(jax.random.key_data(key)),
                               device="cpu")
    source = JSource(cfg.vocab_size, 32, 4, seed=0)
    n_chunks = -(-sum(l.size for l in jax.tree.leaves(jstate["params"])) // 16384)
    for step in range(steps):
        batch = {k: np.asarray(v) for k, v in source.next_batch().items()}
        if extra is not None:
            batch.update(extra(step, 4, 32))
        state = carry_state(jstate, cfg)
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = fn(state, batch)
        assert sorted(m) == sorted(jm)
        for name in ("loss", "nll", "grad_norm"):
            assert abs(float(m[name]) - float(jm[name])) <= 1e-5 * abs(float(jm[name])), \
                (step, name, float(m[name]), float(jm[name]))
        assert float(m["lr"]) == float(jm["lr"])
        assert float(m["wire_floats"]) == float(jm["wire_floats"]) == n_chunks * 1638
        for (name, r), (_, q) in zip(tree_leaves_with_path(state["residual"]),
                                     tree_leaves_with_path(jstate["residual"])):
            close(r, q, 1e-5, name)
        apart, total = 0, 0
        for (name, p), (_, q) in zip(tree_leaves_with_path(state["params"]),
                                     tree_leaves_with_path(jstate["params"])):
            d = np.abs(p.detach().numpy() - np.asarray(q))
            apart += int((d > 1e-6).sum())
            total += d.size
            assert float(d.max()) <= 2 * LR, name
        assert apart <= 1e-4 * total, (step, apart, total)
        assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == step + 1


def engine_matches(arch: str, prompts, max_new, n_slots=2, max_len=16):
    """``ServeEngine`` over ``prompts`` gives the reference engine's tokens."""
    jcfg, cfg, jparams, params = models(arch, seed=0)
    jeng = JServeEngine(jget_api(jcfg), jparams, n_slots=n_slots, max_len=max_len)
    eng = ServeEngine(get_api(cfg), params, n_slots=n_slots, max_len=max_len)
    for i, (pr, mx) in enumerate(zip(prompts, max_new)):
        jeng.submit(JRequest(rid=i, prompt=pr, max_new=mx))
        eng.submit(Request(rid=i, prompt=pr, max_new=mx))
    jdone, done = jeng.run(), eng.run()
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in jdone]
    assert all(r.done for r in done) and [len(r.out) for r in done] == list(max_new)
    return done, (get_api(cfg), params)


def serve_launcher_matches(arch: str, monkeypatch, capsys, dtype: str | None = None):
    """``python -m repro_torch.launch.serve --device cpu --arch <arch>
    --reduced --prompt-len 3 --gen 4`` with the reference launcher's weights
    (its init_params of PRNGKey(0), recorded as it draws them, carried)
    prints the reference's sample tokens.

    ``dtype`` replaces the reduced config's in both launchers, for an audio
    model: the cache each launcher builds has the reference's cross K/V
    within 1e-5 (its float32 frames run the encoder in float32), each decode
    step's logits are the reference's within 3e-2 of max |logit| (the bf16
    tolerance) on every row whose tokens agree so far, and a row's greedy
    token differs only at a near tie (the reference's top two within twice
    that)."""
    import repro.configs.registry as jregistry
    import repro.models.api as japi_mod
    import repro_torch.configs.registry as registry

    if dtype is not None:
        for mod in (jregistry, registry):
            monkeypatch.setattr(mod, "get_arch", lambda name, reduced=False, _get=mod.get_arch:
                                dataclasses.replace(_get(name, reduced), dtype=dtype))
    steps = {"ref": [], "port": []}         # each decode step's (logits, cache), with dtype

    def recorded(side, decode):
        def step(params, tok, cache, cur_len, *args, **kw):
            logits, new = decode(params, tok, cache, cur_len, *args, **kw)
            steps[side].append((as_np(logits), cache))
            return logits, new
        return decode if dtype is None else step

    drawn = []
    jreal = japi_mod.get_api

    def recording(cfg):
        a = jreal(cfg)
        return dataclasses.replace(a, init_params=lambda key: drawn.append(a.init_params(key))
                                   or drawn[-1], decode_fn=recorded("ref", a.decode_fn))

    monkeypatch.setattr(japi_mod, "get_api", recording)
    flags = ["--arch", arch, "--reduced", "--prompt-len", "3", "--gen", "4"]
    jserve_launch.main(flags)
    want = capsys.readouterr().out.splitlines()
    jparams, = drawn
    real = api_mod.get_api

    def carried(cfg):
        a = real(cfg)
        return dataclasses.replace(a, init_params=lambda seed, device="cuda": (
            params_from_reference(jax.tree.map(np.asarray, jparams), cfg, device)),
            decode_fn=recorded("port", a.decode_fn))

    monkeypatch.setattr(api_mod, "get_api", carried)
    from repro_torch.launch import serve as launch

    launch.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    name = jget_arch(arch, reduced=True).name
    assert got[0].startswith(f"arch={name} generated (4, 4) in ")
    assert got[1].startswith("sample tokens: [")
    if dtype is None:
        assert got[1] == want[1], (got, want)
        return
    assert len(steps["ref"]) == len(steps["port"]) == 4
    (_, jcache), (_, cache) = steps["ref"][0], steps["port"][0]
    for k in ("xk", "xv"):
        assert cache[k].dtype == torch.float32
        close(cache[k], jcache[k], 1e-5, k)
    rows = np.ones(len(steps["ref"][0][0]), bool)    # rows whose tokens agree so far
    for t, ((jl, _), (l, _)) in enumerate(zip(steps["ref"], steps["port"])):
        tol = 3e-2 * float(np.abs(jl[rows]).max())
        assert float(np.abs(l[rows] - jl[rows]).max()) <= tol, (t, rows)
        top2 = np.sort(jl, -1)[:, -2:]
        apart = rows & (l.argmax(-1) != jl.argmax(-1))
        assert (top2[apart, 1] - top2[apart, 0] <= 2 * tol).all(), (t, top2[apart])
        rows &= ~apart
    assert (got[1] == want[1]) == bool(rows[0]), (got, want)


def _log(text: str) -> list[tuple]:
    """The log lines' fields but the time: (step, loss, gnorm, lr) as printed."""
    return [(int(w[1]), float(w[3]), float(w[5]), w[7])
            for w in (line.split() for line in text.splitlines()) if w and w[0] == "step"]


def train_launcher_matches(arch: str, tmp_path, gnorm_rel: float | None = None):
    """``python -m repro_torch.launch.train --device cpu --arch <arch>
    --reduced --steps 3 --grad-compress-gamma 0.1`` from the reference
    launcher's initial checkpoint prints the reference's log lines: the
    steps and lr as printed, the loss (4 decimals) and gnorm (3) within one
    unit of the last printed digit (a float32 value that differs in its
    last bits can round either way, and Adam's ε-sensitive coordinates
    carry such differences into later steps); its final checkpoint restores
    in the reference. ``gnorm_rel``: the gnorm within that share of the
    reference's instead (the caller says why)."""
    from repro_torch.launch import train as launch

    flags = ["--arch", arch, "--reduced", "--grad-compress-gamma", "0.1", "--batch", "4",
             "--seq", "32", "--log-every", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        jtrain_launch.main(flags + ["--steps", "0", "--ckpt-dir", str(tmp_path / "init")])
    for d in ("ref", "port"):
        shutil.copytree(tmp_path / "init", tmp_path / d)
    outs = []
    for main, d, dev in ((jtrain_launch.main, "ref", []), (launch.main, "port", ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(flags + dev + ["--steps", "3", "--ckpt-dir", str(tmp_path / d)])
        outs.append(buf.getvalue())
    ref, port = outs
    assert "restored checkpoint at step 0" in port and port.rstrip().endswith("done")
    got, want = _log(port), _log(ref)
    assert [(s, lr) for s, _, _, lr in got] == [(s, lr) for s, _, _, lr in want] and \
        [s for s, *_ in got] == [0, 1, 2], (got, want)
    assert all(abs(a[1] - b[1]) <= 1.5e-4 and (
        abs(a[2] - b[2]) <= 1.5e-3 or gnorm_rel is not None
        and abs(a[2] - b[2]) <= gnorm_rel * b[2]) for a, b in zip(got, want)), (got, want)
    jcfg = jget_arch(arch, reduced=True)
    like = jtrainer.abstract_state(jget_api(jcfg),
                                   jtrainer.TrainerConfig(compress=JCompressConfig(gamma=0.1)))
    jstate, extra = jckpt.restore(str(tmp_path / "port"), like)
    assert extra["pipeline"]["step"] == 3 and int(jstate["opt"]["step"]) == 3


def checkpoint_round_trip(arch: str, tmp_path):
    """The reference's checkpoint of a reduced ``arch``'s parameters, in
    float32 and bfloat16, restored in the port (its names: ``shared``,
    ``enc_layers``, ``dec_layers`` …) and saved back: the reference reads
    the port's checkpoint bit for bit, and both write the same bytes."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg, jparams, _ = models(arch, dtype)
        jckpt.save(str(tmp_path / f"j{dtype}"), 1, jparams, async_=False)
        like = get_api(cfg).init_params(0, "cpu")
        got, _ = checkpoint.restore(str(tmp_path / f"j{dtype}"), like)
        for (name, a), (_, b) in zip(tree_leaves_with_path(got),
                                     tree_leaves_with_path(jax.tree.map(np.asarray, jparams))):
            assert a.dtype == like_leaf(like, name).dtype, name
            np.testing.assert_array_equal(params_to_reference({"x": a})["x"].view(np.uint8),
                                          np.asarray(b).view(np.uint8), err_msg=name)
        checkpoint.save(str(tmp_path / f"p{dtype}"), 1, got, async_=False)
        ja, _ = jckpt.load_arrays(str(tmp_path / f"j{dtype}"))
        pa, _ = jckpt.load_arrays(str(tmp_path / f"p{dtype}"))
        assert list(ja) == list(pa) == [n for n, _ in tree_leaves_with_path(got)]
        for k in ja:
            assert ja[k].dtype == pa[k].dtype and ja[k].tobytes() == pa[k].tobytes(), k
        if dtype == "float32":
            back, _ = jckpt.restore(str(tmp_path / f"p{dtype}"), jparams)
            for (name, a), (_, b) in zip(tree_leaves_with_path(back),
                                         tree_leaves_with_path(jparams)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def like_leaf(tree, name):
    return dict(tree_leaves_with_path(tree))[name]
