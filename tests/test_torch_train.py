"""repro_torch.train (AdamW, the trainer, tree checkpoints), the synthetic
token source and ``python -m repro_torch.launch.train`` against the
reference on the CPU.

The trainer runs 3 steps of a reduced gemma3-1b from the reference's weights
(carried by ``params_from_reference``) beside the reference's
``make_train_fn`` run eagerly (its jitted form reduces the gradient norm in
another order, 2e-4 off in this model). Losses, ``grad_norm`` and the
residual agree to 1e-5 relative; ``lr`` and ``wire_floats`` exactly.
Parameters agree to 1e-6, except where Adam's first step divides a gradient
entry near its ε (1e-8) by its own magnitude: there the update's size, up to
lr, depends on the entry's last bits. Those coordinates are counted (at most
1e-4 of the parameters) and each is held within 2·lr.

In bfloat16 (the full config's dtype) each library rounds its bf16 matmuls
and the fused elementwise chains between them its own way, so the gradients
differ by about bf16's unit roundoff u = 2^-8 entry by entry. Loss and nll
are held to 1e-3 relative, ``grad_norm`` to 2e-3 (u/2), the bf16 residual to
3e-2 of its norm, and the parameters after AdamW's bf16 cast each within
2·lr a step taken plus 2^-7 of the value (two bf16 ulps); those more than
one ulp apart (or 1e-6, for the float32 norm scales) are counted, at most 3%
of all after 3 steps: Adam's early steps are about sign(ĝ)·lr, so every
gradient entry near 0 that the rounding flips moves its coordinate by up
to 2·lr.

Under JAX's original threefry layout (``JAX_THREEFRY_PARTITIONABLE=0``) the
same seeds draw other tokens, and more of Adam's first-step coordinates meet
ε: 19 float32 coordinates after the first step, above the count's 1e-4. Two
trajectories run apart then carry them into every later gradient, past the
residual's 1e-5 (1.1e-5 at steps 1 and 2 with 2 micro-batches). So in that
layout each step starts from the port's state, carried into the reference
bit for bit, and ``_params_near_eps`` holds the parameters to bounds that
come from one AdamW step's arithmetic (its docstring derives them); the
other bounds are the ones above.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core.grad_compress import CompressConfig as JCompressConfig
from repro.data.pipeline import SyntheticLMSource as JSource
from repro.launch import train as jlaunch
from repro.models.api import get_api as jget_api
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs.registry import get_arch
from repro_torch.core.grad_compress import CompressConfig
from repro_torch.data.pipeline import SyntheticLMSource
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tr
from repro_torch.models.api import get_api, params_from_reference
from repro_torch.train import checkpoint, optimizer, trainer
from repro_torch.utils.device import PLACEMENT
from repro_torch.utils.host import to_host
from repro_torch.utils.tree import tree_leaves_with_path, tree_map
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3



@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the models' many small ops slow down several
    times over when test workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _as_torch(a) -> torch.Tensor:
    """A reference leaf as a tensor, a bfloat16 one bit for bit."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _params_close(params, jparams, steps, bf16):
    """(coordinates apart, all coordinates); asserts each coordinate's bound
    (the module docstring's)."""
    flipped, total = 0, 0
    for (name, p), (_, q) in zip(tree_leaves_with_path(params), tree_leaves_with_path(jparams)):
        p, q = p.detach(), _as_torch(q)
        assert p.dtype == q.dtype, name
        d = (p.float() - q.float()).abs()
        total += d.numel()
        if p.dtype == torch.bfloat16:
            # ulps apart: the difference of the int16 views of two values of one sign
            ulps = (p.view(torch.int16).int() - q.view(torch.int16).int()).abs()
            flipped += int(((ulps > 1) | (p.float() * q.float() < 0)).sum())
            assert bool((d <= 2 * LR * steps + q.float().abs() * 2.0**-7).all()), name
        else:
            flipped += int((d > 1e-6).sum())
            assert float(d.max()) <= 2 * LR * (steps if bf16 else 1), name
    return flipped, total


def _as_jax(t):
    """A port leaf as the reference's array, a bfloat16 one bit for bit."""
    a = to_host(t)
    return jnp.asarray(a.view(ml_dtypes.bfloat16) if a.dtype.kind == "V" else a)


# √v̂ of a float32 coordinate that one step may move more than 1e-6 apart,
# in units of AdamW's ε (``_params_near_eps``)
NEAR_EPS = 10


def _params_near_eps(params, jparams, jv, step, ocfg):
    """(coordinates apart, all coordinates) after one step from one state;
    asserts each coordinate's bound.

    Both packages apply p ← p − lr·(m̂/(√v̂ + ε) + wd·p) to the same p. Where
    √v̂ ≫ ε the direction m̂/(√v̂ + ε) does not depend on the gradients'
    scale, and gradients a few float32 units apart move it by about as
    much: far below the 1e-3 (1e-6 / lr) that puts two parameters 1e-6
    apart. Where √v̂ is within a few ε of 0 (at the first step √v̂ = |ĝ|),
    the ε term sets the direction, whose derivative ε/(|ĝ| + ε)² in ĝ is up
    to 1/ε: a gradient entry's last bits can move it by up to 2 (up to lr
    each way, 2·lr apart). So a float32 coordinate more than 1e-6 apart must
    have the reference's √v̂ within NEAR_EPS·ε (the 19 of the first step
    have |ĝ| ≤ 6·ε), and each is within 2·lr. A bf16 coordinate is within
    2·lr plus half a bf16 unit of each of the two values (2^-8·(|p| + |q|):
    both packages round p − lr·(…) to bf16, each its own value); those more
    than one unit apart, and float32 ones of a bf16 model more than 1e-6
    apart (its gradients are bf16 roundings apart), are counted."""
    flipped, total = 0, 0
    bf16 = any(p.dtype == torch.bfloat16 for _, p in tree_leaves_with_path(params))
    for (name, p), (_, q), (_, v) in zip(tree_leaves_with_path(params),
                                         tree_leaves_with_path(jparams),
                                         tree_leaves_with_path(jv)):
        p, q = p.detach(), _as_torch(q)
        assert p.dtype == q.dtype, name
        d = (p.float() - q.float()).abs()
        total += d.numel()
        if p.dtype == torch.bfloat16:
            ulps = (p.view(torch.int16).int() - q.view(torch.int16).int()).abs()
            flipped += int(((ulps > 1) | (p.float() * q.float() < 0)).sum())
            assert bool((d <= 2 * LR + 2.0**-8 * (p.float().abs() + q.float().abs())).all()), name
            continue
        assert float(d.max()) <= 2 * LR, name
        if bf16:
            flipped += int((d > 1e-6).sum())
            continue
        sv = np.sqrt(np.asarray(v, np.float64) / (1 - ocfg.b2 ** (step + 1)))
        apart = d.numpy() > 1e-6
        assert bool((sv[apart] <= NEAR_EPS * ocfg.eps).all()), \
            (name, float(sv[apart].max()) / ocfg.eps)
    return flipped, total


@pytest.mark.parametrize("accum,gamma,dtype", [(1, 0.1, "float32"), (1, 0.0, "float32"),
                                               (2, 0.1, "float32"), (1, 0.1, "bfloat16")])
def test_train_steps_match_reference(accum, gamma, dtype):
    jcfg = dataclasses.replace(jget_arch("gemma3-1b", reduced=True), dtype=dtype)
    cfg = dataclasses.replace(get_arch("gemma3-1b", reduced=True), dtype=dtype)
    bf16 = dtype == "bfloat16"
    key = jax.random.PRNGKey(0)
    opt = dict(peak_lr=LR, warmup_steps=1, total_steps=3)
    jt = jtrainer.TrainerConfig(opt=jopt.OptConfig(**opt), accum_steps=accum, q_chunk=16,
                                kv_chunk=16,
                                compress=JCompressConfig(gamma=gamma) if gamma else None)
    t = trainer.TrainerConfig(opt=optimizer.OptConfig(**opt), accum_steps=accum, q_chunk=16,
                              kv_chunk=16, compress=CompressConfig(gamma=gamma) if gamma else None)
    japi, api = jget_api(jcfg), get_api(cfg)
    jstate = jtrainer.init_state(japi, jt, key)
    state = trainer.init_state(api, t, np.asarray(jax.random.key_data(key)), device="cpu")
    assert sorted(state) == sorted(jstate) and sorted(state["opt"]) == sorted(jstate["opt"])
    state["params"] = params_from_reference(jax.tree.map(np.asarray, jstate["params"]), cfg,
                                               device="cpu")
    jfn = jtrainer.make_train_fn(japi, jt, jtrainer.NO_DIST, key)
    fn = trainer.make_train_fn(api, t, tr.NO_DIST, np.asarray(jax.random.key_data(key)),
                               device="cpu")
    source = JSource(cfg.vocab_size, 32, 4, seed=0)
    # the module docstring's two layouts
    carried = not jax.config.jax_threefry_partitionable
    for step in range(3):
        batch = source.next_batch()
        jstate, jm = jfn(tree_map(_as_jax, state) if carried else jstate, batch)
        state, m = fn(state, {k: np.asarray(v) for k, v in batch.items()})
        assert sorted(m) == sorted(jm)
        for name in ("loss", "grad_norm") + (("nll",) if accum == 1 else ()):
            tol = (2e-3 if name == "grad_norm" else 1e-3) if bf16 else 1e-5
            assert _rel(m[name], jm[name]) < tol, (step, name, float(m[name]), float(jm[name]))
        assert float(m["lr"]) == float(jm["lr"])
        if gamma:
            assert float(m["wire_floats"]) == float(jm["wire_floats"]) == 11 * 1638
            num = den = 0.0
            for (name, r), (_, q) in zip(tree_leaves_with_path(state["residual"]),
                                         tree_leaves_with_path(jstate["residual"])):
                q = _as_torch(q)
                # the new residual takes the gradients' dtypes, in both packages
                assert r.dtype == q.dtype, name
                assert bf16 or r.dtype == torch.float32, name
                if bf16:
                    num += float(((r.float() - q.float()) ** 2).sum())
                    den += float((q.float() ** 2).sum())
                else:
                    np.testing.assert_allclose(r.numpy(), q.numpy(), rtol=0,
                                               atol=1e-5 * float(q.abs().max()), err_msg=name)
            assert num <= (3e-2) ** 2 * den, (step, (num / den) ** 0.5)
        if carried:
            flipped, total = _params_near_eps(state["params"], jstate["params"],
                                              jstate["opt"]["v"], step, t.opt)
            assert not bf16 or flipped <= 3e-2 * total, (step, flipped, total)
        else:
            flipped, total = _params_close(state["params"], jstate["params"], step + 1, bf16)
            assert flipped <= (3e-2 if bf16 else 1e-4) * total, (step, flipped, total)
        assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == step + 1


def test_vlm_train_steps_match_reference():
    """qwen2-vl-2b reduced, 2 compressed steps beside the reference's
    ``make_train_fn``, each batch with M-RoPE positions on a (t, h, w) grid
    and vision embeddings: loss, nll and grad_norm within 1e-5 relative,
    the residual within 1e-5 of its largest entry, parameters as
    ``_params_close`` holds them, the count of those more than 1e-6 apart
    at most 2e-4 of the 106,816 (1e-4 would allow 10; step 1 moves 11, the
    largest by 6.8e-5, where Adam's first step meets ε)."""
    jcfg, cfg = jget_arch("qwen2-vl-2b", reduced=True), get_arch("qwen2-vl-2b", reduced=True)
    key = jax.random.PRNGKey(0)
    opt = dict(peak_lr=LR, warmup_steps=1, total_steps=2)
    jt = jtrainer.TrainerConfig(opt=jopt.OptConfig(**opt), q_chunk=16, kv_chunk=16,
                                compress=JCompressConfig(gamma=0.1))
    t = trainer.TrainerConfig(opt=optimizer.OptConfig(**opt), q_chunk=16, kv_chunk=16,
                              compress=CompressConfig(gamma=0.1))
    japi, api = jget_api(jcfg), get_api(cfg)
    jstate = jtrainer.init_state(japi, jt, key)
    state = trainer.init_state(api, t, np.asarray(jax.random.key_data(key)), device="cpu")
    state["params"] = params_from_reference(jax.tree.map(np.asarray, jstate["params"]), cfg,
                                               device="cpu")
    jfn = jtrainer.make_train_fn(japi, jt, jtrainer.NO_DIST, key)
    fn = trainer.make_train_fn(api, t, tr.NO_DIST, np.asarray(jax.random.key_data(key)),
                               device="cpu")
    source = JSource(cfg.vocab_size, 32, 4, seed=0)
    nv, rng = cfg.n_vision_tokens, np.random.default_rng(7)
    pos = np.broadcast_to(np.arange(32)[None, None], (3, 4, 32)).copy()
    pos[0, :, 1:1 + nv], pos[1, :, 1:1 + nv], pos[2, :, 1:1 + nv] = \
        1, 1 + np.arange(nv) // 4, 1 + np.arange(nv) % 4
    for step in range(2):
        batch = {k: np.asarray(v) for k, v in source.next_batch().items()}
        batch["positions"] = pos.astype(np.int32)
        batch["vision_embeds"] = rng.normal(size=(4, nv, cfg.d_model)).astype(np.float32)
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = fn(state, batch)
        for name in ("loss", "nll", "grad_norm"):
            assert _rel(m[name], jm[name]) < 1e-5, (step, name, float(m[name]), float(jm[name]))
        for (name, r), (_, q) in zip(tree_leaves_with_path(state["residual"]),
                                     tree_leaves_with_path(jstate["residual"])):
            np.testing.assert_allclose(r.numpy(), np.asarray(q), rtol=0,
                                       atol=1e-5 * float(np.abs(np.asarray(q)).max()),
                                       err_msg=name)
        flipped, total = _params_close(state["params"], jstate["params"], step + 1, False)
        assert flipped <= 2e-4 * total, (step, flipped, total)


def test_optimizer_factored_and_momentum_free():
    """``factored=True`` (row/column second moments) and ``momentum=False``
    over three updates of a stacked tree, against the reference's."""
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(3, 8, 6)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32),
            "e": rng.normal(size=(10, 4)).astype(np.float32)}
    for kw in (dict(factored=True), dict(momentum=False), dict(moment_dtype="bfloat16")):
        cfg = optimizer.OptConfig(peak_lr=LR, warmup_steps=2, total_steps=5, **kw)
        jcfg = jopt.OptConfig(peak_lr=LR, warmup_steps=2, total_steps=5, **kw)
        params = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
        jparams = jax.tree.map(jnp.asarray, tree)
        state, jstate = optimizer.init_opt_state(params, cfg), jopt.init_opt_state(jparams, jcfg)
        for step in range(3):
            g = jax.tree.map(lambda a: (a * (step + 1) * 0.3).astype(np.float32), tree)
            params, state, st = optimizer.adamw_update(
                jax.tree.map(torch.from_numpy, g), params, state, cfg)
            jparams, jstate, jst = jopt.adamw_update(jax.tree.map(jnp.asarray, g), jparams,
                                                     jstate, jcfg)
            assert _rel(st["grad_norm"], jst["grad_norm"]) < 1e-6
            assert _rel(st["lr"], jst["lr"]) < 1e-6
            for (name, p), (_, q) in zip(tree_leaves_with_path(params),
                                         tree_leaves_with_path(jparams)):
                np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=0, atol=1e-6,
                                           err_msg=f"{kw} {name}")
        assert [n for n, _ in tree_leaves_with_path(state)] == \
            [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(jstate)]
    for step in (0, 50, 99, 100, 101, 500, 999, 1000, 2000):
        s = torch.tensor(step, dtype=torch.int32)
        assert _rel(optimizer.lr_at(s, optimizer.OptConfig()),
                    jopt.lr_at(jnp.int32(step), jopt.OptConfig())) < 1e-6


def test_synthetic_lm_source_tokens():
    src, jsrc = SyntheticLMSource(1000, 24, 3, seed=7), JSource(1000, 24, 3, seed=7)
    for _ in range(3):
        b, jb = src.next_batch(), jsrc.next_batch()
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    np.testing.assert_array_equal(src.batch_for(1)["tokens"].numpy(),
                                  np.asarray(jsrc.batch_for(1)["tokens"]))
    assert src.state.to_json() == jsrc.state.to_json() == {"seed": 7, "step": 3}


def _state_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"layers": {"w": rng.normal(size=(2, 3, 4)).astype(np.float32)},
                       "embed": rng.normal(size=(5, 4)).astype(np.float32)},
            "opt": {"step": np.asarray(6, np.int32),
                    "m": {"layers": {"w": rng.normal(size=(2, 3, 4)).astype(np.float32)},
                          "embed": rng.normal(size=(5, 4)).astype(np.float32)}}}


def test_checkpoints_both_ways(tmp_path):
    """A port checkpoint restores in the reference and the reference's in the
    port, bit for bit; with a bfloat16 leaf the two write the same bytes (the
    reference reads its own bf16 leaves back only as |V2 words)."""
    t = _state_tree()
    ported = jax.tree.map(torch.from_numpy, t)
    checkpoint.save(str(tmp_path / "p"), 6, ported, extra={"pipeline": {"seed": 0, "step": 6}},
                    async_=False)
    back, extra = jckpt.restore(str(tmp_path / "p"), jax.tree.map(jnp.asarray, t))
    assert extra == {"pipeline": {"seed": 0, "step": 6}}
    for (n, a), (_, b) in zip(tree_leaves_with_path(back), tree_leaves_with_path(t)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=n)
    jckpt.save(str(tmp_path / "j"), 6, jax.tree.map(jnp.asarray, t), async_=False)
    like = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(a).dtype), t)
    got, _ = checkpoint.restore(str(tmp_path / "j"), like)
    for (n, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(t)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    # bfloat16 both ways
    w = t["params"]["layers"]["w"]
    jt = jax.tree.map(jnp.asarray, t)
    jt["params"]["layers"]["w"] = jnp.asarray(w, jnp.bfloat16)
    pt = jax.tree.map(torch.from_numpy, t)
    pt["params"]["layers"]["w"] = torch.from_numpy(w).to(torch.bfloat16)
    jckpt.save(str(tmp_path / "jb"), 1, jt, async_=False)
    checkpoint.save(str(tmp_path / "pb"), 1, pt, async_=False)
    ja, jmeta = jckpt.load_arrays(str(tmp_path / "jb"))
    pa, _ = jckpt.load_arrays(str(tmp_path / "pb"))
    for d in ("jb", "pb"):
        with open(tmp_path / d / "step_000000001" / "manifest.json") as f:
            meta = json.load(f)
        assert meta["dtypes"]["['params']['layers']['w']"] == "bfloat16"
        assert list(meta["keys"]) == list(ja)
    for k in ja:
        assert ja[k].dtype == pa[k].dtype and ja[k].tobytes() == pa[k].tobytes(), k
    np.testing.assert_array_equal(
        pa["['params']['layers']['w']"].view(ml_dtypes.bfloat16).astype(np.float32),
        np.asarray(jt["params"]["layers"]["w"].astype(jnp.float32)))
    got, _ = checkpoint.restore(str(tmp_path / "jb"), pt)
    assert got["params"]["layers"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["layers"]["w"], pt["params"]["layers"]["w"])
    with pytest.raises(KeyError, match="missing leaf"):
        checkpoint.restore(str(tmp_path / "jb"), {"other": torch.zeros(1)})


@pytest.mark.parametrize("damage", [None, "bit", "compressed"])
def test_checkpoint_reader_matches_np_load(tmp_path, damage):
    """``load_arrays`` / ``restore`` read each member straight from the file:
    the same arrays as ``np.load`` (a scalar, a Fortran-ordered, an empty, a
    ``|V2`` and an ``ml_dtypes`` bfloat16 leaf); a flipped bit fails the
    member's CRC, and a compressed member, which neither package writes, is
    refused."""
    arrays = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
              "s": np.asarray(6, np.int32),
              "f": np.asfortranarray(np.arange(6.0).reshape(2, 3)),
              "e": np.zeros((0, 3), np.float32),
              "v": np.arange(10, dtype=np.int16).view("V2"),
              "b": np.asarray([1.5, 2.0], ml_dtypes.bfloat16)}
    d = tmp_path / "step_000000001"
    d.mkdir()
    (np.savez_compressed if damage == "compressed" else np.savez)(d / "arrays.npz", **arrays)
    (d / "manifest.json").write_text(json.dumps({"keys": list(arrays), "extra": {"x": 1}}))
    (tmp_path / "latest").write_text(d.name)
    if damage == "bit":
        raw = bytearray((d / "arrays.npz").read_bytes())
        raw[raw.find(arrays["a"].tobytes()) + 5] ^= 1
        (d / "arrays.npz").write_bytes(bytes(raw))
    if damage:
        with pytest.raises(ValueError, match="corrupt" if damage == "bit" else "stored"):
            checkpoint.load_arrays(str(tmp_path))
        return
    got, extra = checkpoint.load_arrays(str(tmp_path))
    assert extra == {"x": 1} and list(got) == list(arrays)
    with np.load(d / "arrays.npz") as want:
        for k in arrays:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k
            assert got[k].flags.f_contiguous == want[k].flags.f_contiguous, k


def _losses(text: str) -> list[tuple[int, float]]:
    return [(int(w[1]), float(w[3])) for w in (line.split() for line in text.splitlines())
            if w and w[0] == "step"]


def _port_launch(*flags) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2",
               REPRO_TORCH_THREEFRY_PARTITIONABLE=str(int(jax.config.jax_threefry_partitionable)))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          *flags], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_launcher_matches_reference_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --arch gemma3-1b
    --reduced --steps 4 --grad-compress-gamma 0.1`` from the reference
    launcher's initial checkpoint prints the reference's losses (its log line
    rounds them to 4 decimals); resumed from its own step-2 checkpoint it
    prints the uninterrupted run's last two losses exactly."""
    flags = ["--arch", "gemma3-1b", "--reduced", "--grad-compress-gamma", "0.1",
             "--batch", "4", "--seq", "32", "--log-every", "1"]
    jlaunch.main(flags + ["--steps", "0", "--ckpt-dir", str(tmp_path / "init")])
    for d in ("ref", "port"):
        shutil.copytree(tmp_path / "init", tmp_path / d)
    capsys.readouterr()
    jlaunch.main(flags + ["--steps", "4", "--ckpt-dir", str(tmp_path / "ref")])
    ref = capsys.readouterr().out
    port = _port_launch(*flags, "--steps", "4", "--ckpt-dir", str(tmp_path / "port"),
                        "--ckpt-every", "2")
    assert "restored checkpoint at step 0" in ref and "restored checkpoint at step 0" in port
    assert port.rstrip().endswith("done")
    got, want = _losses(port), _losses(ref)
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2, 3]
    assert all(abs(a - b) <= 2e-4 for (_, a), (_, b) in zip(got, want)), (got, want)
    # resume: the uninterrupted run's step-2 checkpoint, continued to step 4
    (tmp_path / "resume").mkdir()
    shutil.copytree(tmp_path / "port" / "step_000000002", tmp_path / "resume" / "step_000000002")
    (tmp_path / "resume" / "latest").write_text("step_000000002")
    resumed = _port_launch(*flags, "--steps", "4", "--ckpt-dir", str(tmp_path / "resume"))
    assert "restored checkpoint at step 2" in resumed
    assert _losses(resumed) == got[2:]
    # the launcher's final checkpoint restores in the reference
    like = jtrainer.abstract_state(jget_api(jget_arch("gemma3-1b", reduced=True)),
                                   jtrainer.TrainerConfig(compress=JCompressConfig(gamma=0.1)))
    jstate, extra = jckpt.restore(str(tmp_path / "port"), like)
    assert extra["pipeline"]["step"] == 4 and int(jstate["opt"]["step"]) == 4


def test_what_is_not_ported_raises():
    """What waits for ROADMAP's next LM item (parameter placement over a
    mesh's model axis) names it, for the moe family too; leading dense
    layers train; the pod meshes need their ranks; without a card the
    defaults raise."""
    with pytest.raises(ValueError, match="needs 256 ranks"):
        _run_main(["--arch", "gemma3-1b", "--mesh", "single", "--device", "cpu"])
    cfg = get_arch("gemma3-1b", reduced=True)
    for c in (cfg, get_arch("kimi-k2-1t-a32b", reduced=True)):
        with pytest.raises(NotImplementedError, match=PLACEMENT):
            trainer.make_train_fn(get_api(c), trainer.TrainerConfig(),
                                  trainer.make_dist(make_host_mesh(4, 2), c),
                                  np.zeros(2, np.uint32), device="cpu")
    pre = get_api(dataclasses.replace(cfg, first_k_dense=1))
    fn = trainer.make_train_fn(pre, trainer.TrainerConfig(), tr.NO_DIST, np.zeros(2, np.uint32),
                               device="cpu")
    state = trainer.init_state(pre, trainer.TrainerConfig(), np.zeros(2, np.uint32), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    _, metrics = fn(state, {"tokens": tokens, "labels": tokens})
    assert np.isfinite(float(metrics["loss"])) and float(metrics["aux"]) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trainer.make_train_fn(get_api(cfg), trainer.TrainerConfig(), tr.NO_DIST,
                                  np.zeros(2, np.uint32))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _run_main(["--arch", "gemma3-1b", "--reduced", "--steps", "1"])


def _run_main(argv):
    from repro_torch.launch import train as launch

    launch.main(argv)
