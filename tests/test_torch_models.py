"""repro_torch.models (the dense and vlm families' training forward) against
repro.models on the CPU.

The reference's parameters (``init_lm_params``, stacked layers) are carried
into the port by ``params_from_reference``; the same tokens go through both.
Tolerances: logits and the loss within 1e-5 relative to their largest value,
every gradient leaf within 1e-5 of its largest entry (float32; the port's
matmuls and reductions round in other orders); ``flash_attention`` within
1e-6 relative at every (q_chunk, kv_chunk, window); a bfloat16 model's loss
within 1e-2 (bfloat16 matmuls, rounded as each library rounds them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch.configs import base
from repro_torch.configs.registry import ARCHS, get_arch, get_shape
from repro_torch.models import attention, transformer as tr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.api import get_api, params_from_reference, params_to_reference
from repro_torch.train.trainer import make_dist
from repro_torch.utils.device import PLACEMENT
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

DENSE = ["gemma3-1b", "glm4-9b", "phi3-medium-14b", "deepseek-coder-33b"]
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the models' many small ops slow down several
    times over when test workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1e-30, float(np.abs(want).max())))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _carry(jparams, cfg):
    return params_from_reference(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def test_configs_are_the_reference_copies():
    """Every config, full and reduced, and every shape equal the reference's."""
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in ARCHS:
        for reduced in (False, True):
            assert (dataclasses.asdict(get_arch(name, reduced))
                    == dataclasses.asdict(jget_arch(name, reduced)))
    for name, shape in base.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jbase.SHAPES[name])
        assert dataclasses.asdict(get_shape(name, True)) == dataclasses.asdict(shape.reduced())
        assert (dataclasses.asdict(shape.reduced())
                == dataclasses.asdict(jbase.SHAPES[name].reduced()))


@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_loss_and_grads(arch):
    """Logits, loss, metrics and every gradient leaf of a reduced config, with
    the reference's weights; the port's own init has the reference's tree."""
    cfg, jcfg = get_arch(arch, reduced=True), jget_arch(arch, reduced=True)
    jparams = jtr.init_lm_params(jax.random.PRNGKey(1), jcfg)
    params = _carry(jparams, cfg)
    own = tr.init_lm_params(1, cfg, device="cpu")
    assert [(n, tuple(l.shape), l.dtype) for n, l in tree_leaves_with_path(own)] == \
        [(n, tuple(l.shape), l.dtype) for n, l in tree_leaves_with_path(params)]
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, _ = jtr.forward(jparams, jbatch["tokens"], jcfg, q_chunk=8, kv_chunk=16)
    logits, aux = tr.forward(params, tbatch["tokens"], cfg, q_chunk=8, kv_chunk=16)
    _close(logits, jlogits, 1e-5)
    assert float(aux) == 0.0
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jbatch, jcfg, q_chunk=8, kv_chunk=16), has_aux=True)(jparams)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, m = tr.lm_loss(params, tbatch, cfg, q_chunk=8, kv_chunk=16)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jloss, 1e-5)
    _close(m["nll"], jm["nll"], 1e-5)
    for (jk, jg), (name, _), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                                      tree_leaves_with_path(params), grads):
        assert jax.tree_util.keystr(jk) == name
        _close(g, jg, 1e-5)
    back = params_to_reference(params)
    for (name, a), (_, b) in zip(tree_leaves_with_path(back),
                                 tree_leaves_with_path(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_vlm_forward_loss_and_grads():
    """qwen2-vl-2b reduced: M-RoPE over (3, B, S) positions with the vision
    tokens on a (t, h, w) grid, vision embeddings written over tokens
    1 … nv; logits, loss and every gradient leaf (the vision embeddings'
    too) within 1e-5, with the reference's weights; the default positions
    broadcast to the three streams."""
    cfg, jcfg = get_arch("qwen2-vl-2b", reduced=True), jget_arch("qwen2-vl-2b", reduced=True)
    assert cfg.family == "vlm" and cfg.mrope_sections == (4, 2, 2)
    jparams = jtr.init_lm_params(jax.random.PRNGKey(3), jcfg)
    params = _carry(jparams, cfg)
    batch = _batch(cfg, 2)
    nv = cfg.n_vision_tokens
    pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy()
    pos[0, :, 1:1 + nv], pos[1, :, 1:1 + nv], pos[2, :, 1:1 + nv] = \
        1, 1 + np.arange(nv) // 4, 1 + np.arange(nv) % 4
    batch["positions"] = pos.astype(np.int32)
    batch["vision_embeds"] = np.random.default_rng(5).normal(
        size=(B, nv, cfg.d_model)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for kw, jkw in (({}, {}), ({"positions": tbatch["positions"],
                               "vision_embeds": tbatch["vision_embeds"]},
                              {"positions": jbatch["positions"],
                               "vision_embeds": jbatch["vision_embeds"]})):
        jlogits, _ = jtr.forward(jparams, jbatch["tokens"], jcfg, q_chunk=8, kv_chunk=16, **jkw)
        logits, _ = tr.forward(params, tbatch["tokens"], cfg, q_chunk=8, kv_chunk=16, **kw)
        _close(logits, jlogits, 1e-5)

    def jloss_of(p, ve):
        return jtr.lm_loss(p, dict(jbatch, vision_embeds=ve), jcfg, q_chunk=8, kv_chunk=16)

    (jloss, jm), (jgrads, jgve) = jax.value_and_grad(jloss_of, argnums=(0, 1), has_aux=True)(
        jparams, jbatch["vision_embeds"])
    leaves = tree_leaves(params)
    ve = tbatch["vision_embeds"].clone().requires_grad_(True)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, m = tr.lm_loss(params, dict(tbatch, vision_embeds=ve), cfg, q_chunk=8, kv_chunk=16)
    grads = torch.autograd.grad(loss, leaves + [ve])
    _close(loss, jloss, 1e-5)
    _close(m["nll"], jm["nll"], 1e-5)
    for (jk, jg), (name, _), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                                      tree_leaves_with_path(params), grads):
        assert jax.tree_util.keystr(jk) == name
        _close(g, jg, 1e-5)
    _close(grads[-1], jgve, 1e-5)


def test_bfloat16_model_loss():
    """gemma3-1b reduced in bfloat16 (the full config's dtype): the port's
    loss within 1e-2 of the reference's; bfloat16 leaves carried both ways."""
    cfg = dataclasses.replace(get_arch("gemma3-1b", reduced=True), dtype="bfloat16")
    jcfg = dataclasses.replace(jget_arch("gemma3-1b", reduced=True), dtype="bfloat16")
    jparams = jtr.init_lm_params(jax.random.PRNGKey(2), jcfg)
    params = _carry(jparams, cfg)
    assert params["embed"].dtype == torch.bfloat16 and params["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        params["embed"].float().numpy(), np.asarray(jparams["embed"].astype(jnp.float32)))
    words = params_to_reference(params)["lm_head"]
    assert words.dtype == np.dtype("V2")
    np.testing.assert_array_equal(words.view(np.int16),
                                  np.asarray(jparams["lm_head"]).view(np.int16))
    batch = _batch(cfg, 1)
    jloss, _ = jtr.lm_loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                           q_chunk=8, kv_chunk=8)
    loss, _ = tr.lm_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                         q_chunk=8, kv_chunk=8)
    assert abs(float(loss) - float(jloss)) < 1e-2, (float(loss), float(jloss))


@pytest.mark.parametrize("q_chunk,kv_chunk,window,causal", [
    (8, 8, 0, True), (8, 16, 0, True), (16, 8, 8, True), (32, 32, 5, True),
    (4, 8, 12, True), (8, 8, 0, False), (16, 4, 6, False)])
def test_flash_attention_matches_reference(q_chunk, kv_chunk, window, causal):
    """GQA (4 query heads over 2 KV heads), the causal mask and a sliding
    window, over the chunk sizes; KV chunks the mask hides are skipped."""
    rng = np.random.default_rng(q_chunk * 100 + kv_chunk + window)
    q = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **kw)
    _close(got, want, 1e-6)


def test_what_is_not_ported_raises():
    """Training with parameters placed over a mesh's model axis names its
    ROADMAP item; MoE layers and leading dense layers build and run (their
    parity tests: tests/test_torch_moe_lm.py). A Dist whose mesh spans no
    process group changes no value: the loss of a reduced gemma3-1b (with a
    leading dense layer) and of a reduced qwen3-moe-235b-a22b, and a decode
    step of the ssm and hybrid families, are bit-equal with and without
    one; the ssm, hybrid and audio families are served (their parity
    tests: tests/test_torch_{ssm,hybrid,encdec}.py)."""
    from repro_torch.train import trainer

    api = get_api(get_arch("gemma3-1b", reduced=True))
    with pytest.raises(NotImplementedError, match=PLACEMENT):
        trainer.make_train_fn(api, trainer.TrainerConfig(), make_dist(make_host_mesh(4, 2), api.cfg),
                              np.zeros(2, np.uint32), device="cpu")
    for lm in (get_api(dataclasses.replace(api.cfg, first_k_dense=1)),
               get_api(get_arch("qwen3-moe-235b-a22b", reduced=True))):
        dist = make_dist(make_host_mesh(4, 2), lm.cfg)
        assert dist.mesh is not None and dist.tp_axis == "model" and dist.use_ep
        params = lm.init_params(0, "cpu")
        assert len(params.get("pre_layers", [])) == lm.cfg.first_k_dense
        batch = {k: torch.from_numpy(v) for k, v in _batch(lm.cfg).items()}
        with torch.no_grad():
            assert torch.equal(lm.loss_fn(params, batch, tr.NO_DIST)[0],
                               lm.loss_fn(params, batch, dist)[0])
    for arch, family in (("mamba2-1.3b", "ssm"), ("zamba2-1.2b", "hybrid"),
                         ("seamless-m4t-large-v2", "audio")):
        ported = get_api(get_arch(arch, reduced=True))
        assert ported.cfg.family == family
        params = ported.init_params(0, "cpu")
        assert params["embed"].shape == (ported.cfg.vocab_size, ported.cfg.d_model)
        if ported.init_decode_state is None:
            continue
        with torch.no_grad():
            logits = [ported.decode_fn(params, np.ones((1, 1), np.int32),
                                       ported.init_decode_state(1, 4, device="cpu"), 1, d,
                                       device="cpu")[0]
                      for d in (tr.NO_DIST, make_dist(make_host_mesh(2, 1), ported.cfg))]
        assert torch.equal(*logits), arch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.init_params(0)
