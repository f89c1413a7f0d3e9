"""repro_torch's moe family (qwen3-moe-235b-a22b, kimi-k2-1t-a32b: MoE layers,
kimi's shared expert and leading dense layer) against repro on the CPU.

The reduced configs (d = 64, 8 experts, top-2, float32) with the reference's
weights carried into the port: logits, the loss with its aux term and
every gradient leaf within 1e-5 (tests/test_torch_models.py's bounds);
prefill's logits and cache (``pre_k``/``pre_v`` too) and 8 decode steps
within 1e-5; the serving launcher's greedy tokens and ``ServeEngine``'s
equal to the reference's; 3 compressed trainer steps and the training
launcher at tests/test_torch_train.py's bounds (``tests/torch_lm.py``); a
checkpoint with the ``pre_layers`` list both ways; a bfloat16 model within
3e-2 of max |logit|. Expert parallelism in the model: 2 gloo ranks, each
with the whole parameter tree, run ``lm_loss`` over ``make_host_mesh(1,
2)`` at a capacity where nothing drops, and match the reference's one
device: logits, loss, nll, aux and every gradient within 1e-5 — an expert
leaf's in the rank's block, zero elsewhere.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from repro.models import transformer as jtr
from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer as tr
from repro_torch.models.api import get_api, params_to_reference
from repro_torch.utils.tree import tree_leaves_with_path
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)
from torch_lm import (  # noqa: F401  (few_threads: two intra-op threads)
    carry,
    checkpoint_round_trip,
    close,
    engine_matches,
    few_threads,
    grads_match,
    models,
    same_tree,
    serve_launcher_matches,
    to_t,
    train_launcher_matches,
    train_steps_match,
)

ARCHS = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"]
B, S, STEPS = 2, 32, 8
CHUNKS = dict(q_chunk=8, kv_chunk=16)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads(arch):
    """Logits, the summed aux loss, the loss with it and every gradient
    leaf; the port's own init has the reference's tree (kimi's
    ``pre_layers`` list, the float32 routers)."""
    jcfg, cfg, jparams, params = models(arch)
    own = tr.init_lm_params(1, cfg, device="cpu")
    same_tree(own, params)
    assert (len(own.get("pre_layers", [])) == cfg.first_k_dense
            and own["layers"]["moe"]["router"].dtype == torch.float32)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: to_t(v) for k, v in batch.items()}
    jlogits, jaux = jtr.forward(jparams, jbatch["tokens"], jcfg, **CHUNKS)
    logits, aux = tr.forward(params, tbatch["tokens"], cfg, **CHUNKS)
    close(logits, jlogits, 1e-5, "logits")
    close(aux, jaux, 1e-5, "aux")
    assert float(aux) > 0
    _, jm = jtr.lm_loss(jparams, jbatch, jcfg, **CHUNKS)
    _, m = get_api(cfg).loss_fn(params, tbatch, **CHUNKS)
    close(m["aux"], jm["aux"], 1e-5, "metrics aux")
    grads_match(lambda p: jtr.lm_loss(p, jbatch, jcfg, **CHUNKS),
                lambda p: get_api(cfg).loss_fn(p, tbatch, **CHUNKS), jparams, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps(arch):
    """``prefill_fn``'s last-token logits and float32 cache (kimi's
    ``pre_k``/``pre_v`` beside ``k``/``v``, in the reference's key order),
    then 8 decode steps from it padded by 8: every step's logits and the
    final cache within 1e-5; the cache carried both ways bit for bit."""
    jcfg, cfg, jparams, params = models(arch)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    jlogits, jcache = jtr.prefill(jparams, jnp.asarray(tokens[:, :S]), jcfg, cache_dtype=jnp.float32,
                                  **CHUNKS)
    logits, cache = get_api(cfg).prefill_fn(params, {"tokens": tokens[:, :S]},
                                            cache_dtype=torch.float32, device="cpu", **CHUNKS)
    close(logits, jlogits, 1e-5, "prefill logits")
    assert list(cache) == list(jcache) == (["pre_k", "pre_v"] if cfg.first_k_dense else []) + \
        ["k", "v"]
    for name in cache:
        close(cache[name], jcache[name], 1e-5, name)
    back = tr.kv_cache_to_reference(tr.kv_cache_from_reference(
        jax.tree.map(np.asarray, jcache), device="cpu"))
    for name in jcache:
        np.testing.assert_array_equal(back[name], np.asarray(jcache[name]))
    pad = lambda c: {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, STEPS))  # noqa: E731
                     for k, v in c.items()}
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)))
              for k, v in jcache.items()}
    cache = pad(cache)
    empty = tr.init_kv_cache(cfg, B, S + STEPS, torch.float32, device="cpu")
    assert {k: v.shape for k, v in empty.items()} == {k: v.shape for k, v in cache.items()}
    for t in range(STEPS):
        tok = tokens[:, S + t:S + t + 1]
        jlogits, jcache = jtr.decode_step(jparams, jnp.asarray(tok), jcache, jnp.int32(S + t + 1),
                                          jcfg)
        logits, cache = get_api(cfg).decode_fn(params, tok, cache, S + t + 1, device="cpu")
        close(logits, jlogits, 1e-5, f"decode step {t}")
    for name in cache:
        close(cache[name], jcache[name], 1e-5, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_forward(arch):
    """The full configs' dtype: the experts in bfloat16 beside a float32
    router; leaves carried both ways bit for bit; logits within 3e-2 of max
    |logit| in all but at most 1/16 of the rows. The router sees bfloat16
    activations, which the two packages round in other orders, so a token
    whose top-k boundary lies within that rounding goes to another expert
    in one than in the other, and its row differs wholesale (2 of the 64
    tokens in JAX's original threefry layout's weights, none in the
    partitionable one's)."""
    jcfg, cfg, jparams, params = models(arch, "bfloat16", seed=2)
    moe_p = params["layers"]["moe"]
    assert moe_p["w_gate"].dtype == torch.bfloat16 and moe_p["router"].dtype == torch.float32
    back = params_to_reference(params)
    np.testing.assert_array_equal(back["layers"]["moe"]["w_down"].view(np.int16),
                                  np.asarray(jparams["layers"]["moe"]["w_down"]).view(np.int16))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits, _ = tr.forward(params, to_t(tokens), cfg, **CHUNKS)
    assert logits.dtype == torch.bfloat16
    want = np.asarray(jtr.forward(jparams, jnp.asarray(tokens), jcfg, **CHUNKS)[0].astype(
        jnp.float32))
    apart = np.abs(logits.float().numpy() - want).max(-1) > 3e-2 * np.abs(want).max()
    assert apart.sum() <= apart.size // 16, (int(apart.sum()), apart.size)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch):
    """Three requests over two slots (two waves): the reference engine's
    tokens."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (3, 5, 2)]
    engine_matches(arch, prompts, [4, 2, 3])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_matches_reference(arch, monkeypatch, capsys):
    """``launch.serve --arch <arch> --reduced --device cpu``: the dense
    branch's prefill and greedy decoding, the reference's tokens."""
    serve_launcher_matches(arch, monkeypatch, capsys)


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_train_steps_match_reference(arch):
    """3 steps with CompressConfig(gamma=0.1): loss (its aux term in it),
    nll, grad_norm, lr, wire_floats, residual and parameters."""
    train_steps_match(arch, steps=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_matches_reference(arch, tmp_path):
    """``launch.train --arch <arch> --reduced --device cpu``, 3 steps without
    resetting to the reference's state between them: the log lines'
    losses within one unit of the last printed digit, the gnorm within 1e-3
    of the reference's. Routing is discrete: a token whose top-k boundary
    lies within the two packages' rounding differences goes to another
    expert in one than in the other, and parameters that differ in their
    last bits after an AdamW step make more such tokens (kimi's third
    gnorm: 6.522 against 6.519; in JAX's original threefry layout
    qwen3-moe's first: 3.361 against 3.359);
    ``test_compressed_train_steps_match_reference`` holds each step from
    the reference's state to 1e-5."""
    train_launcher_matches(arch, tmp_path, gnorm_rel=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip(arch, tmp_path):
    """Names such as ``['pre_layers'][0]['mlp']['gate']`` and
    ``['layers']['moe']['router']``: the reference's checkpoint restores in
    the port and the port's in the reference, byte for byte."""
    checkpoint_round_trip(arch, tmp_path)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_lm_matches_one_device(arch, tmp_path):
    """2 gloo ranks with expert parallelism over "model" (each its half of
    the sequence and of the experts) against the reference's one device, at
    capacity factor 100."""
    jcfg, cfg, jparams, _ = models(arch)
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=100.0) for c in (jcfg, cfg))
    batch = _batch(cfg, seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = jtr.forward(jparams, jbatch["tokens"], jcfg, **CHUNKS)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jbatch, jcfg, **CHUNKS), has_aux=True)(jparams)
    ranks = torch_dp_worker.run("lm_ep", dict(cfg=cfg, params=carry(jparams, cfg), batch=batch,
                                              chunks=CHUNKS), 2, str(tmp_path),
                                jax.config.jax_threefry_partitionable)
    names = [n for n, _ in tree_leaves_with_path(jparams)]
    wants = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    for r in ranks:
        close(r["logits"], jlogits, 1e-5, "logits")
        for name, want in (("loss", jloss), ("nll", jm["nll"]), ("aux", jm["aux"])):
            close(r[name], want, 1e-5, name)
        for name, g, want in zip(names, r["grads"], wants):
            if "['moe']['w_" in name:
                e_loc = want.shape[1] // 2
                block = slice(r["index"] * e_loc, (r["index"] + 1) * e_loc)
                close(g[:, block], want[:, block], 1e-5, name)
                g = g.clone()
                g[:, block] = 0
                assert not g.any(), name
            else:
                close(g, want, 1e-5, name)
