"""repro_torch's Zamba2-style hybrid (``models/hybrid.py``, the hybrid family
of ``models/api.py``) against repro.models on the CPU.

The reference's weights of a reduced zamba2-1.2b (4 Mamba-2 layers, the
shared block after every 2nd) are carried into the port; the same
numpy-seeded inputs go through both. Tolerances, relative to the largest
value compared: forward logits, the loss and every gradient leaf (the
shared block's summed over its two call sites) 1e-5 in float32; the
prefill's last-token logits and 8 decode steps after a prompt decoded token
by token 1e-5; a bfloat16 model's forward 3e-2; ``ServeEngine`` and the
serving launcher the reference's tokens (the training launcher takes the
dense family's path for this family, held in ``tests/test_torch_train.py``);
a compressed trainer step to ``tests/torch_lm.py``'s bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import hybrid as jhyb
from repro.models.api import get_api as jget_api
from repro_torch.configs.registry import get_arch
from repro_torch.models import hybrid
from repro_torch.models.api import get_api
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)
from torch_lm import (checkpoint_round_trip, close, to_t, engine_matches, few_threads,  # noqa: F401
                      grads_match, models, same_tree, serve_launcher_matches,
                      train_steps_match)

ARCH = "zamba2-1.2b"
B, S = 2, 32


def test_sites_and_flags():
    """The shared block's call sites, full and reduced: zamba2-1.2b's 38
    layers take it after layers 6, 12, …, 36 (6 sites, 2 tail layers)."""
    for reduced in (False, True):
        cfg, jcfg = get_arch(ARCH, reduced), jget_arch(ARCH, reduced)
        assert hybrid.n_shared_sites(cfg) == jhyb.n_shared_sites(jcfg)
        assert hybrid.shared_flags(cfg) == np.asarray(jhyb.shared_flags(jcfg)).tolist()
    flags = hybrid.shared_flags(get_arch(ARCH))
    assert [i + 1 for i, f in enumerate(flags) if f] == [6, 12, 18, 24, 30, 36]


def test_forward_loss_and_grads():
    """Logits at two attention chunkings, the loss and every gradient leaf;
    the port's own init has the reference's tree."""
    jcfg, cfg, jparams, params = models(ARCH)
    same_tree(hybrid.init_hybrid_params(1, cfg, device="cpu"), params)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    for qc, kc in ((8, 16), (32, 32)):
        close(hybrid.forward(params, to_t(batch["tokens"]), cfg, q_chunk=qc, kv_chunk=kc),
              jax.jit(lambda p, t: jhyb.forward(p, t, jcfg, q_chunk=qc, kv_chunk=kc))(
                  jparams, jnp.asarray(batch["tokens"])), 1e-5, f"logits {qc} {kc}")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: to_t(v) for k, v in batch.items()}
    grads_match(lambda p: jhyb.hybrid_loss(p, jbatch, jcfg, q_chunk=8, kv_chunk=8),
                lambda p: get_api(cfg).loss_fn(p, tbatch, q_chunk=8, kv_chunk=8),
                jparams, params)


def test_prefill_and_decode_steps():
    """``prefill_fn``: the last token's logits and no cache, as the
    reference's; a prompt of S tokens decoded token by token into
    ``init_decode_state`` (its default: a bf16 KV cache a site, shapes and
    dtypes the reference's; here in float32), then 8 steps, every step's
    logits beside the reference's and, for the port, its forward's; the
    final state's Mamba-2 parts and caches."""
    jcfg, cfg, jparams, params = models(ARCH)
    japi, api = jget_api(jcfg), get_api(cfg)
    jdecode = jax.jit(japi.decode_fn)          # as the reference's launcher and engine run it
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 8)).astype(np.int32)
    jlogits, jnone = jax.jit(lambda p, b: japi.prefill_fn(p, b, q_chunk=8, kv_chunk=8))(
        jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    logits, none = api.prefill_fn(params, {"tokens": tokens[:, :S]}, q_chunk=8, kv_chunk=8,
                                  device="cpu")
    assert none is None and jnone is None
    close(logits, jlogits, 1e-5, "prefill logits")
    jstate = japi.init_decode_state(B, S + 8)
    state = api.init_decode_state(B, S + 8, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in state.items()} == \
        {k: (v.shape, f"torch.{v.dtype}") for k, v in jstate.items()}
    # float32 caches, so that no bf16 rounding of a cached key separates the two
    jstate = jhyb.init_decode_state(jcfg, B, S + 8, jnp.float32)
    state = hybrid.init_decode_state(cfg, B, S + 8, torch.float32, device="cpu")
    outs = []
    for t in range(S + 8):
        tok = tokens[:, t:t + 1]
        jlogits, jstate = jdecode(jparams, jnp.asarray(tok), jstate, jnp.int32(t + 1))
        logits, state = api.decode_fn(params, tok, state, t + 1, device="cpu")
        close(logits, jlogits, 1e-5, f"decode step {t}")
        outs.append(logits)
    for k in state:
        close(state[k], jstate[k], 1e-5, k)
    with torch.inference_mode():
        full = hybrid.forward(params, to_t(tokens), cfg, q_chunk=8, kv_chunk=8)
    close(torch.stack(outs, 1), full, 1e-5, "decode against forward")


def test_bfloat16_forward():
    jcfg, cfg, jparams, params = models(ARCH, "bfloat16", seed=2)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits = hybrid.forward(params, to_t(tokens), cfg, q_chunk=8, kv_chunk=8)
    assert logits.dtype == torch.bfloat16
    close(logits, jax.jit(lambda p, t: jhyb.forward(p, t, jcfg, q_chunk=8, kv_chunk=8))(
        jparams, jnp.asarray(tokens)), 3e-2, "bf16 logits")


def test_serve_engine_matches_reference():
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (3, 5, 2)]
    engine_matches(ARCH, prompts, [4, 2, 3])


def test_serve_launcher_matches_reference(monkeypatch, capsys):
    serve_launcher_matches(ARCH, monkeypatch, capsys)


def test_compressed_train_steps_match_reference():
    train_steps_match(ARCH)


def test_checkpoint_round_trip(tmp_path):
    checkpoint_round_trip(ARCH, tmp_path)
