"""repro_torch's encoder-decoder (``models/encdec.py``, the audio family of
``models/api.py``) against repro.models on the CPU.

The reference's weights of a reduced seamless-m4t-large-v2 (2 encoder and 2
decoder layers) are carried into the port; the same numpy-seeded frames and
tokens go through both. Tolerances, relative to the largest value compared:
the encoder's states, forward logits, the loss and every gradient leaf 1e-5
in float32; ``prefill_fn``'s cache (the encoder once, the cross K/V) and 8
decode steps from it 1e-5; a bfloat16 model's forward 3e-2 and, behind the
serving launcher, its float32 frames' cross K/V 1e-5 (the encoder runs in
float32, as JAX promotes); both launchers the reference's tokens and log
lines (the training batch's frames drawn bit for bit); a compressed trainer
step to ``tests/torch_lm.py``'s bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jed
from repro.models.api import get_api as jget_api
from repro_torch.models import encdec
from repro_torch.models.api import ModelAPI, get_api
from repro_torch.serve import ServeEngine
from repro_torch.utils import prng
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)
from torch_lm import (checkpoint_round_trip, close, to_t, few_threads, grads_match,  # noqa: F401
                      models, same_tree, serve_launcher_matches, train_launcher_matches,
                      train_steps_match)

ARCH = "seamless-m4t-large-v2"
B, SE, SD = 2, 24, 16


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": (0.1 * rng.normal(size=(B, SE, cfg.d_model))).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, SD)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, SD)).astype(np.int32)}


def test_forward_loss_and_grads():
    """The encoder's states (bidirectional), the logits, the loss and every
    gradient leaf; the port's own init has the reference's tree."""
    jcfg, cfg, jparams, params = models(ARCH)
    same_tree(encdec.init_encdec_params(1, cfg, device="cpu"), params)
    batch = _inputs(cfg)
    close(encdec.encode(params, to_t(batch["frames"]), cfg, q_chunk=8, kv_chunk=16),
          jax.jit(lambda p, f: jed.encode(p, f, jcfg, q_chunk=8, kv_chunk=16))(
              jparams, jnp.asarray(batch["frames"])), 1e-5, "encoder")
    close(encdec.forward(params, to_t(batch["frames"]), to_t(batch["tokens"]), cfg, q_chunk=8,
                         kv_chunk=8),
          jax.jit(lambda p, f, t: jed.forward(p, f, t, jcfg, q_chunk=8, kv_chunk=8))(
              jparams, jnp.asarray(batch["frames"]), jnp.asarray(batch["tokens"])), 1e-5, "logits")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: to_t(v) for k, v in batch.items()}
    grads_match(lambda p: jed.encdec_loss(p, jbatch, jcfg, q_chunk=8, kv_chunk=8),
                lambda p: get_api(cfg).loss_fn(p, tbatch, q_chunk=8, kv_chunk=8),
                jparams, params)


def test_prefill_cache_and_decode_steps():
    """``prefill_fn`` gives (None, the cache) and ``init_decode_state`` is
    None, as the reference's; the default bf16 cross K/V within 1e-5 of the
    largest plus half a bf16 unit of each of the two values, the float32
    one within 1e-5; 8 decode steps (teacher-forced) from the
    float32 cache within 1e-5 of the reference's and, for the port, of its
    forward over the same tokens."""
    jcfg, cfg, jparams, params = models(ARCH)
    japi, api = jget_api(jcfg), get_api(cfg)
    jdecode = jax.jit(japi.decode_fn)          # as the reference's launcher and engine run it
    assert api.init_decode_state is None and japi.init_decode_state is None
    batch = _inputs(cfg, 1)
    jnone, jcache = jax.jit(lambda p, b: japi.prefill_fn(p, b, max_len=SD))(
        jparams, {"frames": jnp.asarray(batch["frames"])})
    none, cache = api.prefill_fn(params, {"frames": batch["frames"]}, max_len=SD, device="cpu")
    assert none is None and jnone is None and sorted(cache) == sorted(jcache)
    for k in cache:
        assert cache[k].shape == jcache[k].shape and cache[k].dtype == torch.bfloat16
    for k in ("xk", "xv"):
        # the float32 keys within 1e-5 of the largest, each then rounded to bf16
        # (half a unit, 2^-8 of the value, each side)
        a, b = cache[k].float().numpy(), np.asarray(jcache[k].astype(jnp.float32))
        assert (np.abs(a - b) <= 1e-5 * np.abs(b).max() + 2.0 ** -8 * (np.abs(a) + np.abs(b))).all(), k
    # the float32 cache of the serving launcher, carried from the reference's
    jcache = jax.jit(lambda p, f: jed.init_decode_cache(p, f, jcfg, SD, dtype=jnp.float32))(
        jparams, jnp.asarray(batch["frames"]))
    cache = encdec.init_decode_cache(params, to_t(batch["frames"]), cfg, SD, dtype=torch.float32)
    for k in ("xk", "xv"):
        close(cache[k], jcache[k], 1e-5, k)
    tokens = batch["tokens"]
    outs = []
    for t in range(8):
        tok = tokens[:, t:t + 1]
        jlogits, jcache = jdecode(jparams, jnp.asarray(tok), jcache, jnp.int32(t + 1))
        logits, cache = api.decode_fn(params, tok, cache, t + 1, device="cpu")
        close(logits, jlogits, 1e-5, f"decode step {t}")
        outs.append(logits)
    for k in cache:
        close(cache[k], jcache[k], 1e-5, k)
    with torch.inference_mode():
        full = encdec.forward(params, to_t(batch["frames"]), to_t(tokens[:, :8]), cfg)
    close(torch.stack(outs, 1), full, 1e-5, "decode against forward")


def test_bfloat16_forward():
    jcfg, cfg, jparams, params = models(ARCH, "bfloat16", seed=2)
    batch = _inputs(cfg, 2)
    frames = to_t(batch["frames"]).to(torch.bfloat16)
    logits = encdec.forward(params, frames, to_t(batch["tokens"]), cfg, q_chunk=8, kv_chunk=8)
    assert logits.dtype == torch.bfloat16
    close(logits, jax.jit(lambda p, f, t: jed.forward(p, f, t, jcfg, q_chunk=8, kv_chunk=8))(
        jparams, jnp.asarray(batch["frames"], jnp.bfloat16), jnp.asarray(batch["tokens"])),
          3e-2, "bf16 logits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_frames_bit_equal(dtype):
    """The training launcher's frames, ``0.1 · normal(fold_in(key, step),
    (B, S, d), dtype)``, bit for bit in both dtypes."""
    key = jax.random.PRNGKey(0)
    for step in (0, 3):
        fk = jax.random.fold_in(key, step)
        want = 0.1 * jax.random.normal(fk, (4, 32, 64), jnp.dtype(dtype))
        dt = getattr(torch, dtype)
        got = torch.tensor(0.1, dtype=dt) * prng.normal(
            prng.fold_in(np.asarray(jax.random.key_data(key)), step), (4, 32, 64), dtype=dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_serve_engine_refuses_audio():
    jcfg, cfg, jparams, params = models(ARCH)
    with pytest.raises(NotImplementedError, match="launch/serve.py"):
        ServeEngine(get_api(cfg), params)
    assert isinstance(get_api(cfg), ModelAPI)


def test_serve_launcher_matches_reference(monkeypatch, capsys):
    serve_launcher_matches(ARCH, monkeypatch, capsys)


def test_serve_launcher_bfloat16_matches_reference(monkeypatch, capsys):
    """A bfloat16 model, the full config's dtype, behind the serving
    launcher: its float32 frames run the encoder in float32 in both packages
    (JAX promotes float32 activations through bfloat16 weights), so the
    launchers' cross K/V agree within 1e-5, not a bf16 unit; the decode
    steps as ``tests/torch_lm.py``'s ``serve_launcher_matches`` holds a
    bf16 model's."""
    serve_launcher_matches(ARCH, monkeypatch, capsys, dtype="bfloat16")


def test_train_launcher_matches_reference(tmp_path):
    train_launcher_matches(ARCH, tmp_path)


def test_compressed_train_steps_match_reference():
    def frames(step, b, s):
        rng = np.random.default_rng(10 + step)
        return {"frames": (0.1 * rng.normal(size=(b, s, 64))).astype(np.float32)}

    train_steps_match(ARCH, frames)


def test_checkpoint_round_trip(tmp_path):
    checkpoint_round_trip(ARCH, tmp_path)
