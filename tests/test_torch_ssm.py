"""repro_torch's Mamba-2 layer and LM (``models/ssm.py``, ``models/mamba_lm.py``,
the ssm family of ``models/api.py``) against repro.models on the CPU.

The reference's weights of a reduced mamba2-1.3b are carried into the port
(``params_from_reference``); the same numpy-seeded inputs go through both.
Tolerances, relative to the largest value compared (float32 unless stated;
the port contracts the reference's three-operand einsums pairwise and sums
the inter-chunk recurrence in closed form, so it rounds in other orders):

- ``ssd_chunked`` (y and the final state), ``causal_conv`` and
  ``mamba2_forward`` with its state: 1e-5;
- forward logits and the loss: 1e-5; every gradient leaf: 1e-5;
- ``ssm_prefill``'s logits and stacked states, 8 decode steps from them: 1e-5;
- a bfloat16 model's forward: 3e-2 (each library rounds its bf16 matmuls its
  own way, as in ``tests/test_torch_serve.py``);
- ``ServeEngine`` and the serving launcher: the reference's tokens (the
  training launcher takes the dense family's path for this family, held in
  ``tests/test_torch_train.py``);
- a compressed trainer step: ``tests/torch_lm.py``'s bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import mamba_lm as jml
from repro.models import ssm as jssm
from repro.models.api import get_api as jget_api
from repro_torch.configs.registry import get_arch
from repro_torch.models import mamba_lm, ssm
from repro_torch.models.api import get_api, params_to_reference
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)
from torch_lm import (checkpoint_round_trip, close, to_t, engine_matches, few_threads,  # noqa: F401
                      grads_match, models, same_tree, serve_launcher_matches,
                      train_steps_match)

ARCH = "mamba2-1.3b"
B, S = 2, 32


@pytest.mark.parametrize("S_,chunk", [(32, 8), (24, 8), (16, 16)])
def test_ssd_chunked_and_conv_match_reference(S_, chunk):
    """The SSD scan over 4, 3 and 1 chunks (y and the final state) and the
    causal depthwise conv, on the reference's inputs' shapes and signs."""
    rng = np.random.default_rng(S_ + chunk)
    H, P, N = 4, 16, 16
    x = rng.normal(size=(B, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S_, H)))).astype(np.float32)   # softplus > 0
    a = -np.arange(1, H + 1, dtype=np.float32)
    bm = rng.normal(size=(B, S_, N)).astype(np.float32)
    cm = rng.normal(size=(B, S_, N)).astype(np.float32)
    jy, jfinal = jax.jit(jssm.ssd_chunked, static_argnums=5)(*map(jnp.asarray, (x, dt, a, bm, cm)),
                                                             chunk)
    y, final = ssm.ssd_chunked(*map(to_t, (x, dt, a, bm, cm)), chunk)
    assert y.dtype == torch.float32 and final.shape == (B, H, N, P)
    close(y, jy, 1e-5, "y")
    close(final, jfinal, 1e-5, "final state")
    xbc = rng.normal(size=(B, S_, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    close(ssm.causal_conv(to_t(xbc), to_t(w), to_t(b)),
          jax.jit(jssm.causal_conv)(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b)), 1e-5,
          "conv")


@pytest.mark.parametrize("S_", [S, 2])
def test_mamba2_layer_with_state(S_):
    """One layer's output and its recurrent state (the SSD's final state and
    the conv window, left-padded when S < W − 1), then the one-token step
    from that state against the reference's."""
    jcfg, cfg, jparams, params = models(ARCH)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"]["mamba"])
    lp = {k: v[0] for k, v in params["layers"]["mamba"].items()}
    rng = np.random.default_rng(S_)
    u = rng.normal(size=(B, S_, cfg.d_model)).astype(np.float32)
    jout, jst = jax.jit(lambda p, x: jssm.mamba2_forward(p, x, jcfg, return_state=True))(
        jlp, jnp.asarray(u))
    out, st = ssm.mamba2_forward(lp, to_t(u), cfg, return_state=True)
    close(out, jout, 1e-5, "out")
    assert sorted(st) == ["conv", "ssm"] and st["conv"].shape == jst["conv"].shape
    close(st["ssm"], jst["ssm"], 1e-5, "ssm state")
    close(st["conv"], jst["conv"], 1e-5, "conv state")
    step = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    jy, jnew = jax.jit(lambda p, x, s: jssm.mamba2_decode_step(p, x, s, jcfg))(
        jlp, jnp.asarray(step), jst)
    y, new = ssm.mamba2_decode_step(lp, to_t(step), st, cfg)
    close(y, jy, 1e-5, "decode out")
    for k in ("ssm", "conv"):
        close(new[k], jnew[k], 1e-5, k)


def test_forward_loss_and_grads():
    """Logits, loss and every gradient leaf, with the reference's weights;
    the port's own init has the reference's tree."""
    jcfg, cfg, jparams, params = models(ARCH)
    same_tree(mamba_lm.init_mamba_lm_params(1, cfg, device="cpu"), params)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    close(mamba_lm.forward(params, to_t(batch["tokens"]), cfg),
          jax.jit(lambda p, t: jml.forward(p, t, jcfg))(jparams, jnp.asarray(batch["tokens"])),
          1e-5, "logits")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: to_t(v) for k, v in batch.items()}
    grads_match(lambda p: jml.mamba_lm_loss(p, jbatch, jcfg),
                lambda p: get_api(cfg).loss_fn(p, tbatch, q_chunk=8, kv_chunk=8),
                jparams, params)


def test_prefill_states_and_decode_steps():
    """``prefill_fn`` (the reference's ``ssm_prefill``): last-token logits and
    the stacked ``{"ssm", "conv"}`` states; then 8 decode steps from the
    states, every step's logits and the final states; the port's decode from
    its own prefill equals its forward over the same tokens."""
    jcfg, cfg, jparams, params = models(ARCH)
    japi, api = jget_api(jcfg), get_api(cfg)
    jdecode = jax.jit(japi.decode_fn)          # as the reference's launcher and engine run it
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 8)).astype(np.int32)
    jlogits, jstates = jax.jit(japi.prefill_fn)(jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    logits, states = api.prefill_fn(params, {"tokens": tokens[:, :S]}, device="cpu")
    close(logits, jlogits, 1e-5, "prefill logits")
    assert sorted(states) == ["conv", "ssm"]
    for k in states:
        assert states[k].shape == jstates[k].shape and states[k].dtype == torch.float32
        close(states[k], jstates[k], 1e-5, k)
    outs = []
    for t in range(8):
        tok = tokens[:, S + t:S + t + 1]
        jlogits, jstates = jdecode(jparams, jnp.asarray(tok), jstates, jnp.int32(S + t + 1))
        logits, states = api.decode_fn(params, tok, states, S + t + 1, device="cpu")
        close(logits, jlogits, 1e-5, f"decode step {t}")
        outs.append(logits)
    for k in states:
        close(states[k], jstates[k], 1e-5, k)
    with torch.inference_mode():
        full = mamba_lm.forward(params, to_t(tokens), cfg)
    close(torch.stack(outs, 1), full[:, S:], 1e-5, "decode against forward")


def test_decode_from_zero_state_equals_forward():
    """From ``init_decode_state`` (a bf16 conv window, promoted to float32 on
    the first step as the reference's is), token by token: the forward's
    logits, and the reference's decode steps."""
    jcfg, cfg, jparams, params = models(ARCH)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    state = get_api(cfg).init_decode_state(B, 16, device="cpu")
    jstate = jget_api(jcfg).init_decode_state(B, 16)
    jdecode = jax.jit(jget_api(jcfg).decode_fn)
    assert state["conv"].dtype == torch.bfloat16 and jstate["conv"].dtype == jnp.bfloat16
    outs = []
    for t in range(16):
        logits, state = mamba_lm.decode_step(params, to_t(tokens[:, t:t + 1]), state, t + 1, cfg)
        jlogits, jstate = jdecode(jparams, jnp.asarray(tokens[:, t:t + 1]), jstate,
                                  jnp.int32(t + 1))
        close(logits, jlogits, 1e-5, f"step {t}")
        outs.append(logits)
    assert state["conv"].dtype == torch.float32 and jstate["conv"].dtype == jnp.float32
    with torch.inference_mode():
        close(torch.stack(outs, 1), mamba_lm.forward(params, to_t(tokens), cfg), 1e-5, "forward")


def test_bfloat16_forward():
    """The full config's dtype: logits within 3e-2 of max |logit|; the bf16
    leaves carried both ways bit for bit."""
    jcfg, cfg, jparams, params = models(ARCH, "bfloat16", seed=2)
    assert params["embed"].dtype == torch.bfloat16 and params["final_norm"].dtype == torch.float32
    back = params_to_reference(params)
    np.testing.assert_array_equal(back["lm_head"].view(np.int16),
                                  np.asarray(jparams["lm_head"]).view(np.int16))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits = mamba_lm.forward(params, to_t(tokens), cfg)
    assert logits.dtype == torch.bfloat16
    close(logits, jax.jit(lambda p, t: jml.forward(p, t, jcfg))(jparams, jnp.asarray(tokens)), 3e-2,
          "bf16 logits")


def test_serve_engine_matches_reference():
    """Three requests over two slots (two waves, right-aligned prompts):
    the reference engine's tokens; one request decoded by hand alike."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (3, 5, 2)]
    done, (api, params) = engine_matches(ARCH, prompts, [4, 2, 3])
    state = api.init_decode_state(1, 16, device="cpu")
    for t, tok in enumerate(prompts[2]):
        logits, state = api.decode_fn(params, np.array([[tok]], np.int32), state, t + 1,
                                      device="cpu")
    outs = [int(torch.argmax(logits, -1)[0])]
    for s in range(2):
        logits, state = api.decode_fn(params, np.array([[outs[-1]]], np.int32), state, 5 + s,
                                      device="cpu")
        outs.append(int(torch.argmax(logits, -1)[0]))
    assert outs == done[2].out


def test_serve_launcher_matches_reference(monkeypatch, capsys):
    serve_launcher_matches(ARCH, monkeypatch, capsys)


def test_compressed_train_steps_match_reference():
    train_steps_match(ARCH)


def test_checkpoint_round_trip(tmp_path):
    checkpoint_round_trip(ARCH, tmp_path)


def test_full_width_state_shapes():
    """mamba2-1.3b's decode state at full width: the reference's shapes and
    dtypes (``jax.eval_shape``), allocated on the meta device."""
    want = jax.eval_shape(lambda: jml.init_decode_state(jget_arch(ARCH), 2))
    state = mamba_lm.init_decode_state(get_arch(ARCH), 2, device="meta")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in state.items()} == \
        {k: (v.shape, f"torch.{v.dtype}") for k, v in want.items()}
