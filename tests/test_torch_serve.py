"""repro_torch's LM serving (``decode_attention``, ``update_cache``,
``prefill``, ``init_kv_cache``, ``decode_step``, ``ServeEngine`` and
``python -m repro_torch.launch.serve``) against the reference on the CPU.

The reference's weights (``init_lm_params``) are carried into the port by
``params_from_reference`` and the reference's caches by
``kv_cache_from_reference``; the same tokens go through both. Tolerances,
relative to the largest value compared:

- ``decode_attention`` 1e-6; ``update_cache`` writes the reference's words
  bit for bit (bfloat16 caches included);
- float32 models: prefill logits and cache 1e-5, 8 decode steps 1e-5
  (measured ≤ 1e-6);
- bfloat16 models: prefill logits and bfloat16 cache 3e-2 (measured ≤ 1.2e-2:
  each library rounds its bf16 matmuls and fused chains its own way);
- the port against itself (decode against forward, prefill's tail against
  forward) in float32: 1e-5;
- ``ServeEngine`` and the launcher: the reference's tokens, exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.launch import serve as jlaunch
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.models.api import get_api as jget_api
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.registry import get_arch
from repro_torch.models import api as api_mod
from repro_torch.models import attention, transformer as tr
from repro_torch.models.api import ModelAPI, get_api, params_from_reference
from repro_torch.serve import Request, ServeEngine
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

ARCHS = ["glm4-9b", "gemma3-1b", "qwen2-vl-2b"]
B, S, STEPS = 2, 24, 8


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the models' many small ops slow down several
    times over when test workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1e-30, float(np.abs(want).max())))


def _models(arch, dtype="float32", seed=1):
    jcfg = dataclasses.replace(jget_arch(arch, reduced=True), dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype=dtype)
    jparams = jtr.init_lm_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jparams, params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                                        device="cpu")


def _vision(cfg, n_tokens, seed=0):
    """vlm inputs: vision embeddings over tokens 1 … nv and M-RoPE positions
    with the vision tokens on a (t, h, w) grid of 2 rows (text tokens at
    their index in all three streams); None for the other families."""
    if cfg.mrope_sections is None:
        return None, None
    nv = cfg.n_vision_tokens
    ve = (np.random.default_rng(seed).normal(size=(B, nv, cfg.d_model)) * 0.02).astype(np.float32)
    pos = np.broadcast_to(np.arange(n_tokens)[None, None], (3, B, n_tokens)).copy()
    pos[0, :, 1:1 + nv] = 1
    pos[1, :, 1:1 + nv] = 1 + np.arange(nv) // (nv // 2)
    pos[2, :, 1:1 + nv] = 1 + np.arange(nv) % (nv // 2)
    return ve, pos


def _inputs(cfg, jcfg, n_tokens):
    """(port kwargs, reference kwargs) of prefill/forward over n_tokens."""
    ve, pos = _vision(cfg, n_tokens)
    if ve is None:
        return {}, {}
    dt = getattr(torch, cfg.dtype)
    return ({"positions": torch.from_numpy(pos), "vision_embeds": torch.from_numpy(ve).to(dt)},
            {"positions": jnp.asarray(pos), "vision_embeds": jnp.asarray(ve).astype(jcfg.dtype)})


# ------------------------------------------------------------- attention ----

@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_attention_and_update_cache(window, cache_dtype):
    """GQA (4 query heads over 2 KV heads) at several cur_len; the written
    cache bit-equal to the reference's (cast to its dtype first)."""
    rng = np.random.default_rng(window)
    jdt, dt = jnp.dtype(cache_dtype), getattr(torch, cache_dtype)
    kc = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    jk, jv = jnp.asarray(kc).astype(jdt), jnp.asarray(vc).astype(jdt)
    k, v = torch.from_numpy(kc).to(dt), torch.from_numpy(vc).to(dt)
    for cur_len in (1, 5, 9, 17, 32):
        q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
        new_k = rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
        new_v = rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
        jk = jattn.update_cache(jk, jnp.asarray(new_k), jnp.int32(cur_len - 1))
        jv = jattn.update_cache(jv, jnp.asarray(new_v), jnp.int32(cur_len - 1))
        assert attention.update_cache(k, torch.from_numpy(new_k), cur_len - 1) is k
        attention.update_cache(v, torch.from_numpy(new_v), cur_len - 1)
        for got, want in ((k, jk), (v, jv)):
            np.testing.assert_array_equal(got.view(torch.int16 if dt == torch.bfloat16
                                                   else torch.int32).numpy(),
                                          np.asarray(want).view(np.int16 if dt == torch.bfloat16
                                                                else np.int32))
        want = jattn.decode_attention(jnp.asarray(q), jk, jv, jnp.int32(cur_len), window=window)
        got = attention.decode_attention(torch.from_numpy(q), k, v, cur_len, window=window)
        assert got.dtype == torch.float32
        _close(got, want, 1e-6)


def test_init_kv_cache_shapes_and_dtypes():
    """The full configs' and the reduced ones' caches: the reference's shape,
    bfloat16 by default, zeros."""
    for arch in ARCHS:
        for reduced in (False, True):
            cfg, jcfg = get_arch(arch, reduced), jget_arch(arch, reduced)
            want = jax.eval_shape(lambda: jtr.init_kv_cache(jcfg, 3, 8))
            cache = tr.init_kv_cache(cfg, 3, 8, device="cpu")
            assert sorted(cache) == sorted(want) == ["k", "v"]
            for name, t in cache.items():
                assert tuple(t.shape) == want[name].shape and t.dtype == torch.bfloat16
                assert not t.any()
            f32 = get_api(cfg).init_decode_state(1, 4, device="cpu")
            assert f32["k"].shape == (cfg.n_layers, 1, 4, cfg.n_kv_heads, cfg.hd)
    assert tr.init_kv_cache(get_arch("glm4-9b", True), 1, 4, torch.float32,
                            device="cpu")["v"].dtype == torch.float32


# ------------------------------------------------------ prefill, decode ----

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(arch, dtype):
    """Last-token logits and the post-RoPE cache of a prompt of S tokens (the
    vlm one with its vision embeddings and M-RoPE grid); the cache in
    float32 for a float32 model, in bfloat16 (the default) for a bfloat16
    one. The cache carries both ways."""
    jcfg, cfg, jparams, params = _models(arch, dtype)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    kw, jkw = _inputs(cfg, jcfg, S)
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jlogits, jcache = jtr.prefill(jparams, jnp.asarray(tokens), jcfg, q_chunk=8, kv_chunk=8,
                                  cache_dtype=cdt, **jkw)
    logits, cache = tr.prefill(params, torch.from_numpy(tokens), cfg, q_chunk=8, kv_chunk=8,
                               cache_dtype=getattr(torch, cdt.__name__), **kw)
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert logits.shape == (B, cfg.vocab_size) and logits.dtype == getattr(torch, dtype)
    _close(logits, jlogits, tol)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        assert cache[name].shape == jcache[name].shape
        assert str(cache[name].dtype) == f"torch.{cdt.__name__}"
        _close(cache[name], jcache[name], tol)
    # the reference's cache carried into the port and back, bit for bit
    carried = tr.kv_cache_from_reference(jax.tree.map(np.asarray, jcache), device="cpu")
    back = tr.kv_cache_to_reference(carried)
    for name in jcache:
        want = np.asarray(jcache[name])
        np.testing.assert_array_equal(back[name].view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """8 decode steps after a prefill, from the reference's float32 cache
    padded by 8, beside the reference's: every step's logits and the final
    cache within 1e-5."""
    jcfg, cfg, jparams, params = _models(arch)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    _, jkw = _inputs(cfg, jcfg, S)
    _, jcache = jtr.prefill(jparams, jnp.asarray(tokens[:, :S]), jcfg, q_chunk=8, kv_chunk=8,
                            cache_dtype=jnp.float32, **jkw)
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)))
              for k, v in jcache.items()}
    cache = tr.kv_cache_from_reference(jax.tree.map(np.asarray, jcache), device="cpu")
    for t in range(STEPS):
        tok = tokens[:, S + t:S + t + 1]
        jlogits, jcache = jtr.decode_step(jparams, jnp.asarray(tok), jcache, jnp.int32(S + t + 1),
                                          jcfg)
        logits, cache = tr.decode_step(params, torch.from_numpy(tok), cache, S + t + 1, cfg)
        _close(logits, jlogits, 1e-5)
    for name in cache:
        _close(cache[name], jcache[name], 1e-5)


@pytest.mark.parametrize("arch,n", [("glm4-9b", 8), ("gemma3-1b", 16), ("qwen2-vl-2b", 8)])
def test_decode_equals_forward(arch, n):
    """Incremental decode from an empty float32 cache reproduces the full
    forward's logits (gemma3's windowed and dual-theta layers over 16
    tokens, past its window of 8), as tests/test_arch_smoke.py holds the
    reference."""
    _, cfg, _, params = _models(arch)
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (B, n)).astype(np.int32))
    with torch.inference_mode():
        full, _ = tr.forward(params, tokens, cfg, q_chunk=8, kv_chunk=8)
    cache = tr.init_kv_cache(cfg, B, n, torch.float32, device="cpu")
    outs = []
    for t in range(n):
        logits, cache = tr.decode_step(params, tokens[:, t:t + 1], cache, t + 1, cfg)
        outs.append(logits)
    _close(torch.stack(outs, dim=1), full, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_tail_equals_forward(arch):
    """prefill(prompt) gives forward's logits at the prompt's last token;
    one decode step after it gives forward's at the next (glm4 and gemma3
    as tests/test_arch_smoke.py holds the reference; the vlm model with its
    vision embeddings and M-RoPE grid)."""
    jcfg, cfg, _, params = _models(arch)
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    kw, _ = _inputs(cfg, jcfg, S + 1)
    short = {"positions": kw["positions"][:, :, :S], "vision_embeds": kw["vision_embeds"]} if kw \
        else {}
    with torch.inference_mode():
        full, _ = tr.forward(params, tokens, cfg, q_chunk=8, kv_chunk=5, **kw)
    logits, cache = tr.prefill(params, tokens[:, :S], cfg, q_chunk=8, kv_chunk=8,
                               cache_dtype=torch.float32, **short)
    _close(logits, full[:, S - 1], 1e-5)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in cache.items()}
    logits, _ = tr.decode_step(params, tokens[:, S:], cache, S + 1, cfg)
    _close(logits, full[:, S], 1e-5)


# ----------------------------------------------------------- the engine ----

def _serve_both(n_slots, max_len, prompts, max_new):
    jcfg, cfg, jparams, params = _models("glm4-9b", seed=0)
    jeng = JServeEngine(jget_api(jcfg), jparams, n_slots=n_slots, max_len=max_len)
    eng = ServeEngine(get_api(cfg), params, n_slots=n_slots, max_len=max_len)
    for i, (pr, mx) in enumerate(zip(prompts, max_new)):
        jeng.submit(JRequest(rid=i, prompt=pr, max_new=mx))
        eng.submit(Request(rid=i, prompt=pr, max_new=mx))
    return jeng.run(), eng.run(), (get_api(cfg), params)


def test_serve_engine_one_wave_matches_reference():
    """Two requests in one wave: the reference's tokens, and one-by-one
    greedy decoding with the same semantics (the first generated token fed
    at cur_len = plen + 2: caveat R5)."""
    prompts = [np.array([3, 5, 7], np.int32), np.array([11, 13, 17], np.int32)]
    jdone, done, (api, params) = _serve_both(2, 16, prompts, [4, 4])
    assert [r.rid for r in done] == [0, 1] and all(r.done for r in done)
    assert [r.out for r in done] == [r.out for r in jdone]
    assert all(len(r.out) == 4 for r in done)
    for r, pr in zip(done, prompts):
        cache = api.init_decode_state(1, 16, device="cpu")
        for t, token in enumerate(pr):
            logits, cache = api.decode_fn(params, np.array([[token]], np.int32), cache, t + 1,
                                          device="cpu")
        outs = [int(torch.argmax(logits, -1)[0])]
        for s in range(3):
            logits, cache = api.decode_fn(params, np.array([[outs[-1]]], np.int32), cache,
                                          len(pr) + s + 2, device="cpu")
            outs.append(int(torch.argmax(logits, -1)[0]))
        assert outs == r.out


def test_serve_engine_waves_match_reference():
    """Five requests of 2–5 prompt tokens and budgets of 1–4 over two slots:
    three waves (the last one slot short), prompts right-aligned, early
    retirement and the max_len stop; the reference's tokens exactly."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (2, 5, 3, 4, 2)]
    jdone, done, _ = _serve_both(2, 9, prompts, [3, 1, 4, 2, 4])
    assert len(done) == 5 and all(r.done for r in done)
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in jdone]
    assert [len(r.out) for r in done] == [3, 1, 4, 2, 4]


def test_serve_engine_refuses_audio():
    cfg = dataclasses.replace(get_arch("glm4-9b", True), family="audio")
    api = ModelAPI(cfg, None, None, None, None, None)
    with pytest.raises(NotImplementedError, match="launch/serve.py"):
        ServeEngine(api, {"embed": torch.zeros(1)})


# --------------------------------------------------------- the launcher ----

@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2-vl-2b"])
def test_launcher_matches_reference(arch, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch <arch>
    --reduced`` with the reference launcher's weights (its init_params of
    PRNGKey(0), carried) prints the reference's sample tokens: its prompt is
    ``jax.random.randint``'s, bit for bit."""
    jlaunch.main(["--arch", arch, "--reduced"])
    want = capsys.readouterr().out.splitlines()
    jparams = jtr.init_lm_params(jax.random.PRNGKey(0), jget_arch(arch, reduced=True))
    real = api_mod.get_api

    def carried(cfg):
        a = real(cfg)
        return dataclasses.replace(a, init_params=lambda seed, device="cuda": params_from_reference(
            jax.tree.map(np.asarray, jparams), cfg, device))

    monkeypatch.setattr(api_mod, "get_api", carried)
    from repro_torch.launch import serve as launch

    launch.main(["--arch", arch, "--reduced", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith(f"arch={arch} generated (4, 8) in ")
    assert got[1].startswith("sample tokens: [") and got[1] == want[1], (got, want)


def test_launcher_devices_matches_reference(monkeypatch, capsys):
    """``--devices 2 --device cpu``: the reference's flag, which forces host
    devices and serves on one; the port serves on one and prints the
    reference launcher's sample tokens for the same flags."""
    # the reference launcher writes XLA_FLAGS (read by no JAX already started)
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    jlaunch.main(["--arch", "glm4-9b", "--reduced", "--devices", "2"])
    want = capsys.readouterr().out.splitlines()
    cfg = jget_arch("glm4-9b", reduced=True)
    jparams = jtr.init_lm_params(jax.random.PRNGKey(0), cfg)
    real = api_mod.get_api

    def carried(c):
        a = real(c)
        return dataclasses.replace(a, init_params=lambda seed, device="cuda": params_from_reference(
            jax.tree.map(np.asarray, jparams), c, device))

    monkeypatch.setattr(api_mod, "get_api", carried)
    from repro_torch.launch import serve as launch

    launch.main(["--arch", "glm4-9b", "--reduced", "--devices", "2", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("arch=glm4-9b generated (4, 8) in ")
    assert got[1].startswith("sample tokens: [") and got[1] == want[1], (got, want)


def test_what_is_not_served_raises():
    """Without a card the serving calls default to "cuda" and raise, for
    every served family, and so does the launcher's --devices; on the card it
    refuses more devices than cards. The moe family names its ROADMAP
    item."""
    api = get_api(get_arch("gemma3-1b", reduced=True))
    from repro_torch.launch import serve as launch

    if not torch.cuda.is_available():
        for call in (lambda: api.init_decode_state(1, 8),
                     lambda: api.prefill_fn({}, {"tokens": np.zeros((1, 4), np.int32)}),
                     lambda: api.decode_fn({}, np.zeros((1, 1), np.int32), {}, 1),
                     lambda: launch.main(["--arch", "glm4-9b", "--reduced"])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    # the moe, ssm, hybrid and audio families serve, on the card by default
    for arch in ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "mamba2-1.3b", "zamba2-1.2b",
                 "seamless-m4t-large-v2"):
        lm = get_api(get_arch(arch, reduced=True))
        if lm.init_decode_state is None:
            assert lm.cfg.family == "audio"
        elif not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                lm.init_decode_state(1, 8)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                lm.decode_fn({}, np.zeros((1, 1), np.int32), {}, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.main(["--arch", "glm4-9b", "--reduced", "--devices", "2"])
    elif torch.cuda.device_count() < 64:
        with pytest.raises(ValueError, match="cards"):
            launch.main(["--arch", "glm4-9b", "--reduced", "--devices", "64"])
