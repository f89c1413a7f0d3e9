"""The encoder-decoder backbone (SeamlessM4T-style): an audio-frame encoder
and a text decoder (the port of ``repro.models.encdec``).

The modality frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings (B, S_enc, d). Encoder blocks attend both ways;
decoder blocks run causal self-attention, cross-attention into the encoder
output (no RoPE) and a SwiGLU FFN. Each block is recomputed in the backward
pass when ``cfg.remat``. A projection of activations in another dtype than
its weights runs in the promoted dtype, as JAX's ``@`` does: float32 frames
through a bfloat16 model's encoder stay float32, as the serving launcher
draws them.

Decoding keeps a self-attention KV cache and the cross-attention keys and
values computed once from the encoder output: ``{"k", "v": (L, B, max_len,
Hkv, hd), "xk", "xv": (L, B, S_enc, Hkv, hd)}``; ``decode_step`` writes the
self-attention cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    apply_rope,
    apply_swiglu,
    cross_entropy_loss,
    embed,
    init_embedding,
    init_rms,
    init_swiglu,
    matmul,
    rms_norm,
    run_blocks,
    truncated_normal_init,
    unstack,
)
from repro_torch.models.transformer import NO_DIST, Dist, generator
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def _init_enc_blocks(gen, cfg: ModelConfig, dtype, device) -> dict:
    lead = (cfg.n_enc_layers,)
    return {
        "ln1": init_rms(cfg.d_model, device, lead),
        "ln2": init_rms(cfg.d_model, device, lead),
        "attn": attn.init_attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                      dtype, device, lead),
        "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device, lead),
    }


def _init_dec_blocks(gen, cfg: ModelConfig, dtype, device) -> dict:
    lead = (cfg.n_layers,)
    return {
        "ln1": init_rms(cfg.d_model, device, lead),
        "ln_x": init_rms(cfg.d_model, device, lead),
        "ln2": init_rms(cfg.d_model, device, lead),
        "attn": attn.init_attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                      dtype, device, lead),
        "xattn": attn.init_attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                       dtype, device, lead),
        "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device, lead),
    }


# the top-level keys of the parameter tree
TREE_KEYS = frozenset({"embed", "enc_layers", "dec_layers", "enc_norm", "final_norm",
                       "lm_head"})


def init_encdec_params(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's parameter tree for ``cfg``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = generator(seed, device)
    dtype = getattr(torch, cfg.dtype)
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "enc_layers": _init_enc_blocks(gen, cfg, dtype, device),
        "dec_layers": _init_dec_blocks(gen, cfg, dtype, device),
        "enc_norm": init_rms(cfg.d_model, device),
        "final_norm": init_rms(cfg.d_model, device),
        "lm_head": truncated_normal_init(gen, (cfg.d_model, cfg.vocab_size), 1.0, dtype, device),
    }


def _mha(p, xq, xkv, cfg: ModelConfig, positions_q, positions_kv, causal: bool,
         q_chunk: int = 512, kv_chunk: int = 1024, use_rope: bool = True) -> torch.Tensor:
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    q = matmul(xq, p["wq"]).reshape(B, Sq, cfg.n_heads, cfg.hd)
    k = matmul(xkv, p["wk"]).reshape(B, Skv, cfg.n_kv_heads, cfg.hd)
    v = matmul(xkv, p["wv"]).reshape(B, Skv, cfg.n_kv_heads, cfg.hd)
    if use_rope:
        q = apply_rope(q, positions_q, cfg.rope_theta)
        k = apply_rope(k, positions_kv, cfg.rope_theta)
    out = attn.flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return matmul(out.reshape(B, Sq, cfg.n_heads * cfg.hd), p["wo"])


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _enc_block(x, lp, cfg, pos, q_chunk, kv_chunk):
    h = rms_norm(x, lp["ln1"], cfg.rms_eps)
    x = x + _mha(lp["attn"], h, h, cfg, pos, pos, causal=False, q_chunk=q_chunk,
                 kv_chunk=kv_chunk)
    h = rms_norm(x, lp["ln2"], cfg.rms_eps)
    return x + apply_swiglu(lp["mlp"], h)


def _dec_block(x, lp, enc, cfg, pos_d, pos_e, q_chunk, kv_chunk):
    h = rms_norm(x, lp["ln1"], cfg.rms_eps)
    x = x + _mha(lp["attn"], h, h, cfg, pos_d, pos_d, causal=True, q_chunk=q_chunk,
                 kv_chunk=kv_chunk)
    h = rms_norm(x, lp["ln_x"], cfg.rms_eps)
    x = x + _mha(lp["xattn"], h, enc, cfg, pos_d, pos_e, causal=False, q_chunk=q_chunk,
                 kv_chunk=kv_chunk, use_rope=False)
    h = rms_norm(x, lp["ln2"], cfg.rms_eps)
    return x + apply_swiglu(lp["mlp"], h)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, dist: Dist = NO_DIST,
           q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """frames (B, S_enc, d) → encoder states (B, S_enc, d). Bidirectional."""
    B, S, _ = frames.shape
    x = run_blocks(_enc_block, frames, unstack(params["enc_layers"]), cfg.remat, cfg,
                   _positions(B, S, frames.device), q_chunk, kv_chunk)
    return rms_norm(x, params["enc_norm"], cfg.rms_eps)


def forward(params: dict, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
            dist: Dist = NO_DIST, q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """(frames (B, Se, d), tokens (B, Sd)) → logits (B, Sd, V)."""
    enc = encode(params, frames, cfg, dist, q_chunk, kv_chunk)
    B, Sd = tokens.shape
    x = run_blocks(_dec_block, embed(params["embed"], tokens), unstack(params["dec_layers"]),
                   cfg.remat, enc, cfg, _positions(B, Sd, tokens.device),
                   _positions(B, enc.shape[1], tokens.device), q_chunk, kv_chunk)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x @ params["lm_head"]


def encdec_loss(params: dict, batch: dict, cfg: ModelConfig, dist: Dist = NO_DIST,
                q_chunk: int = 512, kv_chunk: int = 1024):
    logits = forward(params, batch["frames"], batch["tokens"], cfg, dist, q_chunk, kv_chunk)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"nll": loss}


# ------------------------------------------------------------------ decode --

@torch.inference_mode()
def init_decode_cache(params: dict, frames: torch.Tensor, cfg: ModelConfig, max_len: int,
                      dist: Dist = NO_DIST, dtype=torch.bfloat16) -> dict:
    """Run the encoder once, precompute the cross-attention K/V in ``dtype``
    and allocate the self-attention cache."""
    enc = encode(params, frames, cfg, dist)
    B, Se = enc.shape[:2]
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.hd)
    xshape = (cfg.n_layers, B, Se, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=enc.device),
             "v": torch.zeros(shape, dtype=dtype, device=enc.device),
             "xk": torch.empty(xshape, dtype=dtype, device=enc.device),
             "xv": torch.empty(xshape, dtype=dtype, device=enc.device)}
    for i in range(cfg.n_layers):
        xp = params["dec_layers"]["xattn"]
        cache["xk"][i] = matmul(enc, xp["wk"][i]).reshape(B, Se, cfg.n_kv_heads, cfg.hd).to(dtype)
        cache["xv"][i] = matmul(enc, xp["wv"][i]).reshape(B, Se, cfg.n_kv_heads, cfg.hd).to(dtype)
    return cache


@torch.inference_mode()
def decode_step(params: dict, token: torch.Tensor, cache: dict, cur_len, cfg: ModelConfig,
                dist: Dist = NO_DIST):
    """One decoder token (B, 1) at position ``cur_len − 1``: (logits (B, V),
    the cache, its self-attention part written in place)."""
    cur_len = int(cur_len)
    B = token.shape[0]
    x = embed(params["embed"], token)
    pos = torch.full((B, 1), cur_len - 1, dtype=torch.int64, device=x.device)
    for i in range(cfg.n_layers):
        lp = tree_map(lambda leaf: leaf[i], params["dec_layers"])
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        q = (h @ lp["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
        k = (h @ lp["attn"]["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
        v = (h @ lp["attn"]["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        kc = attn.update_cache(cache["k"][i], k, cur_len - 1)
        vc = attn.update_cache(cache["v"][i], v, cur_len - 1)
        out = attn.decode_attention(q, kc, vc, cur_len)
        x = x + out.reshape(B, 1, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
        # cross attention over the whole precomputed encoder K/V
        h = rms_norm(x, lp["ln_x"], cfg.rms_eps)
        q = (h @ lp["xattn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
        xk = cache["xk"][i]
        out = attn.decode_attention(q, xk, cache["xv"][i], xk.shape[1])
        x = x + out.reshape(B, 1, cfg.n_heads * cfg.hd) @ lp["xattn"]["wo"]
        h = rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + apply_swiglu(lp["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"])[:, 0], cache
