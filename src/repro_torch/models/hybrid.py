"""The Zamba2-style hybrid: a Mamba-2 backbone with one weight-tied shared
attention block (the port of ``repro.models.hybrid``).

After every ``attn_every``-th Mamba-2 layer the SAME (attention + FFN)
transformer block runs (weight tying across call sites; the reference omits
Zamba2's per-site LoRA deltas, and so does the port). The forward is the
reference's segmented layout: groups of ``attn_every`` Mamba-2 layers, each
followed by the shared block, then the tail (zamba2-1.2b: 6 groups of 6,
then 2). Each Mamba-2 layer and each call of the shared block is recomputed
in the backward pass when ``cfg.remat``; the shared block's gradients are
summed over its call sites by autograd.

Decoding keeps each layer's recurrent state and one KV cache a call site:
``{"ssm": (L,B,H,N,P) float32, "conv": (L,B,W−1,C), "k", "v": (sites, B,
max_len, Hkv, hd)}``. The reference's ``lax.cond`` on the per-layer flag is
a Python branch; states and caches are written in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba_lm, ssm
from repro_torch.models.common import (
    apply_rope,
    apply_swiglu,
    cross_entropy_loss,
    embed,
    init_embedding,
    init_rms,
    init_swiglu,
    rms_norm,
    run_blocks,
    truncated_normal_init,
    unstack,
)
from repro_torch.models.transformer import NO_DIST, Dist, generator
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def n_shared_sites(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def shared_flags(cfg: ModelConfig) -> list[int]:
    """One int a layer: 1 where the shared block runs after that Mamba-2 layer."""
    return [int((i + 1) % cfg.attn_every == 0) for i in range(cfg.n_layers)]


# the top-level keys of the parameter tree
TREE_KEYS = frozenset({"embed", "layers", "shared", "final_norm", "lm_head"})


def init_hybrid_params(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's parameter tree for ``cfg``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = generator(seed, device)
    dtype = getattr(torch, cfg.dtype)
    lead = (cfg.n_layers,)
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "layers": {"ln": init_rms(cfg.d_model, device, lead),
                   "mamba": ssm.init_mamba2_params(gen, cfg, dtype, device, lead)},
        "shared": {
            "ln1": init_rms(cfg.d_model, device),
            "ln2": init_rms(cfg.d_model, device),
            "attn": attn.init_attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                          dtype, device),
            "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device),
        },
        "final_norm": init_rms(cfg.d_model, device),
        "lm_head": truncated_normal_init(gen, (cfg.d_model, cfg.vocab_size), 1.0, dtype, device),
    }


def _shared_block(x: torch.Tensor, sp: dict, cfg: ModelConfig, positions, q_chunk: int,
                  kv_chunk: int) -> torch.Tensor:
    B, S, _ = x.shape
    h = rms_norm(x, sp["ln1"], cfg.rms_eps)
    q = (h @ sp["attn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (h @ sp["attn"]["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (h @ sp["attn"]["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attn.flash_attention(q, k, v, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    x = x + out.reshape(B, S, cfg.n_heads * cfg.hd) @ sp["attn"]["wo"]
    h = rms_norm(x, sp["ln2"], cfg.rms_eps)
    return x + apply_swiglu(sp["mlp"], h)


def hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig, q_chunk: int = 512,
           kv_chunk: int = 1024) -> torch.Tensor:
    """tokens (B, S) → the final norm's input (B, S, d): the segmented layout."""
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    lps = unstack(params["layers"])
    period = cfg.attn_every
    n_full = cfg.n_layers // period
    for g in range(n_full):
        x = mamba_lm.run_layers(lps[g * period:(g + 1) * period], x, cfg)
        x = run_blocks(_shared_block, x, [params["shared"]], cfg.remat, cfg, positions, q_chunk,
                       kv_chunk)
    return mamba_lm.run_layers(lps[n_full * period:], x, cfg)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, dist: Dist = NO_DIST,
            q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V)."""
    x = hidden(params, tokens, cfg, q_chunk, kv_chunk)
    return rms_norm(x, params["final_norm"], cfg.rms_eps) @ params["lm_head"]


def hybrid_loss(params: dict, batch: dict, cfg: ModelConfig, dist: Dist = NO_DIST,
                q_chunk: int = 512, kv_chunk: int = 1024):
    logits = forward(params, batch["tokens"], cfg, dist, q_chunk, kv_chunk)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"nll": loss}


@torch.inference_mode()
def prefill_logits(params: dict, tokens: torch.Tensor, cfg: ModelConfig, dist: Dist = NO_DIST,
                   q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """forward's logits at the last token (B, V): the head sees that token only."""
    x = hidden(params, tokens, cfg, q_chunk, kv_chunk)
    return rms_norm(x[:, -1], params["final_norm"], cfg.rms_eps) @ params["lm_head"]


# ------------------------------------------------------------------ decode --

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cuda") -> dict:
    """A zero state: the Mamba-2 layers' ``ssm`` and ``conv``, and a KV cache
    ``k``, ``v`` of shape (sites, batch, max_len, Hkv, hd) in ``dtype``."""
    device = resolve_device(device)
    shape = (n_shared_sites(cfg), batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {**ssm.init_mamba2_state(cfg, batch, dtype, device, (cfg.n_layers,)),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _shared_decode(sp: dict, x: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, cur_len: int,
                   cfg: ModelConfig) -> torch.Tensor:
    B = x.shape[0]
    pos = torch.full((B, 1), cur_len - 1, dtype=torch.int64, device=x.device)
    h = rms_norm(x, sp["ln1"], cfg.rms_eps)
    q = (h @ sp["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    k = (h @ sp["attn"]["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
    v = (h @ sp["attn"]["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    attn.update_cache(kc, k, cur_len - 1)
    attn.update_cache(vc, v, cur_len - 1)
    out = attn.decode_attention(q, kc, vc, cur_len)
    x = x + out.reshape(B, 1, cfg.n_heads * cfg.hd) @ sp["attn"]["wo"]
    h = rms_norm(x, sp["ln2"], cfg.rms_eps)
    return x + apply_swiglu(sp["mlp"], h)


@torch.inference_mode()
def decode_step(params: dict, token: torch.Tensor, state: dict, cur_len, cfg: ModelConfig,
                dist: Dist = NO_DIST):
    """One token (B, 1): each Mamba-2 layer's recurrence and, after every
    ``attn_every``-th, the shared block over its site's cache at ``cur_len −
    1``. Returns (logits (B, V), the state, updated in place)."""
    cur_len = int(cur_len)
    x = embed(params["embed"], token)
    site = 0
    for i, flag in enumerate(shared_flags(cfg)):
        lp = tree_map(lambda leaf: leaf[i], params["layers"])
        y, new = ssm.mamba2_decode_step(lp["mamba"], rms_norm(x, lp["ln"], cfg.rms_eps),
                                        {"ssm": state["ssm"][i], "conv": state["conv"][i]}, cfg)
        x = x + y
        mamba_lm.write_states(state, i, new)
        if flag:
            x = _shared_decode(params["shared"], x, state["k"][site], state["v"][site], cur_len,
                               cfg)
            site += 1
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"])[:, 0], state
