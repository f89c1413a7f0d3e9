"""The decoder-only LM of the dense and vlm families: parameters, forward,
loss, prefill and cached decode (the port of ``repro.models.transformer``).

Parameters are the reference's tree: nested dicts of tensors with each block
leaf stacked over layers as ``(n_layers, ...)`` (``init_lm_params``), so
leaves flatten in the reference's order and a checkpoint has its names. The
forward unbinds each stacked leaf once and runs the layers in a Python loop;
gemma's 5:1 local/global pattern is a branch on the static per-layer flag
(the reference's ``lax.cond``) and each layer is recomputed in the backward
pass when ``cfg.remat`` (the reference's ``jax.checkpoint``; a remat policy
changes no value, so every policy recomputes the whole layer).

The vlm family is the same backbone with M-RoPE over ``(3, B, S)``
positions and precomputed vision embeddings written over tokens ``1 … nv``
(the vision tower is a stub in the reference too).

Serving runs under ``torch.inference_mode()`` and recomputes nothing.
``prefill`` returns the last token's logits and the post-RoPE KV cache
``{"k", "v"}`` of shape ``(L, B, S, Hkv, hd)``; ``decode_step`` writes one
token's key and value into the cache in place (the reference returns an
updated copy) and attends over the whole cache in float32.

A ``Dist`` carries the reference's distribution fields. As under GSPMD they
place values and change none: the port's data-parallel trainer replicates
the parameters on each rank and gives it a block of the batch
(``train/trainer.py``), so every function here computes the same values with
a mesh as without. Leading dense layers (``first_k_dense``) and MoE layers
raise ``not_ported``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    apply_mrope,
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
from repro_torch.utils.device import MOE_AND_TP, not_ported, resolve_device
from repro_torch.utils.host import from_host, to_host
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Dist:
    """Distribution context threaded through model code (``mesh=None`` ⇒ one
    device): the reference's fields, a ``launch.mesh`` mesh and its axes."""

    mesh: Any = None
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str | None = "model"
    head_axis: str | None = None   # q-head sharding (only when H % tp == 0)
    kv_head_axis: str | None = None
    use_ep: bool = True            # MoE: all-to-all EP over tp_axis
    sp: bool = False               # sequence-parallel activations between blocks
    seq_shard_cache: bool = False  # decode: shard KV cache sequence over tp_axis

    @property
    def seq_axis(self) -> str | None:
        """Megatron-SP: activations between blocks are sequence-sharded over TP."""
        return self.tp_axis if self.sp else None


NO_DIST = Dist()


def check_supported(cfg: ModelConfig, dist: Dist = NO_DIST) -> None:
    """Raise ``not_ported`` for what this module lacks: MoE layers and
    leading dense layers (a ``Dist``'s mesh changes no value here)."""
    if cfg.family == "moe" or cfg.first_k_dense:
        raise not_ported(f"the {cfg.family} family's MoE and leading dense layers", MOE_AND_TP)


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device``; on the meta device (shapes
    only, nothing drawn) a CPU generator."""
    gen = torch.Generator(device="cpu" if torch.device(device).type == "meta" else device)
    gen.manual_seed(int(seed))
    return gen


def init_lm_params(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's parameter tree for ``cfg``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = generator(seed, device)
    dtype = getattr(torch, cfg.dtype)
    lead = (cfg.n_layers,)
    layers = {
        "ln1": init_rms(cfg.d_model, device, lead),
        "ln2": init_rms(cfg.d_model, device, lead),
        "attn": attn.init_attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                      dtype, device, lead),
        "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device, lead),
    }
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "layers": layers,
        "final_norm": init_rms(cfg.d_model, device),
        "lm_head": truncated_normal_init(gen, (cfg.d_model, cfg.vocab_size), 1.0, dtype, device),
    }


# the top-level keys of the dense and vlm families' parameter tree
TREE_KEYS = frozenset({"embed", "layers", "final_norm", "lm_head"})


def kv_cache_from_reference(cache: dict, device="cuda") -> dict:
    """The reference's KV cache (``{"k", "v"}`` numpy arrays of shape
    ``(L, B, S, Hkv, hd)``; bfloat16 as ``ml_dtypes`` arrays or their 2-byte
    words) as tensors on ``device``."""
    device = resolve_device(device)
    return {name: from_host(np.asarray(a), device=device) for name, a in cache.items()}


def kv_cache_to_reference(cache: dict) -> dict:
    """The inverse of :func:`kv_cache_from_reference`: numpy arrays on the
    host (bfloat16 as its 2-byte words)."""
    return {name: to_host(t) for name, t in cache.items()}


def layer_flags(cfg: ModelConfig) -> list[int]:
    """One int a layer: 1 where a gemma-style layer is GLOBAL attention."""
    if cfg.local_global_ratio:
        period = cfg.local_global_ratio + 1
        return [int(i % period == period - 1) for i in range(cfg.n_layers)]
    return [1] * cfg.n_layers


def _apply_positional(q, k, cfg: ModelConfig, positions, is_global: int):
    """RoPE, or M-RoPE over (3, B, S) positions; gemma's global layers take
    ``rope_theta_global`` as the reference selects it, ``local + 1·(global −
    local)``."""
    if cfg.mrope_sections is not None:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    ql = apply_rope(q, positions, cfg.rope_theta)
    kl = apply_rope(k, positions, cfg.rope_theta)
    if cfg.rope_theta_global and is_global:
        qg = apply_rope(q, positions, cfg.rope_theta_global)
        kg = apply_rope(k, positions, cfg.rope_theta_global)
        return ql + (qg - ql), kl + (kg - kl)
    return ql, kl


def _window(cfg: ModelConfig, is_global: int) -> int:
    """The layer's sliding window: gemma's global layers take none."""
    if cfg.sliding_window and cfg.local_global_ratio and is_global:
        return 0
    return cfg.sliding_window


def _attention_block(p, x, cfg: ModelConfig, positions, is_global: int, q_chunk: int,
                     kv_chunk: int, collect_kv: bool = False):
    B, S, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    q = (h @ p["attn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (h @ p["attn"]["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (h @ p["attn"]["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    q, k = _apply_positional(q, k, cfg, positions, is_global)
    out = attn.flash_attention(q, k, v, causal=True, window=_window(cfg, is_global),
                               q_chunk=q_chunk, kv_chunk=kv_chunk)
    x = x + out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
    return (x, (k, v)) if collect_kv else x


def _ffn_block(p, x, cfg: ModelConfig):
    return x + apply_swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.rms_eps))


def _layer(x, layer, cfg, positions, q_chunk, kv_chunk):
    lp, is_global = layer
    x = _attention_block(lp, x, cfg, positions, is_global, q_chunk, kv_chunk)
    return _ffn_block(lp, x, cfg)


def _embed_inputs(params: dict, tokens: torch.Tensor, cfg: ModelConfig, positions,
                  vision_embeds):
    """The token embeddings with the vision embeddings written over tokens
    ``1 … nv`` (the start clamped so they fit, as ``dynamic_update_slice``
    clamps it), and the positions: ``arange(S)`` by default, broadcast to
    the three M-RoPE streams for the vlm family."""
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    if vision_embeds is not None:
        nv = vision_embeds.shape[1]
        at = max(0, min(1, S - nv))
        x = torch.cat([x[:, :at], vision_embeds.to(x.dtype), x[:, at + nv:]], dim=1)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if cfg.mrope_sections is not None:
            positions = positions[None].expand(3, B, S)
    return x, positions


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, dist: Dist = NO_DIST,
            positions: torch.Tensor | None = None, vision_embeds: torch.Tensor | None = None,
            q_chunk: int = 512, kv_chunk: int = 1024):
    """tokens (B, S) → (logits (B, S, V), aux_loss)."""
    check_supported(cfg, dist)
    x, positions = _embed_inputs(params, tokens, cfg, positions, vision_embeds)
    x = run_blocks(_layer, x, zip(unstack(params["layers"]), layer_flags(cfg)), cfg.remat, cfg,
                   positions, q_chunk, kv_chunk)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = x @ params["lm_head"]
    return logits, torch.zeros((), dtype=torch.float32, device=tokens.device)


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, dist: Dist = NO_DIST,
            q_chunk: int = 512, kv_chunk: int = 1024):
    logits, aux = forward(params, batch["tokens"], cfg, dist, positions=batch.get("positions"),
                          vision_embeds=batch.get("vision_embeds"), q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss + cfg.router_aux_coef * aux, {"nll": loss, "aux": aux}


def _layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views of the stacked leaves."""
    return tree_map(lambda leaf: leaf[i], params["layers"])


@torch.inference_mode()
def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, dist: Dist = NO_DIST,
            positions: torch.Tensor | None = None, vision_embeds: torch.Tensor | None = None,
            q_chunk: int = 512, kv_chunk: int = 1024, cache_dtype=torch.bfloat16):
    """Process a prompt, returning (last-token logits (B, V), KV cache).

    The cache holds post-RoPE keys (matching decode_step's convention), each
    layer's written into one ``(L, B, S, Hkv, hd)`` tensor of ``cache_dtype``
    as the layer runs. The final norm and ``lm_head`` see the last token
    only, so no (B, S, V) logits exist.
    """
    check_supported(cfg, dist)
    B, S = tokens.shape
    x, positions = _embed_inputs(params, tokens, cfg, positions, vision_embeds)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.empty(shape, dtype=cache_dtype, device=x.device),
             "v": torch.empty(shape, dtype=cache_dtype, device=x.device)}
    for i, flag in enumerate(layer_flags(cfg)):
        lp = _layer_params(params, i)
        x, (k, v) = _attention_block(lp, x, cfg, positions, flag, q_chunk, kv_chunk,
                                     collect_kv=True)
        cache["k"][i] = k.to(cache_dtype)
        cache["v"][i] = v.to(cache_dtype)
        del k, v
        x = _ffn_block(lp, x, cfg)
    x = rms_norm(x[:, -1], params["final_norm"], cfg.rms_eps)
    return x @ params["lm_head"], cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda") -> dict:
    """A zero KV cache ``{"k", "v"}`` of shape ``(L, batch, max_len, Hkv, hd)``."""
    check_supported(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.inference_mode()
def decode_step(params: dict, token: torch.Tensor, cache: dict, cur_len, cfg: ModelConfig,
                dist: Dist = NO_DIST):
    """One incremental decode step.

    token (B, 1) integers; ``cur_len`` — number of valid tokens *after* this
    one. Writes the token's keys and values into ``cache`` at ``cur_len − 1``
    in place and returns (logits (B, V), cache). The vlm family's three
    position streams all take ``cur_len − 1``, as the reference's do.
    """
    check_supported(cfg, dist)
    cur_len = int(cur_len)
    B = token.shape[0]
    x = embed(params["embed"], token)                        # (B, 1, d)
    positions = torch.full((B, 1), cur_len - 1, dtype=torch.int64, device=x.device)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, B, 1)
    for i, flag in enumerate(layer_flags(cfg)):
        lp = _layer_params(params, i)
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        q = (h @ lp["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
        k = (h @ lp["attn"]["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
        v = (h @ lp["attn"]["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
        q, k = _apply_positional(q, k, cfg, positions, flag)
        kc = attn.update_cache(cache["k"][i], k, cur_len - 1)
        vc = attn.update_cache(cache["v"][i], v, cur_len - 1)
        out = attn.decode_attention(q, kc, vc, cur_len, window=_window(cfg, flag))
        x = x + out.reshape(B, 1, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
        x = _ffn_block(lp, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"])[:, 0], cache
