"""The decoder-only LM of the dense family: parameters, forward and loss (the
port of ``repro.models.transformer``'s training path).

Parameters are the reference's tree: nested dicts of tensors with each block
leaf stacked over layers as ``(n_layers, ...)`` (``init_lm_params``), so
leaves flatten in the reference's order and a checkpoint has its names. The
forward unbinds each stacked leaf once and runs the layers in a Python loop;
gemma's 5:1 local/global pattern is a branch on the static per-layer flag
(the reference's ``lax.cond``) and each layer is recomputed in the backward
pass when ``cfg.remat`` (the reference's ``jax.checkpoint``; a remat policy
changes no value, so every policy recomputes the whole layer).

Only the single-device context ``NO_DIST`` runs; a mesh, leading dense
layers (``first_k_dense``), MoE layers and M-RoPE raise ``not_ported``.
Serving (``prefill``, ``decode_step``, the KV cache) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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
    rms_norm,
    truncated_normal_init,
)
from repro_torch.utils.device import not_ported, resolve_device
from repro_torch.utils.host import from_host, to_host
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class Dist:
    """Distribution context (``mesh=None`` ⇒ one device, the only one ported)."""

    mesh: Any = None


NO_DIST = Dist()


def check_supported(cfg: ModelConfig, dist: Dist = NO_DIST) -> None:
    """Raise ``not_ported`` for what this module lacks: a mesh, MoE layers,
    leading dense layers, M-RoPE."""
    if dist is not None and dist.mesh is not None:
        raise not_ported("the transformer over a mesh (Dist with a mesh)", "LM side, last")
    if cfg.family == "moe" or cfg.first_k_dense:
        raise not_ported(f"the {cfg.family} family's MoE and leading dense layers",
                         "LM side, last")
    if cfg.mrope_sections is not None:
        raise not_ported("M-RoPE (the vlm family)", "LM side, last")


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def init_lm_params(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's parameter tree for ``cfg``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = _generator(seed, device)
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


def params_from_reference(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays, layers
    stacked; bfloat16 as ``ml_dtypes`` arrays or their 2-byte words) as the
    port's tensors on ``device``: the port then computes what the reference
    computes."""
    check_supported(cfg)
    device = resolve_device(device)
    want = {"embed", "layers", "final_norm", "lm_head"}
    if set(tree) != want:
        raise KeyError(f"a dense LM's parameters have the keys {sorted(want)}, got {sorted(tree)}")
    dtype = getattr(torch, cfg.dtype)
    out = tree_map(lambda a: from_host(np.asarray(a), device=device), tree)
    for name in ("embed", "lm_head"):
        if out[name].dtype != dtype:
            raise TypeError(f"{name} is {out[name].dtype}, the config says {dtype}")
    return out


def params_to_reference(params: dict) -> dict:
    """The inverse of :func:`params_from_reference`: nested dicts of numpy
    arrays on the host (bfloat16 leaves as their 2-byte words)."""
    return tree_map(to_host, params)


def layer_flags(cfg: ModelConfig) -> list[int]:
    """One int a layer: 1 where a gemma-style layer is GLOBAL attention."""
    if cfg.local_global_ratio:
        period = cfg.local_global_ratio + 1
        return [int(i % period == period - 1) for i in range(cfg.n_layers)]
    return [1] * cfg.n_layers


def _apply_positional(q, k, cfg: ModelConfig, positions, is_global: int):
    """RoPE; gemma's global layers take ``rope_theta_global`` as the reference
    selects it, ``local + 1·(global − local)``."""
    ql = apply_rope(q, positions, cfg.rope_theta)
    kl = apply_rope(k, positions, cfg.rope_theta)
    if cfg.rope_theta_global and is_global:
        qg = apply_rope(q, positions, cfg.rope_theta_global)
        kg = apply_rope(k, positions, cfg.rope_theta_global)
        return ql + (qg - ql), kl + (kg - kl)
    return ql, kl


def _attention_block(p, x, cfg: ModelConfig, positions, is_global: int, q_chunk: int,
                     kv_chunk: int):
    B, S, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    q = (h @ p["attn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (h @ p["attn"]["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (h @ p["attn"]["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    q, k = _apply_positional(q, k, cfg, positions, is_global)
    window = cfg.sliding_window
    if cfg.sliding_window and cfg.local_global_ratio and is_global:
        window = 0
    out = attn.flash_attention(q, k, v, causal=True, window=window, q_chunk=q_chunk,
                               kv_chunk=kv_chunk)
    return x + out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]


def _ffn_block(p, x, cfg: ModelConfig):
    return x + apply_swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.rms_eps))


def _layer(x, lp, cfg, positions, is_global, q_chunk, kv_chunk):
    x = _attention_block(lp, x, cfg, positions, is_global, q_chunk, kv_chunk)
    return _ffn_block(lp, x, cfg)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, dist: Dist = NO_DIST,
            positions: torch.Tensor | None = None, q_chunk: int = 512, kv_chunk: int = 1024):
    """tokens (B, S) → (logits (B, S, V), aux_loss)."""
    check_supported(cfg, dist)
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    # one unbind a stacked leaf: its backward stacks the layers' gradients once
    unbound = [leaf.unbind(0) for leaf in tree_leaves(params["layers"])]
    for i, flag in enumerate(layer_flags(cfg)):
        lp = tree_unflatten(params["layers"], [u[i] for u in unbound])
        if cfg.remat:
            x = checkpoint(_layer, x, lp, cfg, positions, flag, q_chunk, kv_chunk,
                           use_reentrant=False)
        else:
            x = _layer(x, lp, cfg, positions, flag, q_chunk, kv_chunk)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = x @ params["lm_head"]
    return logits, torch.zeros((), dtype=torch.float32, device=tokens.device)


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, dist: Dist = NO_DIST,
            q_chunk: int = 512, kv_chunk: int = 1024):
    logits, aux = forward(params, batch["tokens"], cfg, dist, positions=batch.get("positions"),
                          q_chunk=q_chunk, kv_chunk=kv_chunk)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss + cfg.router_aux_coef * aux, {"nll": loss, "aux": aux}
