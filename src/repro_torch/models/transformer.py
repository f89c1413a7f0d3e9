"""The decoder-only LM of the dense, moe and vlm families: parameters,
forward, loss, prefill and cached decode (the port of
``repro.models.transformer``).

Parameters are the reference's tree: nested dicts of tensors with each block
leaf stacked over layers as ``(n_layers, ...)`` (``init_lm_params``), so
leaves flatten in the reference's order and a checkpoint has its names.
Leading dense layers (``first_k_dense``, kimi's) are the reference's
``pre_layers``, a list of unstacked block dicts that run before the stacked
ones; the stacked layers of the moe family hold an MoE FFN (``moe``: the
float32 router beside the experts, ``models/moe.py``) in place of the
``mlp``. The forward unbinds each stacked leaf once and runs the layers in
a Python loop; gemma's 5:1 local/global pattern is a branch on the static
per-layer flag (the reference's ``lax.cond``) and each layer, the leading
ones too, is recomputed in the backward pass when ``cfg.remat`` (the
reference's ``jax.checkpoint``; a remat policy changes no value, so every
policy recomputes the whole layer). ``forward`` returns the stacked MoE
layers' load-balance losses summed, and ``lm_loss`` adds
``router_aux_coef`` times that to the loss.

The vlm family is the same backbone with M-RoPE over ``(3, B, S)``
positions and precomputed vision embeddings written over tokens ``1 … nv``
(the vision tower is a stub in the reference too).

Serving runs under ``torch.inference_mode()`` and recomputes nothing.
``prefill`` returns the last token's logits and the post-RoPE KV cache
``{"k", "v"}`` of shape ``(L, B, S, Hkv, hd)`` (with leading dense layers
also ``{"pre_k", "pre_v"}``, theirs); ``decode_step`` writes one token's
key and value into the cache in place (the reference returns an updated
copy) and attends over the whole cache in float32.

A ``Dist`` carries the reference's distribution fields. As under GSPMD they
place values and change none, with one exception, the reference's: an MoE
layer takes expert parallelism (``moe.moe_apply_ep``) when the mesh spans a
process group, ``use_ep`` is set and the sequence splits over the
``tp_axis`` ranks. Each of those ranks holds every parameter and the same
activations; it hands ``moe_apply_ep`` its block of the sequence and its
view of its block of the experts, and gathers the output back over the
axis (the gather's backward takes the rank's own block, the slice's
gathers every rank's). Otherwise, and in a decode step (S = 1), the layer
runs ``moe_apply_local`` on the rank's tokens. The port's data-parallel
trainer replicates the parameters on each rank and gives it a block of the
batch (``train/trainer.py``): there the router's load-balance statistics
are averaged over the data ranks before their product, so the aux loss is
the global batch's, as the reference's one call over that batch computes
it; the capacity is the rank's block's, so where slots drop, others do
than in the reference. A mesh without a process group places nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.cluster.bootstrap import axis_group
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
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
from repro_torch.utils.device import resolve_device
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


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device``; on the meta device (shapes
    only, nothing drawn) a CPU generator."""
    gen = torch.Generator(device="cpu" if torch.device(device).type == "meta" else device)
    gen.manual_seed(int(seed))
    return gen


def _init_block(gen, cfg: ModelConfig, moe_layer: bool, dtype, device, lead: tuple) -> dict:
    p = {
        "ln1": init_rms(cfg.d_model, device, lead),
        "ln2": init_rms(cfg.d_model, device, lead),
        "attn": attn.init_attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                      dtype, device, lead),
    }
    if moe_layer:
        p["moe"] = moe_mod.init_moe_params(gen, cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                                           cfg.n_shared_experts, cfg.moe_d_ff, dtype, device,
                                           lead)
    else:
        p["mlp"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device, lead)
    return p


def init_lm_params(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's parameter tree for ``cfg``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = generator(seed, device)
    dtype = getattr(torch, cfg.dtype)
    layers = _init_block(gen, cfg, cfg.family == "moe", dtype, device,
                         (cfg.n_layers - cfg.first_k_dense,))
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "layers": layers,
        "final_norm": init_rms(cfg.d_model, device),
        "lm_head": truncated_normal_init(gen, (cfg.d_model, cfg.vocab_size), 1.0, dtype, device),
    }
    if cfg.first_k_dense:
        params["pre_layers"] = [_init_block(gen, cfg, False, dtype, device, ())
                                for _ in range(cfg.first_k_dense)]
    return params


def tree_keys(cfg: ModelConfig) -> frozenset:
    """The top-level keys of ``cfg``'s parameter tree."""
    keys = {"embed", "layers", "final_norm", "lm_head"}
    return frozenset(keys | {"pre_layers"} if cfg.first_k_dense else keys)


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
    """One int a stacked layer: 1 where a gemma-style layer is GLOBAL
    attention (the leading dense layers are global)."""
    n_scan = cfg.n_layers - cfg.first_k_dense
    if cfg.local_global_ratio:
        period = cfg.local_global_ratio + 1
        return [int(i % period == period - 1) for i in range(n_scan)]
    return [1] * n_scan


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


def _ep_group(dist: Dist):
    """The ``tp_axis`` group an MoE layer takes expert parallelism over, or
    None: the reference's ``mesh is not None and use_ep``, for a mesh that
    spans a process group."""
    mesh = dist.mesh
    if mesh is None or not mesh.collective or not dist.use_ep or dist.tp_axis is None:
        return None
    return axis_group(mesh, (dist.tp_axis,))


def _data_group(dist: Dist):
    """The ``dp_axes`` group whose ranks hold blocks of the batch, or None
    (no mesh, or one that spans no process group)."""
    mesh = dist.mesh
    if mesh is None or not mesh.collective:
        return None
    return axis_group(mesh, dist.dp_axes)


def _ffn_block(p, x, cfg: ModelConfig, dist: Dist):
    """The FFN sublayer: (x + FFN(norm(x)), the MoE layer's aux loss or 0)."""
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" not in p:
        return x + apply_swiglu(p["mlp"], h), aux
    ep = _ep_group(dist)
    # all-to-all EP needs the sequence to split across the expert axis; decode
    # (S = 1) falls through to the local path
    if ep is not None and x.shape[1] % ep.size == 0:
        args = (1, ep.index, ep.size, ep.group)
        hl = moe_mod.SliceOf.apply(h, *args) if ep.group is not None else h
        y, aux = moe_mod.moe_apply_ep(moe_mod.ep_block(p["moe"], ep), hl,
                                      cfg.experts_per_token, cfg.capacity_factor, dist.mesh,
                                      dist.dp_axes, dist.tp_axis)
        if ep.group is not None:
            y = moe_mod.GatherSlices.apply(y, *args)
    else:
        B, S, d = h.shape
        y, aux = moe_mod.moe_apply_local(p["moe"], h.reshape(B * S, d), cfg.experts_per_token,
                                         cfg.capacity_factor, _data_group(dist))
        y = y.reshape(B, S, d)
    return x + y, aux


def _layer(x, layer, cfg, positions, dist, q_chunk, kv_chunk):
    lp, is_global = layer
    x = _attention_block(lp, x, cfg, positions, is_global, q_chunk, kv_chunk)
    return _ffn_block(lp, x, cfg, dist)


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
    x, positions = _embed_inputs(params, tokens, cfg, positions, vision_embeds)
    args = (cfg, positions, dist, q_chunk, kv_chunk)
    # the leading dense layers (global attention, no aux), then the stacked
    x = run_blocks(_layer, x, [(lp, 1) for lp in params.get("pre_layers", [])], cfg.remat,
                   *args, aux=[])
    auxs = []
    x = run_blocks(_layer, x, zip(unstack(params["layers"]), layer_flags(cfg)), cfg.remat, *args,
                   aux=auxs)
    aux = torch.stack(auxs).sum()
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x @ params["lm_head"], aux


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


def _cached_layers(params: dict, cfg: ModelConfig):
    """(cache key prefix, index, parameters, global flag) of every layer in
    order: the leading dense layers (``pre_k``/``pre_v``), then the stacked."""
    for i, lp in enumerate(params.get("pre_layers", [])):
        yield "pre_", i, lp, 1
    for i, flag in enumerate(layer_flags(cfg)):
        yield "", i, _layer_params(params, i), flag


@torch.inference_mode()
def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, dist: Dist = NO_DIST,
            positions: torch.Tensor | None = None, vision_embeds: torch.Tensor | None = None,
            q_chunk: int = 512, kv_chunk: int = 1024, cache_dtype=torch.bfloat16):
    """Process a prompt, returning (last-token logits (B, V), KV cache).

    The cache holds post-RoPE keys (matching decode_step's convention), each
    layer's written into one ``(L, B, S, Hkv, hd)`` tensor of ``cache_dtype``
    as the layer runs (the leading dense layers' into ``pre_k``/``pre_v``).
    The final norm and ``lm_head`` see the last token only, so no (B, S, V)
    logits exist.
    """
    B, S = tokens.shape
    x, positions = _embed_inputs(params, tokens, cfg, positions, vision_embeds)
    cache = _empty_cache(cfg, B, S, cache_dtype, x.device, torch.empty)
    for pre, i, lp, flag in _cached_layers(params, cfg):
        x, (k, v) = _attention_block(lp, x, cfg, positions, flag, q_chunk, kv_chunk,
                                     collect_kv=True)
        cache[pre + "k"][i] = k.to(cache_dtype)
        cache[pre + "v"][i] = v.to(cache_dtype)
        del k, v
        x, _ = _ffn_block(lp, x, cfg, dist)
    x = rms_norm(x[:, -1], params["final_norm"], cfg.rms_eps)
    return x @ params["lm_head"], cache


def _empty_cache(cfg: ModelConfig, batch: int, length: int, dtype, device, alloc) -> dict:
    """The cache's tensors, in the reference's key order: ``pre_k``/``pre_v``
    of the leading dense layers first, then the stacked layers' ``k``/``v``."""
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    cache = {}
    if cfg.first_k_dense:
        for name in ("pre_k", "pre_v"):
            cache[name] = alloc((cfg.first_k_dense, *shape), dtype=dtype, device=device)
    for name in ("k", "v"):
        cache[name] = alloc((cfg.n_layers - cfg.first_k_dense, *shape), dtype=dtype,
                            device=device)
    return cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda") -> dict:
    """A zero KV cache ``{"k", "v"}`` of shape ``(L, batch, max_len, Hkv, hd)``
    (and ``{"pre_k", "pre_v"}`` for the leading dense layers)."""
    return _empty_cache(cfg, batch, max_len, dtype, resolve_device(device), torch.zeros)


@torch.inference_mode()
def decode_step(params: dict, token: torch.Tensor, cache: dict, cur_len, cfg: ModelConfig,
                dist: Dist = NO_DIST):
    """One incremental decode step.

    token (B, 1) integers; ``cur_len`` — number of valid tokens *after* this
    one. Writes the token's keys and values into ``cache`` at ``cur_len − 1``
    in place and returns (logits (B, V), cache). The vlm family's three
    position streams all take ``cur_len − 1``, as the reference's do.
    """
    cur_len = int(cur_len)
    B = token.shape[0]
    x = embed(params["embed"], token)                        # (B, 1, d)
    positions = torch.full((B, 1), cur_len - 1, dtype=torch.int64, device=x.device)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, B, 1)
    for pre, i, lp, flag in _cached_layers(params, cfg):
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        q = (h @ lp["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
        k = (h @ lp["attn"]["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
        v = (h @ lp["attn"]["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
        q, k = _apply_positional(q, k, cfg, positions, flag)
        kc = attn.update_cache(cache[pre + "k"][i], k, cur_len - 1)
        vc = attn.update_cache(cache[pre + "v"][i], v, cur_len - 1)
        out = attn.decode_attention(q, kc, vc, cur_len, window=_window(cfg, flag))
        x = x + out.reshape(B, 1, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
        x, _ = _ffn_block(lp, x, cfg, dist)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"])[:, 0], cache
