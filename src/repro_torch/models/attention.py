"""Chunked (flash-style) attention for training and prefill, and the cached
decode path (the port of ``repro.models.attention``).

The reference's online-softmax double loop over query chunks and KV chunks,
in plain PyTorch with the same chunking: float32 scores, GQA by grouping
query heads over KV heads, a causal mask and a sliding window as an additive
``NEG_INF`` bias. Peak memory is O(q_chunk × kv_chunk) per head group, not
O(S²).

A KV chunk that the mask hides from a whole query chunk is skipped. That
gives the reference's numbers: such a chunk contributes weights that the
first visible chunk's correction ``exp(NEG_INF − max)`` multiplies by 0.

The decode path attends one token over the whole KV cache with plain
float32 einsums, as the reference does: the cache is read in its dtype and
upcast, positions at or past ``cur_len`` (and outside a sliding window) are
masked. ``update_cache`` writes a step's key or value into the cache in
place, where the reference returns an updated copy.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import truncated_normal_init

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int):
    """(q, k) additive bias from position masks."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(ok, 0.0, NEG_INF)


def _visible(q0: int, q1: int, k0: int, k1: int, causal: bool, window: int) -> bool:
    """Whether any query position in [q0, q1) sees any key in [k0, k1)."""
    if causal and k0 > q1 - 1:
        return False
    if window > 0 and q0 - (k1 - 1) >= window:
        return False
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, q_offset: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention. q (B,Sq,H,hd); k,v (B,Skv,Hkv,hd); GQA by grouping.

    Returns (B, Sq, H, hd). Chunk sizes are clipped to the sequence lengths.
    """
    B, Sq, H, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    qc = math.gcd(Sq, min(q_chunk, Sq))      # largest chunk dividing the length
    kc = math.gcd(Skv, min(kv_chunk, Skv))
    nq, nk = Sq // qc, Skv // kc
    # the reference scales by a numpy float64, which JAX takes as float32: a
    # bfloat16 q is scaled in float32
    qg = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, Sq, Hkv, G, hd)
    outs = []
    for qi in range(nq):
        q0 = q_offset + qi * qc
        qb = qg[:, qi * qc:(qi + 1) * qc]                  # (B,qc,Hkv,G,hd)
        q_pos = torch.arange(q0, q0 + qc, device=q.device)
        acc = torch.zeros((B, Hkv, G, qc, hd), dtype=torch.float32, device=q.device)
        mx = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32, device=q.device)
        den = torch.zeros((B, Hkv, G, qc), dtype=torch.float32, device=q.device)
        blocks = [ki for ki in range(nk)
                  if _visible(q0, q0 + qc, ki * kc, (ki + 1) * kc, causal, window)] or range(nk)
        for ki in blocks:
            kb = k[:, ki * kc:(ki + 1) * kc].float()                 # (B,kc,Hkv,hd)
            vb = v[:, ki * kc:(ki + 1) * kc].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb)
            k_pos = torch.arange(ki * kc, (ki + 1) * kc, device=q.device)
            s = s + _mask_bias(q_pos, k_pos, causal, window)
            new_mx = torch.maximum(mx, torch.amax(s, dim=-1))
            p = torch.exp(s - new_mx[..., None])
            corr = torch.exp(mx - new_mx)
            den = den * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
            mx = new_mx
        out = acc / torch.clamp(den[..., None], min=1e-30)
        # cast per chunk so the joined output is the input dtype, not float32
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))           # (B,qc,Hkv,G,hd)
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len, *, window: int = 0) -> torch.Tensor:
    """One-token attention over a KV cache.

    q (B,1,H,hd); caches (B,Smax,Hkv,hd); cur_len: int — tokens valid in the
    cache *including* the current one. Positions ≥ cur_len are masked; with
    a sliding window, positions ≤ cur_len−1−window are too.
    """
    B, _, H, hd = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    G = H // Hkv
    cur_len = int(cur_len)
    # the reference's numpy float64 scale makes a bfloat16 q float32, as in flash_attention
    qg = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float())
    pos = torch.arange(Smax, device=q.device)
    ok = pos < cur_len
    if window > 0:
        ok &= pos > (cur_len - 1 - window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def update_cache(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write new (B,1,Hkv,hd), cast to the cache's dtype, into cache
    (B,Smax,Hkv,hd) at sequence index pos, in place; returns the cache. The
    index is clamped so the write fits, as ``lax.dynamic_update_slice`` does."""
    pos = min(max(int(pos), 0), cache.shape[1] - new.shape[1])
    cache[:, pos:pos + new.shape[1]] = new.to(cache.dtype)
    return cache


def init_attn_params(gen, d: int, n_heads: int, n_kv: int, head_dim: int, dtype, device,
                     lead: tuple = ()) -> dict:
    """The projections; ``lead`` stacks them, e.g. ``(n_layers,)``."""
    return {
        "wq": truncated_normal_init(gen, (*lead, d, n_heads * head_dim), 1.0, dtype, device),
        "wk": truncated_normal_init(gen, (*lead, d, n_kv * head_dim), 1.0, dtype, device),
        "wv": truncated_normal_init(gen, (*lead, d, n_kv * head_dim), 1.0, dtype, device),
        "wo": truncated_normal_init(gen, (*lead, n_heads * head_dim, d), 1.0, dtype, device),
    }
