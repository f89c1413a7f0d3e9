"""Shared model building blocks: norms, the SwiGLU MLP, embeddings, RoPE and
the chunked cross-entropy (the port of ``repro.models.common``).

Functional style over parameter dicts of tensors, as the reference's: the
same arithmetic in the same dtypes — norms and RoPE in float32, cast back to
the activations' dtype; matmuls in the parameters' dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def truncated_normal_init(gen: torch.Generator, shape, scale: float, dtype,
                          device) -> torch.Tensor:
    """Scaled truncated normal (std = scale / sqrt(fan_in), cut at ±2σ), drawn
    from ``gen`` on ``device`` (not bit-equal to ``jax.random``'s)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (scale / math.sqrt(fan_in))).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def init_rms(d: int, device, lead: tuple = ()) -> torch.Tensor:
    return torch.zeros((*lead, d), dtype=torch.float32, device=device)  # stored as offset from 1


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x·gate) ⊙ (x·up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def init_swiglu(gen, d: int, f: int, dtype, device, lead: tuple = ()) -> dict:
    """The MLP's weights; ``lead`` stacks them, e.g. ``(n_layers,)``."""
    return {
        "gate": truncated_normal_init(gen, (*lead, d, f), 1.0, dtype, device),
        "up": truncated_normal_init(gen, (*lead, d, f), 1.0, dtype, device),
        "down": truncated_normal_init(gen, (*lead, f, d), 1.0, dtype, device),
    }


def apply_swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["gate"], p["up"], p["down"])


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (B, S) integers."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                          # (hd/2,)
    ang = positions[..., None].float() * freqs                       # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary dims are split into (t, h, w)
    sections, each rotated by its own position stream, in float32.

    x: (B, S, H, hd); positions_3d: (3, B, S); sections sum to hd//2.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to head_dim/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)                          # (hd/2,)
    # the position stream of each rotary dim, from comparisons on the device
    # (a repeat_interleave by a tensor of counts would wait for the card)
    dim = torch.arange(hd // 2, device=x.device)
    sec_id = (dim >= sections[0]).long() + (dim >= sections[0] + sections[1]).long()
    ang = positions_3d[sec_id].movedim(0, -1).float() * freqs       # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def init_embedding(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    return (w.normal_(0.0, 1.0, generator=gen) * 0.02).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)


def _chunk_nll(lg: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    lg = lg.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, lb[..., None].long())[..., 0]
    return lse - gold


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None, chunks: int = 8) -> torch.Tensor:
    """Mean token NLL with a float32 logsumexp, over ``chunks`` slices of S,
    each recomputed in the backward pass: no float32 copy of the whole
    (B, S, V) logits exists, only one slice's."""
    s = logits.shape[1]
    nc = chunks if s % chunks == 0 else 1
    nll = torch.cat([checkpoint(_chunk_nll, lg, lb, use_reentrant=False)
                     for lg, lb in zip(logits.split(s // nc, dim=1), labels.split(s // nc, dim=1))],
                    dim=1)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
