"""Shared model building blocks: norms, the SwiGLU MLP, embeddings, RoPE and
the chunked cross-entropy (the port of ``repro.models.common``).

Functional style over parameter dicts of tensors, as the reference's: the
same arithmetic in the same dtypes — norms and RoPE in float32, cast back to
the activations' dtype; matmuls in the operands' promoted dtype (``matmul``).

A parameter of a state placed over ranks (``train/fsdp.py``) reaches the
model as a :class:`Block`: the rank's block of it. ``run_blocks`` gathers
each layer's blocks whole inside that layer's recomputed region
(:class:`GatherBlock`), so a recomputed layer gathers again and no layer
stays whole after its use; the gather's backward reduce-scatters the layer's
gradient back to the block, a float32 mean over the ranks, into the block's
accumulator.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as torch_dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.grad_compress import count_exchange
from repro_torch.utils.device import resolve_device
from repro_torch.utils.host import from_host, to_host
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def truncated_normal_init(gen: torch.Generator, shape, scale: float, dtype,
                          device) -> torch.Tensor:
    """Scaled truncated normal (std = scale / sqrt(fan_in), cut at ±2σ), drawn
    from ``gen`` on ``device`` (not bit-equal to ``jax.random``'s)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (scale / math.sqrt(fan_in))).to(dtype)


def tree_from_reference(tree: dict, keys, cfg, device) -> dict:
    """A reference parameter tree (nested dicts of numpy arrays, layers
    stacked; bfloat16 as ``ml_dtypes`` arrays or their 2-byte words) as
    tensors on ``device``, its top-level ``keys`` and its ``embed`` and
    ``lm_head`` in ``cfg``'s dtype checked."""
    if set(tree) != set(keys):
        raise KeyError(f"a {cfg.family} LM's parameters have the keys {sorted(keys)}, got "
                       f"{sorted(tree)}")
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    out = tree_map(lambda a: from_host(np.asarray(a), device=device), tree)
    for name in ("embed", "lm_head"):
        if out[name].dtype != dtype:
            raise TypeError(f"{name} is {out[name].dtype}, the config says {dtype}")
    return out


def params_to_reference(params: dict) -> dict:
    """The inverse of :func:`tree_from_reference`: nested dicts of numpy
    arrays on the host (bfloat16 leaves as their 2-byte words)."""
    return tree_map(to_host, params)


@dataclasses.dataclass(eq=False)
class Block:
    """This rank's block of a parameter placed over the ranks of the default
    process group: ``data`` is the parameter's part at ``rank·s … (rank+1)·s``
    along ``dim`` (s its size there), the ranks' blocks in rank order.
    ``acc`` (float32, ``data``'s shape) receives the block of the gradient;
    ``anchor`` is a scalar that requires grad, which joins the gather to the
    graph (``data`` itself carries no autograd). A stacked leaf's block keeps
    its layer axis first: :meth:`layers` gives one block a layer."""

    data: torch.Tensor
    dim: int
    acc: torch.Tensor
    anchor: torch.Tensor

    def layers(self) -> list["Block"]:
        return [Block(d, self.dim - 1, a, self.anchor)
                for d, a in zip(self.data.unbind(0), self.acc.unbind(0))]


def all_gather_dim(block: torch.Tensor, dim: int, mode: str = "fsdp-all-gather") -> torch.Tensor:
    """The whole tensor whose blocks along ``dim`` the ranks hold, in rank
    order: one all-gather over the default group (contiguous)."""
    world = torch_dist.get_world_size()
    part = block.movedim(dim, 0).contiguous()
    out = torch.empty((world * part.shape[0], *part.shape[1:]), dtype=part.dtype,
                      device=part.device)
    torch_dist.all_gather_into_tensor(out, part)
    count_exchange(mode, (world - 1) * part.numel() * part.element_size())
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_scatter_mean(whole: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the ranks' float32 mean of
    ``whole``: one reduce-scatter over the default group."""
    world = torch_dist.get_world_size()
    full = whole.movedim(dim, 0).to(torch.float32).contiguous()
    out = torch.empty((full.shape[0] // world, *full.shape[1:]), dtype=torch.float32,
                      device=full.device)
    torch_dist.reduce_scatter_tensor(out, full)
    count_exchange("fsdp-reduce-scatter", (world - 1) * out.numel() * out.element_size())
    return out.div_(world).movedim(0, dim)


class GatherBlock(torch.autograd.Function):
    """A :class:`Block` gathered whole; the backward adds the block of the
    ranks' mean gradient into the block's ``acc`` and passes nothing on."""

    @staticmethod
    def forward(ctx, anchor, data, dim, acc):
        ctx.dim, ctx.acc = dim, acc
        return all_gather_dim(data, dim)

    @staticmethod
    def backward(ctx, grad):
        ctx.acc.add_(reduce_scatter_mean(grad, ctx.dim))
        return None, None, None, None


def gather(b: "Block") -> torch.Tensor:
    """The whole parameter of a :class:`Block` (a tensor stays as it is)."""
    if not isinstance(b, Block):
        return b
    return GatherBlock.apply(b.anchor, b.data, b.dim, b.acc)


def unstack(layers: dict) -> list[dict]:
    """A stacked layer tree (each leaf ``(n_layers, ...)``) as one parameter
    dict a layer: one unbind a stacked leaf, whose backward stacks the
    layers' gradients once; a stacked :class:`Block` as one block a layer."""
    unbound = [leaf.layers() if isinstance(leaf, Block) else leaf.unbind(0)
               for leaf in tree_leaves(layers)]
    return [tree_unflatten(layers, [u[i] for u in unbound]) for i in range(len(unbound[0]))]


def run_blocks(block, x: torch.Tensor, lps, remat: bool, *args,
               aux: list | None = None) -> torch.Tensor:
    """x through ``block(x, lp, *args)`` for each layer's ``lp`` in turn, each
    recomputed in the backward pass when ``remat`` and autograd is on (the
    reference's ``jax.checkpoint``). With ``aux`` a list, ``block`` returns
    ``(x, a)`` and each layer's ``a`` is appended to it. A layer whose
    ``lp`` holds :class:`Block` leaves gathers them whole inside its
    recomputed region."""
    remat = remat and torch.is_grad_enabled()

    def gathered(x, lp, *args):
        return block(x, tree_map(gather, lp), *args)

    for lp in lps:
        fn = gathered if any(isinstance(t, Block) for t in tree_leaves(lp)) else block
        out = checkpoint(fn, x, lp, *args, use_reentrant=False) if remat else fn(x, lp, *args)
        if aux is None:
            x = out
        else:
            x, a = out
            aux.append(a)
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def init_rms(d: int, device, lead: tuple = ()) -> torch.Tensor:
    return torch.zeros((*lead, d), dtype=torch.float32, device=device)  # stored as offset from 1


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the two operands' promoted dtype, as JAX's ``@``: float32
    activations through bfloat16 weights stay float32."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x·gate) ⊙ (x·up) )."""
    return matmul(F.silu(matmul(x, w_gate)) * matmul(x, w_up), w_down)


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
