"""AdamW with global-norm clipping, configurable moment dtypes and an
Adafactor-style factored second moment (the port of
``repro.train.optimizer``).

The state is the reference's tree: ``{"m": like params, "v": like params
(or ``{"row", "col"}`` per factored leaf), "step": int32 scalar}``. The update
runs in place on the parameter and moment tensors (the reference donates
them) and does its per-leaf math in float32, one slice of a large leaf at a
time: the math is elementwise (and the factored means run over the last two
axes), so slicing the leading axis gives the whole leaf's values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_global_norm


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" halves the moments' memory
    factored: bool = False            # Adafactor-style factored v for ≥2D params
    momentum: bool = True             # False drops m entirely (Adafactor classic)


# the reference maps its update over the layers of a stacked leaf above this
# size (``_is_big``), which decides the ndim its weight decay rule sees; the
# port slices any leaf above it to bound its float32 temporaries
BIG_LEAF_BYTES = 64 << 20


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_at(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·peak, in float32."""
    dev = step.device
    s = step.float()
    warm = _f32(cfg.peak_lr, dev) * (s + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = _f32(cfg.peak_lr, dev) * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                                    * (1 + torch.cos(_f32(math.pi, dev) * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _v_init(p: torch.Tensor, cfg: OptConfig):
    dt = getattr(torch, cfg.moment_dtype)
    if cfg.factored and p.ndim >= 2:
        return {"row": torch.zeros(p.shape[:-1], dtype=dt, device=p.device),
                "col": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=dt, device=p.device)}
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def init_opt_state(params: Any, cfg: OptConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    dev = tree_leaves(params)[0].device
    state = {"v": tree_map(lambda p: _v_init(p, cfg), params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.momentum:
        state["m"] = tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
    return state


def _v_update(v, g2, cfg: OptConfig):
    if isinstance(v, dict):  # factored
        row = cfg.b2 * v["row"].float() + (1 - cfg.b2) * torch.mean(g2, dim=-1)
        col = cfg.b2 * v["col"].float() + (1 - cfg.b2) * torch.mean(g2, dim=-2)
        return {"row": row.to(v["row"].dtype), "col": col.to(v["col"].dtype)}
    return (cfg.b2 * v.float() + (1 - cfg.b2) * g2).to(v.dtype)


def _v_hat(v):
    if isinstance(v, dict):
        row, col = v["row"].float(), v["col"].float()
        denom = torch.clamp(torch.mean(row, dim=-1, keepdim=True), min=1e-30)
        return row[..., None] * col[..., None, :] / denom[..., None]
    return v.float()


def _ref_is_big(p: torch.Tensor) -> bool:
    return p.numel() * 4 > BIG_LEAF_BYTES and p.ndim >= 2 and 1 < p.shape[0] <= 512


def _slices(p: torch.Tensor, cfg: OptConfig):
    """Index ranges of p's leading axis to update at a time (``...``: all)."""
    n = p.shape[0] if p.ndim else 1
    if p.ndim == 0 or p.numel() * 4 <= BIG_LEAF_BYTES or (cfg.factored and p.ndim == 2):
        return [...]
    rows = max(1, (BIG_LEAF_BYTES // 4) // max(1, p.numel() // n))
    return [slice(i, min(n, i + rows)) for i in range(0, n, rows)]


@torch.no_grad()
def adamw_update(grads: Any, params: Any, state: dict, cfg: OptConfig):
    """One AdamW step with global-norm clipping, in place on ``params`` and
    ``state``. Returns (params, state, stats)."""
    step = state["step"]
    dev = step.device
    gnorm = tree_global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1c = 1 - _f32(cfg.b1, dev) ** (step + 1).float()
    b2c = 1 - _f32(cfg.b2, dev) ** (step + 1).float()
    lr = lr_at(step, cfg)

    def leaf_math(p, g, m, v, decay: bool):
        g32 = g.float() * scale
        if m is not None:
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
            m.copy_(m32)
            mhat = m32 / b1c
        else:
            mhat = g32
        new_v = _v_update(v, g32 * g32, cfg)
        tree_map(lambda dst, src: dst.copy_(src), v, new_v)
        delta = mhat / (torch.sqrt(_v_hat(new_v) / b2c) + cfg.eps)
        if decay:  # no decay on norms/scalars
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    ms = tree_leaves(state["m"]) if cfg.momentum else None
    is_v = (lambda x: isinstance(x, dict) and "row" in x)
    vs = _v_leaves(state["v"], is_v)
    for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads))):
        # the reference maps a big stacked leaf over its layers, so its decay
        # rule sees one dimension fewer there
        decay = (p.ndim - 1 if _ref_is_big(p) else p.ndim) >= 2
        for sl in _slices(p, cfg):
            v = tree_map(lambda t: t[sl], vs[i])
            leaf_math(p[sl], g[sl], None if ms is None else ms[i][sl], v, decay)
    state["step"] = step + 1
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _v_leaves(v_tree, is_v) -> list:
    """The second moments in leaf order, a factored one as its dict."""
    if is_v(v_tree) or torch.is_tensor(v_tree):
        return [v_tree]
    items = (v_tree[k] for k in sorted(v_tree)) if isinstance(v_tree, dict) else v_tree
    return [leaf for node in items for leaf in _v_leaves(node, is_v)]
