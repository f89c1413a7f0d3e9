"""AdamW with global-norm clipping, configurable moment dtypes and an
Adafactor-style factored second moment (the port of
``repro.train.optimizer``).

The state is the reference's tree: ``{"m": like params, "v": like params
(or ``{"row", "col"}`` per factored leaf), "step": int32 scalar}``. The update
runs in place on the parameter and moment tensors (the reference donates
them) and does its per-leaf math in float32, one slice of a large leaf at a
time: the math is elementwise (and the factored means run over the last two
axes), so slicing the leading axis gives the whole leaf's values.

Over a placed state (``layout=``, ``train/fsdp.py``) the update runs on the
rank's blocks: the global norm adds the blocks' squares over the ranks (one
scalar all-reduce) to the whole leaves', the weight-decay rule reads the
whole leaf's shape, and a factored second moment (whole on every rank, as
the reference's specs keep it) takes its row and column means over the
whole leaf from one small all-reduce of the blocks' partial sums.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as torch_dist

from repro_torch.core.grad_compress import count_exchange
from repro_torch.train.fsdp import Place, ring_bytes
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


def _ref_is_big(shape) -> bool:
    return math.prod(shape) * 4 > BIG_LEAF_BYTES and len(shape) >= 2 and 1 < shape[0] <= 512


def _slices(p: torch.Tensor, cfg: OptConfig):
    """Index ranges of p's leading axis to update at a time (``...``: all)."""
    n = p.shape[0] if p.ndim else 1
    if p.ndim == 0 or p.numel() * 4 <= BIG_LEAF_BYTES or (cfg.factored and p.ndim == 2):
        return [...]
    rows = max(1, (BIG_LEAF_BYTES // 4) // max(1, p.numel() // n))
    return [slice(i, min(n, i + rows)) for i in range(0, n, rows)]


@torch.no_grad()
def adamw_update(grads: Any, params: Any, state: dict, cfg: OptConfig, layout=None):
    """One AdamW step with global-norm clipping, in place on ``params`` and
    ``state``. Returns (params, state, stats). ``layout``: a placed state's
    ``fsdp.Layout``, whose blocks ``params`` and ``state`` hold."""
    places = None if layout is None else [layout.param(i) for i in range(len(layout.params))]
    step = state["step"]
    dev = step.device
    gnorm = tree_global_norm(grads) if places is None else _placed_norm(grads, places)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1c = 1 - _f32(cfg.b1, dev) ** (step + 1).float()
    b2c = 1 - _f32(cfg.b2, dev) ** (step + 1).float()
    lr = lr_at(step, cfg)

    def leaf_math(p, g, m, v, decay: bool, v_hat=None):
        """``v_hat``: the factored second moment's estimate for this slice,
        already updated (a placed leaf's), else None."""
        g32 = g.float() * scale
        if m is not None:
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
            m.copy_(m32)
            mhat = m32 / b1c
        else:
            mhat = g32
        if v_hat is None:
            new_v = _v_update(v, g32 * g32, cfg)
            tree_map(lambda dst, src: dst.copy_(src), v, new_v)
            v_hat = _v_hat(new_v)
        delta = mhat / (torch.sqrt(v_hat / b2c) + cfg.eps)
        if decay:  # no decay on norms/scalars
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    ms = tree_leaves(state["m"]) if cfg.momentum else None
    is_v = (lambda x: isinstance(x, dict) and "row" in x)
    vs = _v_leaves(state["v"], is_v)
    for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads))):
        pl = places[i] if places is not None else None
        shape = tuple(p.shape) if pl is None else pl.shape
        # the reference maps a big stacked leaf over its layers, so its decay
        # rule sees one dimension fewer there
        decay = (len(shape) - 1 if _ref_is_big(shape) else len(shape)) >= 2
        m_i = None if ms is None else ms[i]
        if pl is not None and pl.dim is not None and is_v(vs[i]):
            _factored_block(p, g, m_i, vs[i], pl, layout.rank, scale, cfg, leaf_math, decay)
            continue
        for sl in _slices(p, cfg):
            v = tree_map(lambda t: t[sl], vs[i])
            leaf_math(p[sl], g[sl], None if m_i is None else m_i[sl], v, decay)
    state["step"] = step + 1
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _placed_norm(grads, places) -> torch.Tensor:
    """The global ℓ2 norm of a placed gradient: each leaf's sum of squares
    in float32, the blocks' summed over the ranks by one all-reduce."""
    sq = [torch.dot(g.reshape(-1).float(), g.reshape(-1).float()) for g in tree_leaves(grads)]
    dev = sq[0].device
    cut = torch.stack([q for q, pl in zip(sq, places) if pl.dim is not None]
                      or [torch.zeros((), device=dev)]).sum()
    torch_dist.all_reduce(cut)
    count_exchange("fsdp-all-reduce", ring_bytes(cut, places[0].world))
    whole = [q for q, pl in zip(sq, places) if pl.dim is None]
    return torch.sqrt(cut + (torch.stack(whole).sum() if whole else 0.0))


def _factored_block(p, g, m, v: dict, pl, rank: int, scale, cfg: OptConfig, leaf_math,
                    decay: bool):
    """AdamW on rank ``rank``'s block of a leaf whose factored second moment
    (``v``, whole) needs the whole leaf's row and column means of g²: the
    block's partial sums, placed in whole-leaf buffers, summed over the
    ranks by one all-reduce; the update of ``v`` on every rank alike, then
    the block's own, a slice of its leading axis at a time."""
    nd, d = len(pl.shape), pl.dim
    row = torch.zeros(pl.shape[:-1], dtype=torch.float32, device=p.device)
    col = torch.zeros(pl.shape[:-2] + pl.shape[-1:], dtype=torch.float32, device=p.device)
    # the block's rows (columns) in the whole row (column) statistic, and in
    # the rows' mean: each cut where the leaf's cut dimension lies in it
    row_pl = Place(row.shape, d if d < nd - 1 else None, pl.world)
    col_pl = Place(col.shape, d if d < nd - 2 else nd - 2 if d == nd - 1 else None, pl.world)
    rows, cols = row_pl.block(row, rank), col_pl.block(col, rank)
    sls = _slices(p, cfg) if nd > 2 else [...]
    for sl in sls:
        g2 = (g[sl].float() * scale) ** 2
        rows[sl] += g2.sum(-1)
        cols[sl] += g2.sum(-2)
    buf = torch.cat([row.reshape(-1), col.reshape(-1)])
    torch_dist.all_reduce(buf)
    count_exchange("fsdp-all-reduce", ring_bytes(buf, pl.world))
    row = buf[:row.numel()].view(row.shape) / pl.shape[-1]
    col = buf[row.numel():].view(col.shape) / pl.shape[-2]
    v["row"].copy_(cfg.b2 * v["row"].float() + (1 - cfg.b2) * row)
    v["col"].copy_(cfg.b2 * v["col"].float() + (1 - cfg.b2) * col)
    r32, c32 = v["row"].float(), v["col"].float()
    denom = torch.clamp(torch.mean(r32, dim=-1, keepdim=True), min=1e-30)
    r_blk, c_blk = row_pl.block(r32, rank), col_pl.block(c32, rank)
    den_blk = Place(denom.shape, d if d < nd - 2 else None, pl.world).block(denom, rank)
    for sl in sls:
        v_hat = r_blk[sl][..., None] * c_blk[sl][..., None, :] / den_blk[sl][..., None]
        leaf_math(p[sl], g[sl], None if m is None else m[sl], None, decay, v_hat=v_hat)


def _v_leaves(v_tree, is_v) -> list:
    """The second moments in leaf order, a factored one as its dict."""
    if is_v(v_tree) or torch.is_tensor(v_tree):
        return [v_tree]
    items = (v_tree[k] for k in sorted(v_tree)) if isinstance(v_tree, dict) else v_tree
    return [leaf for node in items for leaf in _v_leaves(node, is_v)]
