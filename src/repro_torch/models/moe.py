"""Mixture-of-Experts FFN: top-k token-choice routing with capacity, two paths
(the port of ``repro.models.moe``).

- ``moe_apply_local``: single-shard sort-based dispatch (one device, and the
  decode step under expert parallelism).
- ``moe_apply_ep``: expert parallelism over ``torch.distributed`` — each rank
  of the mesh's ``ep_axis`` holds its block of the sequence and its block of
  the experts, and two all-to-alls within that axis's group move token
  activations to their experts' owner and back. Capacity-dropped tokens fall
  through on the residual path, standard for capacity-based MoE.

Routing uses softmax-then-top-k with gate renormalization and the
switch-style load-balance auxiliary loss.

Every dispatch is a permutation of rows with holes, so it is written as
gathers: a buffer row reads the token it holds, a token reads its slots'
rows back, and each direction's backward is the other direction's gather
(``_RowMap``). Nothing scatters a float: a token's k slots are summed in a
fixed order (ascending expert; under EP the reference's rank order), so the
card repeats its sums bit for bit, and a slot past its bucket's capacity
reads and writes a zero row instead of an index out of range. Ties in top-k
go to the lower expert (a stable descending sort, as ``lax.top_k``), and
which slots a full bucket keeps follows a stable sort, as the reference's
``argsort``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as torch_dist
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.cluster.bootstrap import AxisGroup, axis_group
from repro_torch.models.common import apply_swiglu, init_swiglu, matmul, truncated_normal_init

# elements of a float32 temporary an expert weight's draw may take at once
_DRAW_BLOCK = 1 << 28


def _init_experts(gen, shape, dtype, device) -> torch.Tensor:
    """``truncated_normal_init`` of a ``(..., E, a, b)`` leaf (fan-in ``a``),
    drawn a block of experts at a time so that no float32 copy of the whole
    leaf exists."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, shape[-2], shape[-1])
    step = max(1, _DRAW_BLOCK // (shape[-2] * shape[-1]))
    for i in range(0, flat.shape[0], step):
        j = min(i + step, flat.shape[0])
        flat[i:j] = truncated_normal_init(gen, (j - i, shape[-2], shape[-1]), 1.0, dtype, device)
    return out


def init_moe_params(gen, d: int, f_expert: int, n_experts: int, n_shared: int,
                    d_ff_shared: int, dtype, device, lead: tuple = ()) -> dict:
    """The MoE FFN's weights, drawn from ``gen``: the float32 router
    ``(d, E)``, the experts' ``(E, d, f)`` / ``(E, f, d)`` and, with shared
    experts, one SwiGLU of width ``n_shared · f_expert``; ``lead`` stacks
    them, e.g. ``(n_layers,)``."""
    p = {
        "router": truncated_normal_init(gen, (*lead, d, n_experts), 1.0, torch.float32, device),
        "w_gate": _init_experts(gen, (*lead, n_experts, d, f_expert), dtype, device),
        "w_up": _init_experts(gen, (*lead, n_experts, d, f_expert), dtype, device),
        "w_down": _init_experts(gen, (*lead, n_experts, f_expert, d), dtype, device),
    }
    if n_shared:
        p["shared"] = init_swiglu(gen, d, n_shared * f_expert, dtype, device, lead)
    return p


def route(router_w: torch.Tensor, x: torch.Tensor, k: int):
    """Top-k routing. x (T, d) → (ids (T,k), gates (T,k), me (E,), ce (E,)).

    me/ce are the switch load-balance statistics (mean router prob / top-1
    fraction per expert); the caller combines them as aux = E·Σ me·ce —
    distributed callers average them over the ranks FIRST so the loss
    matches the global batch. Equal probabilities rank the lower expert
    first, as ``lax.top_k`` does.
    """
    logits = matmul(x.float(), router_w)                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    ids = torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :k]
    gates = torch.gather(probs, -1, ids)
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)
    e = router_w.shape[1]
    me = torch.mean(probs, dim=0)                                    # (E,)
    ce = torch.mean(F.one_hot(ids[:, 0], e).float(), dim=0)
    return ids, gates, me, ce


def aux_loss(me: torch.Tensor, ce: torch.Tensor) -> torch.Tensor:
    return me.shape[0] * torch.sum(me * ce)


def capacity(tokens: int, k: int, buckets: int, capacity_factor: float) -> int:
    """A bucket's slots, as the reference computes them in Python floats:
    ⌈tokens·k/buckets·cf⌉ rounded up to a multiple of 8, at least 8."""
    cap = int(math.ceil(tokens * k / buckets * capacity_factor))
    return max(8, -(-cap // 8) * 8)


def _dispatch_indices(flat_expert: torch.Tensor, n_buckets: int, capacity: int):
    """Sort slots by destination bucket; return (sort order, sorted bucket,
    position-in-bucket, keep mask). Works for both rank buckets and
    local-expert buckets."""
    s = flat_expert.shape[0]
    order = torch.argsort(flat_expert, stable=True)
    sorted_e = flat_expert[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_buckets, device=flat_expert.device,
                                                       dtype=sorted_e.dtype))
    pos = torch.arange(s, device=flat_expert.device) - starts[sorted_e]
    keep = pos < capacity
    return order, sorted_e, pos, keep


def _slot_maps(order, sorted_b, pos, keep, capacity: int, n_rows: int):
    """The two directions of a dispatch: ``loc[j]``, the buffer row of slot
    j (``n_rows`` where it was dropped), and ``slot_of[q]``, the slot buffer
    row q holds (the number of slots where it holds none)."""
    n_slots = order.shape[0]
    loc_sorted = torch.where(keep, sorted_b * capacity + pos, n_rows)
    loc = torch.empty_like(loc_sorted).scatter_(0, order, loc_sorted)
    # dropped slots all land on the extra row n_rows, which is cut off
    slot_of = torch.full((n_rows + 1,), n_slots, dtype=order.dtype, device=order.device)
    slot_of = slot_of.scatter_(0, loc_sorted, order)[:n_rows]
    return loc, slot_of


def _take(x: torch.Tensor, idx: torch.Tensor, group: int) -> torch.Tensor:
    """Rows of x at ``idx`` (``len(x)`` reads a zero row), consecutive runs
    of ``group`` summed in order."""
    pad = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    out = pad.index_select(0, idx)
    if group == 1:
        return out
    out = out.view(-1, group, *x.shape[1:])
    acc = out[:, 0]
    for j in range(1, group):
        acc = acc + out[:, j]
    return acc


class _RowMap(torch.autograd.Function):
    """``_take(x, idx, group)``, whose backward is ``_take(grad, back,
    back_group)``: the caller passes the transposed map, so neither
    direction scatters."""

    @staticmethod
    def forward(ctx, x, idx, group, back, back_group):
        ctx.save_for_backward(back)
        ctx.back_group = back_group
        return _take(x, idx, group)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        back, = ctx.saved_tensors
        return _take(g.contiguous(), back, ctx.back_group), None, None, None, None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    torch_dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """Block i of dim 0 to the group's rank i (``lax.all_to_all`` with
    ``split_axis = concat_axis = 0``); its backward is the same exchange of
    the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


class _MeanOverRanks(torch.autograd.Function):
    """The mean of x over the group's ranks (``lax.pmean``). Every rank
    holds the same mean, and the loss built on it; the backward hands each
    rank ``grad_scale`` times that loss's gradient. Where the ranks'
    parameter gradients are summed (expert parallelism, as the reference's
    ``jax.grad`` through its ``pmean``) that is 1/n; where the data-parallel
    trainer averages them, 1: either way the parameters get the global
    batch's gradient."""

    @staticmethod
    def forward(ctx, x, group, n, grad_scale):
        ctx.grad_scale = grad_scale
        y = x.detach().clone()
        torch_dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None, None


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the group: a
    parameter every rank holds whole (the router, the shared expert) but
    applies to its own tokens only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch_dist.all_reduce(g, group=ctx.group)
        return g, None


class SliceOf(torch.autograd.Function):
    """This rank's block ``index`` of ``n`` along ``dim`` of a value every
    rank of the group holds alike; the backward gathers every rank's
    gradient block, so each rank's upstream gradient is whole."""

    @staticmethod
    def forward(ctx, x, dim, index, n, group):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        size = x.shape[dim] // n
        return x.narrow(dim, index * size, size).contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.n, ctx.group), None, None, None, None


class GatherSlices(torch.autograd.Function):
    """Every rank's block along ``dim``, concatenated in rank order. Every
    rank then computes the same values downstream, so the backward takes
    the rank's own block of the gradient (not a sum over the ranks)."""

    @staticmethod
    def forward(ctx, x, dim, index, n, group):
        ctx.dim, ctx.index, ctx.n = dim, index, n
        return _all_gather(x, dim, n, group)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        size = g.shape[ctx.dim] // ctx.n
        return g.narrow(ctx.dim, ctx.index * size, size).contiguous(), None, None, None, None


def _all_gather(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    torch_dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def expert_ffn(w_gate, w_up, w_down, buf: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU. buf (E, C, d) with weights (E, d, f)/(E, f, d), as
    batched matmuls in the operands' promoted dtype."""
    h = F.silu(matmul(buf, w_gate)) * matmul(buf, w_up)
    return matmul(h, w_down)


def _order_within_tokens(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, inv) of each token's k slots sorted by ``key`` (T, k), stably:
    ``perm[t]`` lists the slots in that order, ``inv`` is its inverse."""
    perm = torch.argsort(key, dim=1, stable=True)
    inv = torch.argsort(perm, dim=1)
    return perm, inv


def _permuted_slots(slot_of: torch.Tensor, inv: torch.Tensor, k: int) -> torch.Tensor:
    """``slot_of`` (slot indices t·k + i, the slot count for none) in the
    layout where token t's slots are in ``perm[t]``'s order."""
    n_slots = inv.numel()
    t = torch.clamp(slot_of, max=n_slots - 1)
    moved = (t // k) * k + inv.reshape(-1)[t]
    return torch.where(slot_of < n_slots, moved, n_slots)


def moe_apply_local(params: dict, x: torch.Tensor, k: int, capacity_factor: float,
                    stats: AxisGroup | None = None):
    """Single-shard MoE on tokens x (T, d). Returns (y, aux_loss).

    With ``stats`` (the data ranks of the data-parallel trainer, each with
    its block of the batch) the load-balance statistics are averaged over
    its ranks before the product, so aux is the global batch's, as the
    reference's one call over the global batch computes it. The capacity
    stays this rank's, ⌈T·k/E·cf⌉ of its own T tokens: where a bucket
    overflows, which slots drop differs from the reference's."""
    t, d = x.shape
    e = params["router"].shape[1]
    ids, gates, me, ce = route(params["router"], x, k)
    if stats is not None and stats.group is not None:
        me = _MeanOverRanks.apply(me, stats.group, stats.size, 1.0)
        ce = _MeanOverRanks.apply(ce, stats.group, stats.size, 1.0)
    aux = aux_loss(me, ce)
    cap = capacity(t, k, e, capacity_factor)
    n_rows = e * cap

    flat_e = ids.reshape(-1)                                         # (T·k,)
    order, sorted_e, pos, keep = _dispatch_indices(flat_e, e, cap)
    loc, slot_of = _slot_maps(order, sorted_e, pos, keep, cap, n_rows)
    tok_of = torch.where(slot_of < t * k, slot_of // k, t)
    buf = _RowMap.apply(x, tok_of, 1, loc, k).view(e, cap, d)
    out_buf = expert_ffn(params["w_gate"], params["w_up"], params["w_down"], buf)
    # each token reads its slots back in ascending expert order (the
    # reference's sorted order), weighted by the gate, and sums them in x's dtype
    perm, inv = _order_within_tokens(ids)
    loc_p = torch.gather(loc.view(t, k), 1, perm).reshape(-1)
    vals = _RowMap.apply(out_buf.reshape(n_rows, d), loc_p, 1,
                         _permuted_slots(slot_of, inv, k), 1)
    gate_p = torch.gather(gates, 1, perm).reshape(-1, 1)
    slot_out = (vals * gate_p).to(x.dtype).view(t, k, d)
    y = slot_out[:, 0]
    for j in range(1, k):
        y = y + slot_out[:, j]
    if "shared" in params:
        y = y + apply_swiglu(params["shared"], x)
    return y, aux


def ep_block(params: dict, group) -> dict:
    """This rank's view of an MoE layer under expert parallelism over
    ``group`` (a ``cluster.bootstrap.AxisGroup``): the router and shared
    expert whole, its block of E/n experts of each expert weight (views,
    not copies)."""
    e = params["router"].shape[-1]
    if e % group.size:
        raise ValueError(f"{e} experts do not split over {group.size} ranks")
    e_loc = e // group.size
    out = dict(params)
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = params[name][group.index * e_loc:(group.index + 1) * e_loc]
    return out


def moe_apply_ep(params: dict, x: torch.Tensor, k: int, capacity_factor: float, mesh,
                 dp_axes: tuple[str, ...], ep_axis: str):
    """Distributed MoE on this rank's tokens x (B_l, S_l, d) — its block of
    the batch over ``dp_axes`` and of the sequence over ``ep_axis`` — with
    the router and shared expert whole and its block of the experts,
    ``(E/n_ep, d, f)`` (``ep_block``). Two all-to-alls a layer within the
    ``ep_axis`` group; without a process group it is one rank, whose
    all-to-alls are the identity. Returns (y_l (B_l, S_l, d), aux)."""
    ep = axis_group(mesh, (ep_axis,)) if mesh is not None else AxisGroup(None, (0,), 0)
    stats = axis_group(mesh, (ep_axis, *dp_axes)) if mesh is not None else ep
    n_ep = ep.size
    router, w_gate, w_up, w_down = (params[n] for n in ("router", "w_gate", "w_up", "w_down"))
    shared = params.get("shared")
    e = router.shape[1]
    e_loc = w_gate.shape[0]
    if e_loc * n_ep != e:
        raise ValueError(f"{e_loc} local experts × {n_ep} ranks is not the router's {e}")
    if ep.group is not None:
        router = _SumGrad.apply(router, ep.group)
        if shared is not None:
            shared = {n: _SumGrad.apply(w, ep.group) for n, w in shared.items()}

    bl, sl, d = x.shape
    tl = bl * sl
    xt = x.reshape(tl, d)
    ids, gates, me, ce = route(router, xt, k)                        # the router is whole
    if stats.group is not None:
        # the statistics' mean over the ranks BEFORE the product — the
        # global-batch loss
        me = _MeanOverRanks.apply(me, stats.group, stats.size, 1.0 / stats.size)
        ce = _MeanOverRanks.apply(ce, stats.group, stats.size, 1.0 / stats.size)
    aux = aux_loss(me, ce)

    # ---- A2A dispatch: bucket slots by owner rank ---------------------------
    cap_s = capacity(tl, k, n_ep, capacity_factor)
    rows_s = n_ep * cap_s
    flat_e = ids.reshape(-1)
    rank = flat_e // e_loc
    order, sorted_r, pos, keep = _dispatch_indices(rank, n_ep, cap_s)
    loc, slot_of = _slot_maps(order, sorted_r, pos, keep, cap_s, rows_s)
    n_slots = tl * k
    tok_of = torch.where(slot_of < n_slots, slot_of // k, tl)
    send = _RowMap.apply(xt, tok_of, 1, loc, k)
    # metadata rides along as fp32 lanes: local expert id + 1, gate
    lanes = torch.stack([(flat_e % e_loc).float() + 1.0, gates.reshape(-1)], dim=-1)
    meta = _RowMap.apply(lanes, slot_of, 1, loc, 1)
    if ep.group is not None:
        recv = _AllToAll.apply(send.view(n_ep, cap_s, d), ep.group).view(rows_s, d)
        meta_r = _AllToAll.apply(meta.view(n_ep, cap_s, 2), ep.group).view(rows_s, 2)
    else:
        recv, meta_r = send, meta

    # ---- local expert grouping ----------------------------------------------
    r_eid, r_gate = meta_r[:, 0], meta_r[:, 1]
    valid = r_eid > 0
    loc_e = torch.where(valid, r_eid.detach() - 1.0,
                        torch.full_like(r_eid, e_loc)).long()       # invalid → overflow bucket
    cap_e = capacity(rows_s, 1, e_loc, capacity_factor)
    rows_e = e_loc * cap_e
    order2, sorted_e2, pos2, keep2 = _dispatch_indices(loc_e, e_loc + 1, cap_e)
    in_range = keep2 & (sorted_e2 < e_loc)
    loc2, slot2_of = _slot_maps(order2, sorted_e2, pos2, in_range, cap_e, rows_e)
    buf = _RowMap.apply(recv, slot2_of, 1, loc2, 1).view(e_loc, cap_e, d)
    out_buf = expert_ffn(w_gate, w_up, w_down, buf)
    slot_out = _RowMap.apply(out_buf.reshape(rows_e, d), loc2, 1, slot2_of, 1)
    slot_out = slot_out * r_gate[:, None].to(slot_out.dtype)

    # ---- A2A return + combine -----------------------------------------------
    if ep.group is not None:
        back = _AllToAll.apply(slot_out.view(n_ep, cap_s, d), ep.group).view(rows_s, d)
    else:
        back = slot_out
    # a token's slots summed in the reference's order: by owner rank, then slot
    perm, inv = _order_within_tokens(rank.view(tl, k))
    loc_p = torch.gather(loc.view(tl, k), 1, perm).reshape(-1)
    y = _RowMap.apply(back, loc_p, k, tok_of, 1)
    yl = y.view(bl, sl, d)
    if shared is not None:
        yl = yl + apply_swiglu(shared, x)
    return yl, aux
