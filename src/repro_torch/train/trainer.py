"""The trainer: state, and the (state, batch) → (state, metrics) step (the
port of ``repro.train.trainer``), on one device or data-parallel over the
ranks of a ``torch.distributed`` group.

A step takes the gradients by autograd (micro-batch by micro-batch when
``accum_steps > 1``), compresses them with the paper's sketch under the
repo's key discipline (``core.grad_compress``, keyed by
``fold_in_str(key, "grad-compress")`` and the optimizer's step), and applies
AdamW. Its metrics carry the reference's names (``loss``, ``wire_floats``,
``grad_norm``, ``lr``, and ``nll``/``aux`` without accumulation); the moe
family's loss carries its routers' load-balance term.

Data parallel (a ``Dist`` whose mesh, from ``launch.mesh``, spans the
ranks): parameters are replicated, and each rank runs the accumulation loop
on its contiguous block of each micro-batch of the global batch
(``sharding.local_batch``, the reference's ``batch_shardings(...,
dp_only=True)``). The moe family's load-balance statistics are averaged
over the ranks (``moe.moe_apply_local``), so its aux loss is the global
micro-batch's; its capacity is the rank's block's. The compressed gradient
crosses ranks as the shared-mask exchange (one all-reduce of the kept
values, ``grad_compress.compress_flat``), so every rank applies the same
AdamW update to the same ĝ and keeps its own residual; without compression
the gradient is all-reduced whole. The metrics are the global batch's: one
scalar all-reduce averages the loss (and ``nll``/``aux``) over the ranks.
Every mesh axis of more than one position must carry data (``make_dist``
with ``dp_only``): placing parameters over the "model" axis is not ported.

Memory at a billion parameters: the gradients are summed straight into one
zero-padded float32 vector in the reference's flatten order (the
compressor's input), the residual is added into it and overwritten in place
by the new residual, and ĝ's leaves are views of the round trip's output.
The state is updated in place, as the reference's donated state is.

``abstract_state`` builds the state's shapes on the meta device, and
``state_shardings`` gives the reference's specs for them; ``lower_cell``
(XLA's ahead-of-time lowering) is not ported.
"""
from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
import torch.distributed as torch_dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.grad_compress import CompressConfig, compress_flat, exchange_mean, padded_len
from repro_torch.launch.mesh import dp_axes_of, tp_axis_of
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import NO_DIST, Dist
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import sharding as shard_mod
from repro_torch.utils.device import PLACEMENT, not_ported, resolve_device
from repro_torch.utils.host import on_device
from repro_torch.utils.prng import fold_in_str
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    opt: opt_mod.OptConfig = opt_mod.OptConfig()
    accum_steps: int = 1
    compress: CompressConfig | None = None
    q_chunk: int = 512
    kv_chunk: int = 1024
    sp: bool = False
    use_ep: bool = True
    donate: bool = True          # False: the step leaves the caller's state as it was
    dp_only: bool = False        # fold the model axis into FSDP/batch (no TP)


def make_dist(mesh, cfg: ModelConfig, sp: bool = False, use_ep: bool = True,
              dp_only: bool = False) -> Dist:
    """The reference's distribution context for ``mesh`` (None: one device)."""
    if mesh is None:
        return NO_DIST
    if dp_only:
        return Dist(mesh=mesh, dp_axes=tuple(mesh.axis_names), tp_axis=None,
                    head_axis=None, kv_head_axis=None, use_ep=False, sp=False)
    dp = dp_axes_of(mesh)
    tp = tp_axis_of(mesh)
    n_tp = mesh.shape.get("model", 1)
    head_ok = bool(cfg.n_heads) and cfg.n_heads >= n_tp
    kv_ok = bool(cfg.n_kv_heads) and cfg.n_kv_heads >= n_tp
    return Dist(mesh=mesh, dp_axes=dp, tp_axis=tp, head_axis=tp if head_ok else None,
                kv_head_axis=tp if kv_ok else None, use_ep=use_ep, sp=sp)


def _seed_of(key) -> int:
    """The 64-bit seed of the port's parameter draw for a threefry key."""
    k = np.asarray(key, dtype=np.uint32)
    return (int(k[0]) << 32) | int(k[1])


def init_state(api: ModelAPI, tcfg: TrainerConfig, key, device="cuda") -> dict:
    """``{"params", "opt"[, "residual"]}`` on ``device``; the error-feedback
    residual is float32, like the parameters."""
    params = api.init_params(_seed_of(key), device)
    state = {"params": params, "opt": opt_mod.init_opt_state(params, tcfg.opt)}
    if tcfg.compress is not None and tcfg.compress.error_feedback:
        state["residual"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                           device=p.device), params)
    return state


def abstract_params(api: ModelAPI) -> dict:
    """The parameter tree's shapes and dtypes, on the meta device."""
    return api.init_params(0, "meta")


def abstract_state(api: ModelAPI, tcfg: TrainerConfig) -> dict:
    """``init_state``'s tree on the meta device: shapes and dtypes, nothing
    allocated."""
    return init_state(api, tcfg, np.zeros(2, np.uint32), device="meta")


def state_shardings(state_specs: dict, mesh, dp_only: bool = False) -> dict:
    """The reference's specs for the state: the parameters' extend leaf-wise
    to the optimizer's moments and the residual; factored second moments
    take the first model-divisible dim over TP and the next data-divisible
    one over the data axes."""
    p_shard = shard_mod.param_shardings(state_specs["params"], mesh, dp_only)
    params = tree_leaves_with_path(state_specs["params"])
    shapes = {name: tuple(v.shape) for name, v in params}

    def spec_at(name):
        node = p_shard
        for key, index in re.findall(r"\['([^']*)'\]|\[(\d+)\]", name):
            node = node[key] if key else node[int(index)]
        return node

    def like_params(tree):
        def go(node, prefix):
            if isinstance(node, dict):
                return {k: go(v, f"{prefix}[{k!r}]") for k, v in node.items()}
            if isinstance(node, list):
                return [go(v, f"{prefix}[{i}]") for i, v in enumerate(node)]
            if prefix in shapes and shapes[prefix] == tuple(node.shape):
                return spec_at(prefix)
            return ()
        return go(tree, "")

    def greedy(leaf):
        fsdp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        n_tp = mesh.shape.get("model", 1)
        n_dp = math.prod(mesh.shape[a] for a in fsdp)
        parts = [None] * len(leaf.shape)
        for i, d in enumerate(leaf.shape):
            if d % n_tp == 0 and d > 1:
                parts[i] = "model"
                break
        for i, d in enumerate(leaf.shape):
            if parts[i] is None and d % n_dp == 0 and d > 1:
                parts[i] = fsdp
                break
        return tuple(parts)

    v = state_specs["opt"]["v"]
    # the reference's test for factored moments looks at the tree's root only
    # (its ``is_leaf`` takes the root dict as a leaf), so a factored tree
    # takes like_params's specs: replicated, as there
    factored = isinstance(v, dict) and "row" in v
    opt_sh = {"v": tree_map(greedy, v) if factored else like_params(v), "step": ()}
    if "m" in state_specs["opt"]:
        opt_sh["m"] = like_params(state_specs["opt"]["m"])
    out = {"params": p_shard, "opt": opt_sh}
    if "residual" in state_specs:
        out["residual"] = like_params(state_specs["residual"])
    return out


def _dp_mesh(dist: Dist):
    """The mesh the step's data is split over (None: one device); refuses an
    axis of more than one position that does not carry data."""
    mesh = dist.mesh if dist is not None else None
    if mesh is None:
        return None
    idle = [a for a in mesh.axis_names if mesh.shape[a] > 1 and a not in dist.dp_axes]
    if idle:
        raise not_ported(f"TP/FSDP placement of parameters over the mesh axes {idle} (train "
                         "with dp_only=True: every axis carries data)", PLACEMENT)
    return mesh


def make_train_fn(api: ModelAPI, tcfg: TrainerConfig, dist: Dist, key, device="cuda"):
    """The (state, batch) → (state, metrics) step on ``device``.

    ``batch`` holds ``tokens`` and ``labels`` (B, S) (numpy arrays or
    tensors), for the vlm family also ``positions`` (3, B, S) and
    ``vision_embeds`` (B, nv, d). With a mesh in ``dist`` it is the global
    batch, the same on every rank, and each rank takes its block; a block
    (or the batch, on one device) must divide into ``accum_steps``
    micro-batches.
    """
    mesh = _dp_mesh(dist)
    device = resolve_device(device)
    gc_key = fold_in_str(key, "grad-compress")
    compress = tcfg.compress
    chunk_p = compress.chunk_p if compress is not None else 1

    def grads_into(params, batch) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """(the summed gradients as one zero-padded float32 vector, the loss,
        the loss function's metrics)."""
        leaves = tree_leaves(params)
        n = sum(leaf.numel() for leaf in leaves)
        flat = torch.zeros((padded_len(n, chunk_p),), dtype=torch.float32, device=device)
        a = tcfg.accum_steps
        total, metrics = torch.zeros((), dtype=torch.float32, device=device), {}
        for i in range(a):
            mb = _micro_batch(batch, i, a)
            for leaf in leaves:
                leaf.requires_grad_(True)
            loss, metrics = api.loss_fn(params, mb, dist, q_chunk=tcfg.q_chunk,
                                        kv_chunk=tcfg.kv_chunk)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                off = 0
                for g in grads:
                    flat[off:off + g.numel()].add_(g.reshape(-1))
                    off += g.numel()
            del grads
            total = total + loss.detach()
        if a > 1:
            flat[:n].div_(a)
            return flat, total / a, {}
        return flat, total, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: dict, batch: dict):
        if not tcfg.donate:
            state = tree_map(lambda t: t.clone(), state)
        params = state["params"]
        if mesh is not None:
            batch = _rank_rows(batch, mesh, tcfg.accum_steps)
        batch = {k: on_device(v, device) for k, v in batch.items()}
        if batch["tokens"].shape[0] % tcfg.accum_steps:
            raise ValueError(f"a batch of {batch['tokens'].shape[0]} does not split into "
                             f"{tcfg.accum_steps} micro-batches")
        flat, loss, metrics = grads_into(params, batch)
        loss, metrics = _mean_over_ranks(loss, metrics, mesh)
        with torch.no_grad():
            leaves = tree_leaves(params)
            # the gradients' dtypes: float32 sums under accumulation, else the params'
            dtypes = [torch.float32 if tcfg.accum_steps > 1 else p.dtype for p in leaves]
            stats = {}
            g_flat = flat
            if compress is not None:
                res = tree_leaves(state.get("residual"))
                off = 0
                for r in res:
                    flat[off:off + r.numel()].add_(r.reshape(-1))
                    off += r.numel()
                g_flat, res_flat, wire = compress_flat(flat, gc_key, int(state["opt"]["step"]),
                                                       compress, mesh=mesh)
                if res_flat is not None:
                    state["residual"] = tree_unflatten(
                        params, _assign(res or [None] * len(leaves), res_flat, leaves, dtypes))
                stats["wire_floats"] = torch.tensor(float(wire), dtype=torch.float32)
                del flat, res_flat
            else:
                g_flat = exchange_mean(flat, mesh, "dense")
            g_leaves, off = [], 0
            for p, dt in zip(leaves, dtypes):
                g_leaves.append(g_flat[off:off + p.numel()].view(p.shape).to(dt))
                off += p.numel()
            del g_flat
            _, state["opt"], opt_stats = opt_mod.adamw_update(
                tree_unflatten(params, g_leaves), params, state["opt"], tcfg.opt)
        return state, {"loss": loss, **stats, **opt_stats, **metrics}

    return train_step


def _micro_batch(batch: dict, i: int, a: int) -> dict:
    """Micro-batch ``i`` of ``a``: the ``i``-th block of rows of each leaf
    (of the vlm family's ``(3, B, S)`` positions, along axis 1)."""
    size = batch["tokens"].shape[0] // a
    rows = slice(i * size, (i + 1) * size)
    return {k: v[:, rows] if k == "positions" else v[rows] for k, v in batch.items()}


def _rank_rows(batch: dict, mesh, a: int) -> dict:
    """This rank's rows of the global batch, micro-batch by micro-batch: its
    block of each of the reference's ``a`` micro-batches, concatenated. So
    the rank's micro-batch ``i`` is its block of the reference's, and a
    statistic averaged over the ranks (the MoE routers') is that
    micro-batch's."""
    if a == 1:
        return shard_mod.local_batch(batch, mesh)
    if batch["tokens"].shape[0] % a:
        raise ValueError(f"a batch of {batch['tokens'].shape[0]} does not split into {a} "
                         "micro-batches")
    parts = [shard_mod.local_batch(_micro_batch(batch, i, a), mesh) for i in range(a)]
    return {k: torch.cat([torch.as_tensor(p[k]) for p in parts], 1 if k == "positions" else 0)
            for k in batch}


def _mean_over_ranks(loss: torch.Tensor, metrics: dict, mesh):
    """The loss and the loss function's scalar metrics averaged over the
    mesh's ranks by one all-reduce (the identity on one process)."""
    if mesh is None or not mesh.collective:
        return loss, metrics
    names = sorted(metrics)
    vals = [loss] + [metrics[k] for k in names]
    buf = torch.stack([v.float() for v in vals])
    torch_dist.all_reduce(buf)
    buf /= torch_dist.get_world_size()
    out = [b.to(v.dtype) for b, v in zip(buf, vals)]
    return out[0], dict(zip(names, out[1:]))


def _assign(dst: list, flat: torch.Tensor, like: list, dtypes: list) -> list:
    """The leaves of ``flat`` (in ``like``'s shapes and ``dtypes``), copied into
    the tensors of ``dst`` where the dtype matches, else new tensors."""
    out, off = [], 0
    for d, p, dt in zip(dst, like, dtypes):
        seg = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
        if d is not None and d.dtype == dt:
            out.append(d.copy_(seg))
        else:
            out.append(seg.to(dt, copy=True))
    return out
