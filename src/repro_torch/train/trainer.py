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
ranks): each rank runs the accumulation loop on its contiguous block of each
micro-batch of the global batch (``sharding.local_batch``, the reference's
``batch_shardings(..., dp_only=True)``). The moe family's load-balance
statistics are averaged over the ranks (``moe.moe_apply_local``), so its aux
loss is the global micro-batch's; its capacity is the rank's block's. The
metrics are the global batch's: one scalar all-reduce averages the loss (and
``nll``/``aux``) over the ranks. Every mesh axis of more than one position
must carry data (``make_dist`` with ``dp_only``): tensor and expert
placement over the "model" axis is not ported. Where the state lies follows
the way the caller built it, as the reference's shardings do:

- a state ``init_state`` builds is whole on every rank (replicated): the
  compressed gradient crosses ranks as the shared-mask exchange (one
  all-reduce of the kept values, ``grad_compress.compress_flat``), so every
  rank applies the same AdamW update to the same ĝ and keeps its own
  residual; without compression the gradient is all-reduced whole;
- a state ``place_state`` (or ``checkpoint.restore`` into a placed state)
  builds is placed by FSDP (``train/fsdp.py``): each rank holds its block of
  the parameters and moments and its range of chunks of the one residual;
  the forward gathers a layer at a time, the backward reduce-scatters into
  float32 blocks, and the compressor round-trips each rank's own chunks of
  the mean gradient. Both give the reference's single-device step on the
  global batch.

Memory at a billion parameters: the gradients are summed straight into one
zero-padded float32 vector in the reference's flatten order (the
compressor's input; placed, a rank's blocks, then its range), the residual
is added into it and overwritten in place by the new residual, and ĝ's
leaves are views of the round trip's output. The state is updated in place,
as the reference's donated state is.

``abstract_state`` builds the state's shapes on the meta device, and
``state_shardings`` gives the reference's specs for them. ``lower_cell``
(the reference's ahead-of-time lowering) gives a cell's step and its inputs
on the meta device, for ``roofline.counter.OpCounter`` to count: the dry-run
runs the same eager step that runs on the card, on a mesh of more than one
rank with the state placed.

The step reads the optimizer's step count from the host: from its
``step=`` argument, else from the count it keeps of the state it last
returned, and only for another state (the first step, a restored one) from
the state's ``opt.step`` tensor, which waits for the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import weakref

import numpy as np
import torch
import torch.distributed as torch_dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.grad_compress import (CompressConfig, compress_flat, compress_range,
                                            count_exchange, exchange_mean, padded_len)
from repro_torch.launch.mesh import dp_axes_of, tp_axis_of
from repro_torch.models.api import ModelAPI, get_api, input_specs
from repro_torch.models.common import Block, gather
from repro_torch.models.transformer import NO_DIST, Dist
from repro_torch.train import fsdp
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


def place_state(state: dict, dist: Dist, chunk_p: int = CompressConfig.chunk_p,
                device=None) -> fsdp.PlacedState:
    """This rank's FSDP-placed state (``train/fsdp.py``) of the whole
    ``state``, the same on every rank of ``dist``'s mesh (every axis of which
    carries data): its block of each parameter and moment leaf, the leaves
    the reference's specs replicate whole, and its range of ``chunk_p``
    chunks of the residual (the compressor's ``chunk_p``). The step given a
    placed state runs placed; the caller drops ``state``."""
    mesh = _dp_mesh(dist)
    return fsdp.place_state(state, mesh, chunk_p, device)


def init_placed_state(api: ModelAPI, tcfg: TrainerConfig, key, dist: Dist,
                      device="cuda") -> fsdp.PlacedState:
    """``place_state(init_state(api, tcfg, key, device), dist)`` without the
    whole moments and residual: only the parameters are drawn whole, then
    each rank's blocks are kept and the rest made zero at the rank's blocks
    (a model whose whole state exceeds a card trains placed)."""
    device = resolve_device(device)
    state = abstract_state(api, tcfg)
    state["params"] = api.init_params(_seed_of(key), device)
    return place_state(state, dist, (tcfg.compress or CompressConfig()).chunk_p, device)


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
        raise not_ported(f"TP placement of parameters over the mesh axes {idle} (train with "
                         "dp_only=True: every axis carries data, FSDP)", PLACEMENT)
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
    # the opt.step tensor the step last returned, and its value on the host
    last = {"tensor": lambda: None, "step": 0}

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

    def host_step(state: dict, step: int | None) -> int:
        if step is None:
            t = state["opt"]["step"]
            step = last["step"] if t is last["tensor"]() else int(t)
        return step

    def replicated(state: dict, batch: dict, step: int, dtypes: list):
        """(ĝ's leaves, loss, metrics, stats) of a state whole on every rank."""
        params = state["params"]
        flat, loss, metrics = grads_into(params, batch)
        loss, metrics = _mean_over_ranks(loss, metrics, mesh)
        with torch.no_grad():
            leaves = tree_leaves(params)
            stats = {}
            g_flat = flat
            if compress is not None:
                res = tree_leaves(state.get("residual"))
                off = 0
                for r in res:
                    flat[off:off + r.numel()].add_(r.reshape(-1))
                    off += r.numel()
                g_flat, res_flat, wire = compress_flat(flat, gc_key, step, compress, mesh=mesh)
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
        return g_leaves, loss, metrics, stats

    def placed_grads(state: fsdp.PlacedState, batch: dict):
        """(per parameter leaf its gradient's block, float32 — whole for a
        leaf the ranks hold whole —, the loss, the loss function's metrics):
        each micro-batch's gathers and reduce-scatters (``run_blocks``) add
        into the blocks, the whole leaves' local sums are all-reduced once."""
        layout = state.layout
        params = state["params"]
        named = tree_leaves_with_path(params)
        places = [layout.param(i) for i in range(len(named))]
        acc = [torch.zeros(leaf.shape, dtype=torch.float32, device=device) for _, leaf in named]
        whole = [i for i, pl in enumerate(places) if pl.dim is None]
        a = tcfg.accum_steps
        total, metrics = torch.zeros((), dtype=torch.float32, device=device), {}
        for k in range(a):
            mb = _micro_batch(batch, k, a)
            anchor = torch.zeros((), dtype=torch.float32, device=device, requires_grad=True)
            tree = []
            for (name, leaf), pl, g in zip(named, places, acc):
                if pl.dim is None:
                    tree.append(leaf.requires_grad_(True))
                    continue
                b = Block(leaf.detach(), pl.dim, g, anchor)
                # a layer stack's blocks are gathered layer by layer in
                # run_blocks; the other leaves here, where the loss starts
                tree.append(b if name.startswith(_STACKS) else gather(b))
            loss, metrics = api.loss_fn(tree_unflatten(params, tree), mb, dist,
                                        q_chunk=tcfg.q_chunk, kv_chunk=tcfg.kv_chunk)
            grads = torch.autograd.grad(loss, [named[i][1] for i in whole] + [anchor],
                                        allow_unused=True)
            with torch.no_grad():
                for i, g in zip(whole, grads):
                    if g is not None:
                        acc[i].add_(g)
            del tree, grads
            total = total + loss.detach()
        with torch.no_grad():
            if whole:
                buf = torch.cat([acc[i].reshape(-1) for i in whole])
                torch_dist.all_reduce(buf)
                count_exchange("fsdp-all-reduce", fsdp.ring_bytes(buf, layout.world))
                buf.div_(layout.world)
                off = 0
                for i in whole:
                    acc[i].copy_(buf[off:off + acc[i].numel()].view(acc[i].shape))
                    off += acc[i].numel()
                del buf
            if a > 1:
                for g in acc:
                    g.div_(a)
        if a > 1:
            return acc, total / a, {}
        return acc, total, {k: v.detach() for k, v in metrics.items()}

    def placed(state: fsdp.PlacedState, batch: dict, step: int, dtypes: list):
        """(ĝ's leaves, loss, metrics, stats) of a placed state: the ranks'
        mean gradient in blocks, moved into the chunk ranges and compressed
        there against the rank's part of the residual, ĝ moved back."""
        layout = state.layout
        if layout.mesh != mesh:
            raise ValueError(f"a state placed on {layout.mesh} given to a step on {mesh}")
        params = state["params"]
        grads, loss, metrics = placed_grads(state, batch)
        loss, metrics = _mean_over_ranks(loss, metrics, mesh)
        stats = {}
        with torch.no_grad():
            if compress is not None:
                if layout.chunk_p != compress.chunk_p:
                    raise ValueError(f"the state's residual is placed in chunks of "
                                     f"{layout.chunk_p}, the compressor's are {compress.chunk_p}")
                rng = fsdp.to_chunks(grads, layout)
                del grads
                me = layout.rank
                A = layout.flat_range(me)[0]
                res = tree_leaves(state.get("residual"))
                spans = []                 # each leaf's part of the residual in rng
                for i in range(len(layout.params)):
                    a, b = layout.part(i, me)
                    spans.append((layout.offsets[i] - A + a, layout.offsets[i] - A + b))
                for r, (lo, hi) in zip(res, spans):
                    rng[lo:hi].add_(r)
                c0 = layout.chunk_ranges[me][0]
                g_hat, res_rng, wire = compress_range(rng, gc_key, step, compress, c0,
                                                      layout.n_chunks)
                if res_rng is not None:          # in the gradients' dtypes, as _assign's
                    new = []
                    for r, (lo, hi), dt in zip(res or [None] * len(spans), spans, dtypes):
                        seg = res_rng[lo:hi]
                        new.append(r.copy_(seg) if r is not None and r.dtype == dt
                                   else seg.to(dt, copy=True))
                    state["residual"] = tree_unflatten(params, new)
                del rng, res_rng
                grads = fsdp.from_chunks(g_hat, layout)
                del g_hat
                stats["wire_floats"] = torch.tensor(float(wire), dtype=torch.float32)
            g_leaves = [g.to(dt) for g, dt in zip(grads, dtypes)]
        return g_leaves, loss, metrics, stats

    def train_step(state: dict, batch: dict, step: int | None = None):
        """One step; ``step`` is the optimizer's step count (the state's
        ``opt.step``) where the caller knows it on the host. A
        :class:`~repro_torch.train.fsdp.PlacedState` steps placed."""
        step = host_step(state, step)
        is_placed = isinstance(state, fsdp.PlacedState)
        if not tcfg.donate:
            cloned = tree_map(lambda t: t.clone(), dict(state))
            state = fsdp.PlacedState(cloned, state.layout) if is_placed else cloned
        params = state["params"]
        if mesh is not None:
            batch = _rank_rows(batch, mesh, tcfg.accum_steps)
        batch = {k: on_device(v, device) for k, v in batch.items()}
        if batch["tokens"].shape[0] % tcfg.accum_steps:
            raise ValueError(f"a batch of {batch['tokens'].shape[0]} does not split into "
                             f"{tcfg.accum_steps} micro-batches")
        # the gradients' dtypes: float32 sums under accumulation, else the params'
        dtypes = [torch.float32 if tcfg.accum_steps > 1 else p.dtype for p in tree_leaves(params)]
        if is_placed:
            g_leaves, loss, metrics, stats = placed(state, batch, step, dtypes)
        else:
            g_leaves, loss, metrics, stats = replicated(state, batch, step, dtypes)
        with torch.no_grad():
            _, state["opt"], opt_stats = opt_mod.adamw_update(
                tree_unflatten(params, g_leaves), params, state["opt"], tcfg.opt,
                layout=state.layout if is_placed else None)
        last["tensor"], last["step"] = weakref.ref(state["opt"]["step"]), step + 1
        return state, {"loss": loss, **stats, **opt_stats, **metrics}

    return train_step


# the parameters stacked a layer a row, whose blocks run_blocks gathers
_STACKS = ("['layers']", "['enc_layers']", "['dec_layers']")


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


# ------------------------------------------------------- the dry-run's cell ---

@contextlib.contextmanager
def _fake_group(mesh):
    """A process group for ``mesh``'s ranks where none is live: this process
    as rank 0 of ``torch.distributed``'s "fake" backend, whose collectives
    move nothing (what a rank sends and receives is counted from their
    shapes). Destroyed on the way out."""
    if mesh is None or not mesh.collective or torch_dist.is_initialized():
        yield
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("counting a data-parallel cell needs torch.distributed's fake "
                           "backend (torch.testing._internal.distributed.fake_pg), which "
                           "this torch lacks") from e
    torch_dist.init_process_group("fake", store=FakeStore(), rank=0,
                                  world_size=max(mesh.owners) + 1)
    try:
        yield
    finally:
        torch_dist.destroy_process_group()


def lower_cell(cfg: ModelConfig, shape, mesh, tcfg: TrainerConfig | None = None, key=None,
               device="meta"):
    """The step of one (arch × shape × mesh) cell and its inputs on the meta
    device: ``(step, args, meta)``, for ``step(*args)`` to run under
    ``roofline.counter.OpCounter``. With another ``device`` the same step
    and inputs there (:func:`materialize`), to hold its count against the
    meta device's.

    train  → train_step(state, batch)          (the global batch; a rank takes its block)
    prefill→ prefill_fn(params, batch)         (a rank's rows)
    decode → decode_fn(params, token, cache, cur_len)
    ``meta``: ``{"kind", "n_chips", "batch"}`` (the rows a rank holds).

    ``mesh`` None is one device. A mesh of more than one position whose
    every axis of more than one position carries data (``tcfg.dp_only``, or
    no "model" axis) places the state (``place_state``: rank 0's blocks)
    and splits the batch; where no process group is live the train step
    runs as rank 0 of a fake group of the mesh's ranks, so its collectives
    are counted. A mesh that asks for the model axis raises
    ``not_ported(..., PLACEMENT)``.
    """
    tcfg = tcfg or TrainerConfig()
    key = key if key is not None else np.zeros(2, np.uint32)
    device = resolve_device(device)
    api = get_api(cfg)
    dist = make_dist(mesh, cfg, sp=tcfg.sp, use_ep=tcfg.use_ep, dp_only=tcfg.dp_only)
    mesh = _dp_mesh(dist)
    n_data = mesh.size if mesh is not None else 1
    # a batch the ranks cannot split evenly is held whole by each (replicated)
    rows = shape.global_batch // n_data if shape.global_batch % n_data == 0 else shape.global_batch
    info = {"kind": shape.kind, "n_chips": n_data, "batch": rows}

    if shape.kind == "train":
        fn = make_train_fn(api, tcfg, dist, key, device=device)

        def train_step(state, batch):
            with _fake_group(mesh):
                return fn(state, batch, step=0)

        specs = materialize(input_specs(cfg, shape), cfg, device)
        state = init_state(api, tcfg, key, device=device)
        if mesh is not None and mesh.size > 1:
            chunk_p = (tcfg.compress or CompressConfig()).chunk_p
            state = fsdp.place_state(state, mesh, chunk_p)
        return train_step, (state, specs["batch"]), info

    params = api.init_params(_seed_of(key), device)
    specs = materialize(input_specs(cfg, shape, batch=rows), cfg, device)
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return api.prefill_fn(params, batch, NO_DIST, device=device, q_chunk=tcfg.q_chunk,
                                  kv_chunk=tcfg.kv_chunk)

        return prefill_step, (params, specs["batch"]), info

    def serve_step(params, token, cache, cur_len):
        return api.decode_fn(params, token, cache, cur_len, NO_DIST, device=device)

    return serve_step, (params, specs["token"], specs["cache"], specs["cur_len"]), info


def materialize(specs: dict, cfg: ModelConfig, device) -> dict:
    """``models.api.input_specs``'s meta tensors as tensors on ``device`` (the
    same tree on meta): token ids drawn below the vocabulary, the vlm
    family's positions a plain 0 … S−1 ramp, the frames and vision
    embeddings N(0, 1) in their dtype, a cache or state zero; drawn on the
    host from a generator seeded with 0."""
    if device.type == "meta":
        return specs
    gen = torch.Generator().manual_seed(0)

    def make(name, t):
        if name in ("tokens", "labels", "token"):
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                 dtype=t.dtype).to(device)
        if name == "positions":
            return torch.arange(t.shape[-1], dtype=t.dtype).expand(t.shape).contiguous().to(device)
        if t.is_floating_point() and name in ("frames", "vision_embeds"):
            return torch.randn(t.shape, generator=gen).to(t.dtype).to(device)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return make(name, node) if torch.is_tensor(node) else node

    return walk(specs)
