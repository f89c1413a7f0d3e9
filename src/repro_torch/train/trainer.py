"""The trainer: state, and the (state, batch) → (state, metrics) step (the
port of ``repro.train.trainer``'s single-device path).

A step takes the gradients by autograd (micro-batch by micro-batch when
``accum_steps > 1``), compresses them with the paper's sketch under the
repo's key discipline (``core.grad_compress``, keyed by
``fold_in_str(key, "grad-compress")`` and the optimizer's step), and applies
AdamW. Its metrics carry the reference's names (``loss``, ``wire_floats``,
``grad_norm``, ``lr``, and ``nll``/``aux`` without accumulation).

Memory at a billion parameters: the gradients are summed straight into one
zero-padded float32 vector in the reference's flatten order (the
compressor's input), the residual is added into it and overwritten in place
by the new residual, and ĝ's leaves are views of the round trip's output.
The state is updated in place, as the reference's donated state is.

``make_dist``, ``state_shardings`` and ``lower_cell`` (meshes and XLA's
ahead-of-time lowering) are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.grad_compress import CompressConfig, compress_flat, padded_len
from repro_torch.models import transformer as tr
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import Dist
from repro_torch.train import optimizer as opt_mod
from repro_torch.utils.device import resolve_device
from repro_torch.utils.host import on_device
from repro_torch.utils.prng import fold_in_str
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    opt: opt_mod.OptConfig = opt_mod.OptConfig()
    accum_steps: int = 1
    compress: CompressConfig | None = None
    q_chunk: int = 512
    kv_chunk: int = 1024


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


def make_train_fn(api: ModelAPI, tcfg: TrainerConfig, dist: Dist, key, device="cuda"):
    """The (state, batch) → (state, metrics) step on ``device``.

    ``batch`` holds ``tokens`` and ``labels`` (B, S) (numpy arrays or
    tensors), for the vlm family also ``positions`` (3, B, S) and
    ``vision_embeds`` (B, nv, d); B must divide into ``accum_steps``
    micro-batches.
    """
    tr.check_supported(api.cfg, dist)
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
        size = batch["tokens"].shape[0] // a
        for i in range(a):
            rows = slice(i * size, (i + 1) * size)
            # the vlm family's positions are (3, B, S): their batch axis is 1
            mb = {k: v[:, rows] if k == "positions" else v[rows] for k, v in batch.items()}
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
        params = state["params"]
        batch = {k: on_device(v, device) for k, v in batch.items()}
        if batch["tokens"].shape[0] % tcfg.accum_steps:
            raise ValueError(f"a batch of {batch['tokens'].shape[0]} does not split into "
                             f"{tcfg.accum_steps} micro-batches")
        flat, loss, metrics = grads_into(params, batch)
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
                                                       compress)
                if res_flat is not None:
                    state["residual"] = tree_unflatten(
                        params, _assign(res or [None] * len(leaves), res_flat, leaves, dtypes))
                stats["wire_floats"] = torch.tensor(float(wire), dtype=torch.float32)
                del flat, res_flat
            g_leaves, off = [], 0
            for p, dt in zip(leaves, dtypes):
                g_leaves.append(g_flat[off:off + p.numel()].view(p.shape).to(dt))
                off += p.numel()
            del g_flat
            _, state["opt"], opt_stats = opt_mod.adamw_update(
                tree_unflatten(params, g_leaves), params, state["opt"], tcfg.opt)
        return state, {"loss": loss, **stats, **opt_stats, **metrics}

    return train_step


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
