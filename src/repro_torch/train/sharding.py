"""Name-based sharding rules: param path regex → partition spec (the port of
``repro.train.sharding``).

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry a
dimension, each ``None`` (replicated), an axis name, or a tuple of axis
names; ``()`` is fully replicated. Entry for entry, each function here gives
the reference's spec on the same name, shape and mesh geometry (a mesh is
read only through ``mesh.axis_names`` and ``mesh.shape[axis]``).

TP+FSDP by default: the ``model`` axis carries tensor/expert/vocab
parallelism, the data axes carry FSDP. A dim is only sharded when divisible
by the axis size; otherwise the rule falls back to replication on that dim.
The port's data-parallel trainer takes each rank's block of the batch by
:func:`batch_shardings` with ``dp_only=True`` (:func:`local_batch`), and a
placed state (``train/fsdp.py``) holds each rank's block of every leaf these
specs cut over the data axes (FSDP); TP and expert placement over the
"model" axis are ROADMAP.md's next LM item.
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch

from repro_torch.cluster.bootstrap import process_index
from repro_torch.utils.tree import tree_map_with_path_names

# (regex over 'path/to/leaf', spec builder) — first match wins.
# fsdp = data axes tuple, tp = 'model'.
RULES: list[tuple[str, Any]] = [
    (r"embed$", lambda fsdp, tp: (tp, fsdp)),
    (r"lm_head$", lambda fsdp, tp: (fsdp, tp)),
    (r"attn/wq$|attn/wk$|attn/wv$|xattn/wq$|xattn/wk$|xattn/wv$", lambda fsdp, tp: (fsdp, tp)),
    (r"attn/wo$|xattn/wo$", lambda fsdp, tp: (tp, fsdp)),
    (r"mlp/gate$|mlp/up$|shared/gate$|shared/up$", lambda fsdp, tp: (fsdp, tp)),
    (r"mlp/down$|shared/down$", lambda fsdp, tp: (tp, fsdp)),
    (r"moe/router$", lambda fsdp, tp: (fsdp, None)),
    (r"moe/w_gate$|moe/w_up$", lambda fsdp, tp: (tp, fsdp, None)),
    (r"moe/w_down$", lambda fsdp, tp: (tp, None, fsdp)),
    (r"mamba/in_proj$", lambda fsdp, tp: (fsdp, None)),
    (r"mamba/out_proj$", lambda fsdp, tp: (tp, fsdp)),
    (r"mamba/conv_w$|mamba/conv_b$", lambda fsdp, tp: ()),
    (r".*", lambda fsdp, tp: ()),          # norms, scalars, biases → replicated
]


def _size(axes, mesh) -> int:
    return math.prod(mesh.shape[a] for a in (axes if isinstance(axes, tuple) else (axes,)))


def _fits(dim: int | None, axes, mesh) -> bool:
    if dim is None or axes is None:
        return True
    return dim % _size(axes, mesh) == 0


def spec_for(name: str, shape: tuple[int, ...], mesh, scanned: bool,
             dp_only: bool = False) -> tuple:
    """The spec of one param; scanned params get a leading (replicated) layer
    dim prepended. ``dp_only`` folds the model axis into FSDP (no tensor
    parallelism)."""
    if dp_only:
        fsdp = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
        tp = None
    else:
        fsdp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        tp = "model" if "model" in mesh.axis_names else None
    body_shape = shape[1:] if scanned else shape
    for pat, builder in RULES:
        if re.search(pat, name):
            # pad/trim to rank, drop axes that don't divide the dim
            parts = (list(builder(fsdp, tp)) + [None] * len(body_shape))[: len(body_shape)]
            parts = [p if _fits(body_shape[i], p, mesh) else None for i, p in enumerate(parts)]
            return tuple([None] + parts if scanned else parts)
    raise AssertionError("unreachable — catch-all rule")


def param_shardings(param_specs: Any, mesh, dp_only: bool = False) -> Any:
    """Specs for a param tree (of tensors, meta tensors included); params
    under 'layers/' (and the encoder's and decoder's) are stacked."""

    def f(name, leaf):
        scanned = name.startswith(("layers/", "enc_layers/", "dec_layers/"))
        return spec_for(name, tuple(leaf.shape), mesh, scanned, dp_only)

    return tree_map_with_path_names(f, param_specs)


def _data_axes(mesh, dp_only: bool) -> tuple[str, ...]:
    axes = ("pod", "data", "model") if dp_only else ("pod", "data")
    return tuple(a for a in axes if a in mesh.axis_names)


def _batch_spec(name: str, leaf, mesh, dp_only: bool) -> tuple:
    fsdp = _data_axes(mesh, dp_only)
    if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
        return ()
    if name.endswith("positions"):
        return (None, fsdp) + (None,) * (len(leaf.shape) - 2)
    if leaf.shape[0] % _size(fsdp, mesh) == 0:
        return (fsdp,) + (None,) * (len(leaf.shape) - 1)
    return ()


def batch_shardings(batch_specs: Any, mesh, dp_only: bool = False) -> Any:
    """Batch dims sharded over the data axes; everything else replicated.

    positions (3, B, S) put B on axis 1; scalars replicated.
    """
    return tree_map_with_path_names(lambda n, leaf: _batch_spec(n, leaf, mesh, dp_only),
                                    batch_specs)


def local_batch(batch: Any, mesh, dp_only: bool = True) -> Any:
    """This rank's block of each leaf of ``batch`` as :func:`batch_shardings`
    places it: the rows of the positions the rank owns, contiguous and in
    rank order (a replicated leaf whole)."""
    rank = process_index()
    sizes = [mesh.shape[a] for a in mesh.axis_names]
    mine = [pos for pos, r in enumerate(mesh.owners) if r == rank]
    if not mine:
        raise ValueError(f"rank {rank} owns no position of {mesh}")

    def f(name, leaf):
        spec = _batch_spec(name, leaf, mesh, dp_only)
        dim = next((d for d, e in enumerate(spec) if e is not None), None)
        if dim is None:
            return leaf
        axes = spec[dim] if isinstance(spec[dim], tuple) else (spec[dim],)
        blocks = set()
        for pos in mine:
            coords = dict(zip(mesh.axis_names, _unravel(pos, sizes)))
            b = 0
            for a in axes:
                b = b * mesh.shape[a] + coords[a]
            blocks.add(b)
        lo, hi = min(blocks), max(blocks) + 1
        if len(blocks) != hi - lo:
            raise ValueError(f"rank {rank}'s rows of {name} are not one block on {mesh}")
        size = leaf.shape[dim] // _size(axes, mesh)
        return torch.narrow(torch.as_tensor(leaf), dim, lo * size, (hi - lo) * size)

    return tree_map_with_path_names(f, batch)


def _unravel(pos: int, sizes: list[int]) -> list[int]:
    out = []
    for s in reversed(sizes):
        pos, c = divmod(pos, s)
        out.append(c)
    return out[::-1]


def cache_shardings(cache_specs: Any, mesh, seq_axis_to_model: bool = True) -> Any:
    """Decode caches: (L, B, S, kv, hd) → batch over data axes; sequence over
    ``model`` (SP decode). SSM states (L, B, H, N, P): heads over model when
    divisible."""
    fsdp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n_dp = _size(fsdp, mesh)
    n_tp = mesh.shape.get("model", 1)

    def f(name, leaf):
        sh = leaf.shape
        if len(sh) == 5 and name.split("/")[-1] in ("k", "v", "xk", "xv", "pre_k", "pre_v"):
            b_ok = sh[1] % n_dp == 0
            s_ok = seq_axis_to_model and sh[2] % n_tp == 0
            return (None, fsdp if b_ok else None, "model" if s_ok else None, None, None)
        if len(sh) == 5 and name.endswith("ssm"):
            b_ok = sh[1] % n_dp == 0
            h_ok = sh[2] % n_tp == 0
            return (None, fsdp if b_ok else None, "model" if h_ok else None, None, None)
        if len(sh) == 4 and name.endswith("conv"):
            b_ok = sh[1] % n_dp == 0
            c_ok = sh[3] % n_tp == 0
            return (None, fsdp if b_ok else None, None, "model" if c_ok else None)
        if len(sh) >= 1 and sh[0] % n_dp == 0:
            return (fsdp,) + (None,) * (len(sh) - 1)
        return ()

    return tree_map_with_path_names(f, cache_specs)
