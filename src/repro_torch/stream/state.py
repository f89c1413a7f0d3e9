"""The engine state's lifecycle protocol, in the reference's layout:
``to_arrays / from_arrays / merge`` for every accumulator kind, and the same
for a whole :class:`~repro_torch.stream.engine.EngineState`.

- ``to_arrays(state)`` → flat ``{"<prefix><kind>.<field>": np.ndarray}`` — the
  checkpoint wire format of ``repro_torch.train.checkpoint.save_arrays``;
- ``from_arrays(arrs)`` → the state back on a device, kind detected from the
  key prefix;
- ``merge(a, b)`` → the state as if a's and b's folds had been one stream:
  moment and range states add element-wise; K-means merges per-coordinate
  running means by their counts; FD appends both sketches and SVD-shrinks
  back to l.

The kinds are ``moment``, ``km``, ``range`` and ``fd``. An EngineState
serializes each occupied slot under ``moments/``, ``kmeans/`` and
``lowrank/``, plus ``reassign/total`` and ``reassign/last`` when K-means
tracks reassignments; :func:`save_engine` / :func:`load_engine` put it on disk
through ``train.checkpoint``. A state written by either package is read by
the other, so a run can move between them mid-stream.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import lowrank as lowrank_mod
from repro_torch.lowrank import fd as _fd
from repro_torch.stream import accumulators as acc
from repro_torch.train import checkpoint

# ------------------------------------------------------------ merge algebra --


def _merge_linear(a, b):
    """Element-wise add — the merge of any linear (delta-sum) accumulator.
    None-aware for optional fields (MomentState.sum_wwt of a mean-only fold)."""
    vals = []
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if va is None or vb is None:
            if (va is None) != (vb is None):
                raise ValueError(f"cannot merge: field {f.name!r} is None on "
                                 "one state only (track_cov mismatch?)")
            vals.append(None)
        else:
            vals.append(va + vb)
    return type(a)(*vals)


def _merge_kmeans(a: acc.KMeansState, b: acc.KMeansState) -> acc.KMeansState:
    """Count-weighted per-coordinate mean merge: each center coordinate is
    Σ values / Σ counts over both halves; coordinates neither half touched keep
    a's value; obj and count add."""
    ca, cb = a.counts.to(torch.float32), b.counts.to(torch.float32)
    tot = ca + cb
    centers = torch.where(tot > 0, (a.centers * ca + b.centers * cb) / torch.clamp(tot, min=1.0),
                          a.centers)
    return acc.KMeansState(centers, a.counts + b.counts, a.obj + b.obj, a.count + b.count)


def _merge_fd(a: lowrank_mod.FDState, b: lowrank_mod.FDState) -> lowrank_mod.FDState:
    """Append both sketches and SVD-shrink back to l (FD's associative merge)."""
    ell = a.sketch.shape[0]
    if b.sketch.shape[0] != ell:
        raise ValueError(f"cannot merge FD states of widths {ell} and {b.sketch.shape[0]}")
    stacked = torch.cat([a.sketch, b.sketch], dim=0)
    return lowrank_mod.FDState(_fd._shrink(stacked, ell), a.diag + b.diag,
                               a.sum_w + b.sum_w, a.count + b.count)


@dataclasses.dataclass(frozen=True)
class StateKind:
    """One accumulator kind: its class, its fields in wire order (``optional``
    ones may be None), and its merge."""

    name: str
    cls: type
    fields: tuple[str, ...]
    merge: Callable[[Any, Any], Any]
    optional: tuple[str, ...] = ()


STATE_KINDS: dict[str, StateKind] = {k.name: k for k in (
    StateKind("moment", acc.MomentState, ("sum_w", "sum_wwt", "count"), _merge_linear,
              optional=("sum_wwt",)),
    StateKind("km", acc.KMeansState, ("centers", "counts", "obj", "count"), _merge_kmeans),
    StateKind("range", lowrank_mod.RangeState, ("y", "diag", "sum_w", "count"), _merge_linear),
    StateKind("fd", lowrank_mod.FDState, ("sketch", "diag", "sum_w", "count"), _merge_fd),
)}
_CLS_TO_KIND = {k.cls: k for k in STATE_KINDS.values()}
_ENGINE_SLOTS = ("moments", "kmeans", "lowrank")


def kind_of(state) -> StateKind:
    k = _CLS_TO_KIND.get(type(state))
    if k is None:
        raise TypeError(f"{type(state).__name__} is not a registered "
                        f"EngineState kind (have: {sorted(STATE_KINDS)})")
    return k


def merge(a, b):
    """Combine two same-kind states folded from disjoint sub-streams."""
    ka, kb = kind_of(a), kind_of(b)
    if ka.name != kb.name:
        raise TypeError(f"cannot merge {ka.name!r} with {kb.name!r}")
    return ka.merge(a, b)


def state_nbytes(tree) -> int:
    """Bytes of every array in ``tree`` — dataclasses (a state, SparseRows),
    tuples, lists and dicts of tensors or numpy arrays; other leaves count 0.
    The reference's sum of ``leaf.nbytes`` over ``jax.tree_util.tree_leaves``
    for the same state."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(state_nbytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, (list, tuple)):
        return sum(state_nbytes(v) for v in tree)
    if isinstance(tree, dict):
        return sum(state_nbytes(v) for v in tree.values())
    return 0


# ------------------------------------------------------------ serialization --


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def to_arrays(state, prefix: str = "") -> dict[str, np.ndarray]:
    """State → flat ``{prefix<kind>.<field>: np.ndarray}``; None fields are skipped."""
    k = kind_of(state)
    out: dict[str, np.ndarray] = {}
    for f in k.fields:
        v = getattr(state, f)
        if v is None:
            if f not in k.optional:
                raise ValueError(f"{k.name}.{f} is None but not optional")
            continue
        out[f"{prefix}{k.name}.{f}"] = _host(v)
    return out


def from_arrays(arrs: dict, prefix: str = "", device="cpu", kinds: tuple[str, ...] | None = None):
    """The :func:`to_arrays` inverse, kind detected from the key prefix, on
    ``device``; None when ``arrs`` holds no state under ``prefix``. ``kinds``
    restricts the detection (a dict holding a moment and a km state names the
    slot it loads)."""
    for k in STATE_KINDS.values():
        if kinds is not None and k.name not in kinds:
            continue
        head = f"{prefix}{k.name}."
        if any(key.startswith(head) for key in arrs):
            vals = []
            for f in k.fields:
                v = arrs.get(f"{head}{f}")
                if v is None and f not in k.optional:
                    raise KeyError(f"state arrays missing {head}{f}")
                vals.append(None if v is None else
                            torch.as_tensor(np.array(v), device=device))
            return k.cls(*vals)
    return None


# ----------------------------------------------- the engine-state composite --


def engine_to_arrays(state) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for slot in _ENGINE_SLOTS:
        sub = getattr(state, slot)
        if sub is not None:
            out.update(to_arrays(sub, prefix=f"{slot}/"))
    if state.reassign is not None:
        out["reassign/total"] = _host(state.reassign[0])
        out["reassign/last"] = _host(state.reassign[1])
    return out


def engine_from_arrays(arrs: dict, device="cuda"):
    """The port's EngineState from a reference-layout dict, on ``device``."""
    from repro_torch.stream.engine import EngineState
    from repro_torch.utils.device import resolve_device

    device = resolve_device(device)
    slots = {slot: from_arrays(arrs, prefix=f"{slot}/", device=device) for slot in _ENGINE_SLOTS}
    reassign = None
    if "reassign/total" in arrs:
        reassign = tuple(torch.as_tensor(np.array(arrs[f"reassign/{f}"]), device=device)
                         for f in ("total", "last"))
    return EngineState(**slots, reassign=reassign)


def engine_merge(a, b):
    """Merge two EngineStates folded from disjoint (step, shard) cells of one
    grid. The reassignment counters add (last: both halves saw the same last
    step's disjoint rows)."""
    from repro_torch.stream.engine import EngineState

    merged = {}
    for slot in _ENGINE_SLOTS:
        sa, sb = getattr(a, slot), getattr(b, slot)
        if (sa is None) != (sb is None):
            raise ValueError(f"cannot merge EngineStates: slot {slot!r} occupied on one side only")
        merged[slot] = None if sa is None else merge(sa, sb)
    ra, rb = a.reassign, b.reassign
    if (ra is None) != (rb is None):
        raise ValueError("cannot merge EngineStates: reassign tracked on one side only")
    reassign = None if ra is None else (ra[0] + rb[0], ra[1] + rb[1])
    return EngineState(**merged, reassign=reassign)


# ------------------------------------------------------------- persistence --


def save_engine(ckpt_dir: str, step: int, state, extra: dict | None = None,
                keep_last: int = 3) -> None:
    """Checkpoint an EngineState (and JSON ``extra``) through the
    ``train.checkpoint`` protocol. ``step`` is the number of steps already
    folded — the step a restored run resumes at."""
    meta = dict(extra or {})
    meta["next_step"] = int(step)
    checkpoint.save_arrays(ckpt_dir, step, engine_to_arrays(state), extra=meta,
                           keep_last=keep_last)


def load_engine(ckpt_dir: str, device="cuda"):
    """(state on ``device``, next_step, extra) from the latest checkpoint."""
    arrs, extra = checkpoint.load_arrays(ckpt_dir)
    return engine_from_arrays(arrs, device=device), int(extra.get("next_step", 0)), extra
