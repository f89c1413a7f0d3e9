"""Flat-array form of the engine's state, in the reference's layout.

``to_arrays`` / ``from_arrays`` write and read ``{"<prefix><kind>.<field>":
np.ndarray}`` dicts — the wire format of ``repro.stream.state`` — for the
``moment``, ``km`` and ``range`` kinds; ``engine_to_arrays`` /
``engine_from_arrays`` do the same for a whole
:class:`~repro_torch.stream.engine.EngineState` under its ``moments/``,
``kmeans/`` and ``lowrank/`` slots. A state written by either
package is read by the other, so a run can move between them mid-stream.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import lowrank as lowrank_mod
from repro_torch.stream import accumulators as acc

# kind name → (class, fields in order, optional fields)
KINDS = {
    "moment": (acc.MomentState, ("sum_w", "sum_wwt", "count"), ("sum_wwt",)),
    "km": (acc.KMeansState, ("centers", "counts", "obj", "count"), ()),
    "range": (lowrank_mod.RangeState, ("y", "diag", "sum_w", "count"), ()),
}
_CLS_TO_KIND = {cls: name for name, (cls, _, _) in KINDS.items()}
_ENGINE_SLOTS = ("moments", "kmeans", "lowrank")


def to_arrays(state, prefix: str = "") -> dict[str, np.ndarray]:
    """State → flat ``{prefix<kind>.<field>: np.ndarray}``; None fields are skipped."""
    name = _CLS_TO_KIND.get(type(state))
    if name is None:
        raise TypeError(f"{type(state).__name__} has no array form here "
                        f"(have: {sorted(KINDS)})")
    _, fields, optional = KINDS[name]
    out: dict[str, np.ndarray] = {}
    for f in fields:
        v = getattr(state, f)
        if v is None:
            if f not in optional:
                raise ValueError(f"{name}.{f} is None but not optional")
            continue
        out[f"{prefix}{name}.{f}"] = v.detach().cpu().numpy()
    return out


def from_arrays(arrs: dict, prefix: str = "", device="cpu"):
    """The :func:`to_arrays` inverse, kind detected from the key prefix; None
    when ``arrs`` holds no state under ``prefix``."""
    for name, (cls, fields, optional) in KINDS.items():
        head = f"{prefix}{name}."
        if any(key.startswith(head) for key in arrs):
            vals = []
            for f in fields:
                v = arrs.get(f"{head}{f}")
                if v is None and f not in optional:
                    raise KeyError(f"state arrays missing {head}{f}")
                vals.append(None if v is None else
                            torch.as_tensor(np.array(v), device=device))
            return cls(*vals)
    return None


def engine_to_arrays(state) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for slot in _ENGINE_SLOTS:
        sub = getattr(state, slot)
        if sub is not None:
            out.update(to_arrays(sub, prefix=f"{slot}/"))
    return out


def engine_from_arrays(arrs: dict, device="cuda"):
    """Build the port's EngineState from a reference-layout dict on ``device``."""
    from repro_torch.stream.engine import EngineState
    from repro_torch.utils.device import not_ported, resolve_device

    device = resolve_device(device)
    unsupported = sorted({k.split("/")[0] for k in arrs} - set(_ENGINE_SLOTS))
    if unsupported:
        raise not_ported(f"engine state slots {unsupported}",
                         "Engine replay, scan and checkpoints")
    return EngineState(**{slot: from_arrays(arrs, prefix=f"{slot}/", device=device)
                          for slot in _ENGINE_SLOTS})

