"""Collective accounting (the port of ``repro.roofline.hlo``).

The port has no HLO: its collectives are the ``c10d`` ops that
``torch.distributed`` dispatches, which ``roofline.counter.OpCounter`` sees
and :func:`record_collective` turns into records of the reference's kind
names. Shapes there are a rank's own, so the bytes are per device.
:func:`collective_stats` applies the reference's wire-byte model to them.

Wire-byte model per op (ring algorithms, group size g):
    all-reduce:          2·B·(g−1)/g      (reduce-scatter + all-gather phases)
    all-gather:          B_result·(g−1)/g
    reduce-scatter:      B_operand·(g−1)/g
    all-to-all:          B·(g−1)/g
    collective-permute:  B                 (point-to-point)
"""
from __future__ import annotations

from collections import defaultdict

import torch
import torch.distributed as dist

# c10d op → the reference's kind
KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(y) for y in x)
    return 0


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().name() == "ProcessGroup":
            return dist.ProcessGroup.unbox(a).size()
    return dist.get_world_size()


def record_collective(op: str, args) -> dict:
    """The record of one ``c10d`` op (its name without the namespace) and its
    arguments: the kind, the result's and the operand's bytes, the group's
    size. In-place ops (all-reduce) have one buffer for both."""
    if op not in KINDS:
        raise NotImplementedError(f"no wire-byte model for the c10d op {op!r}")
    result = _bytes(args[0])
    operand = _bytes(args[1]) if len(args) > 1 and _bytes(args[1]) else result
    return {"kind": KINDS[op], "result_bytes": result, "operand_bytes": operand,
            "group": _group_size(args)}


def collective_stats(records) -> dict:
    """Per-kind (wire_bytes, count) + total, from :func:`record_collective`'s
    records."""
    out: dict = defaultdict(lambda: {"wire_bytes": 0.0, "count": 0})
    for r in records:
        kind, g = r["kind"], r["group"]
        rb, ob = r["result_bytes"], r["operand_bytes"]
        frac = (g - 1) / g if g > 1 else 0.0
        if kind == "all-reduce":
            wire = 2.0 * rb * frac
        elif kind == "all-gather":
            wire = rb * frac
        elif kind == "reduce-scatter":
            wire = max(ob, rb) * frac
        elif kind == "all-to-all":
            wire = rb * frac
        else:  # collective-permute
            wire = float(rb)
        out[kind]["wire_bytes"] += wire
        out[kind]["count"] += 1
    total = sum(v["wire_bytes"] for v in out.values())
    return {"by_kind": dict(out), "total_wire_bytes": total}
