"""Per-host liveness heartbeats on the EngineState wire format.

A :class:`Heartbeat` is a tiny accumulator — (hosts, step, rows, newest /
oldest stamp time) — registered as state kind ``"hb"`` in
:mod:`repro_torch.stream.state`. Host stamps serialize through
``to_arrays``/``from_arrays`` (the reference's keys and dtypes, so they ride
``train.checkpoint``), and the cluster-wide view is ``merge`` over stamps —
hosts add, steps max, stamp times max/min.

The flow on each host::

    hb = heartbeat.beat(step, rows)          # stamp local progress
    heartbeat.publish_local(hb)              # per-host gauges (host=<rank>)
    view = heartbeat.gather(hb)              # all-gather + merge (no-op 1-host)
    heartbeat.publish(view)                  # cluster.{hosts,step,rows,...}

``publish`` exposes the merged view as registry gauges, including
``cluster.heartbeat_age_s`` (now − newest stamp: is anyone alive?) and
``cluster.straggler_lag_s`` (newest − oldest stamp: is someone behind?).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.cluster import bootstrap
from repro_torch.stream import state as _state

_FIELDS = ("hosts", "step", "rows", "t_last", "t_first")
_DTYPES = (torch.int32, torch.int64, torch.int64, torch.float64, torch.float64)


@dataclasses.dataclass(frozen=True)
class Heartbeat:
    """One or more merged host stamps: 0-d tensors on the host."""

    hosts: Any    # stamps merged in (1 per host beat)
    step: Any     # max engine step any merged host reached
    rows: Any     # total rows folded across merged hosts
    t_last: Any   # newest stamp time (unix seconds)
    t_first: Any  # oldest stamp time


def _merge_hb(a: Heartbeat, b: Heartbeat) -> Heartbeat:
    return Heartbeat(hosts=a.hosts + b.hosts, step=torch.maximum(a.step, b.step),
                     rows=a.rows + b.rows, t_last=torch.maximum(a.t_last, b.t_last),
                     t_first=torch.minimum(a.t_first, b.t_first))


_state.register_state(_state.StateKind(name="hb", cls=Heartbeat, fields=_FIELDS,
                                       merge=_merge_hb))


def _stamp(*vals) -> Heartbeat:
    return Heartbeat(*(torch.tensor(v, dtype=d) for v, d in zip(vals, _DTYPES)))


def beat(step: int, rows: int = 0, t: float | None = None) -> Heartbeat:
    """Stamp this host's progress as a single-host Heartbeat."""
    t = time.time() if t is None else float(t)
    return _stamp(1, int(step), int(rows), t, t)


def gather(hb: Heartbeat) -> Heartbeat:
    """The cluster-wide merged view: all-gather every process's stamp and
    fold with the hb merge algebra (a collective: every process calls it at
    the same point). Single-process runs return ``hb`` unchanged."""
    if not bootstrap.is_multiprocess():
        return hb
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    # float64 carries every field exactly (the counts stay below 2^53)
    mine = torch.tensor([float(getattr(hb, f)) for f in _FIELDS], dtype=torch.float64,
                        device=dev)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    per_host = [_stamp(*(int(v) if d != torch.float64 else float(v)
                         for v, d in zip(row.cpu().tolist(), _DTYPES))) for row in out]
    return functools.reduce(_state.merge, per_host)


def publish(hb: Heartbeat, registry: obs.MetricsRegistry | None = None,
            now: float | None = None) -> dict[str, float]:
    """Expose a (merged) Heartbeat as ``cluster.*`` gauges; returns the
    values set."""
    reg = registry if registry is not None else obs.default_registry()
    now = time.time() if now is None else float(now)
    vals = {
        "cluster.hosts": float(int(hb.hosts)),
        "cluster.step": float(int(hb.step)),
        "cluster.rows": float(int(hb.rows)),
        "cluster.heartbeat_age_s": max(0.0, now - float(hb.t_last)),
        "cluster.straggler_lag_s": max(0.0, float(hb.t_last) - float(hb.t_first)),
    }
    for name, v in vals.items():
        reg.gauge(name).set(v)
    return vals


def publish_local(hb: Heartbeat, host: int | str | None = None,
                  registry: obs.MetricsRegistry | None = None) -> None:
    """Per-host gauges (``cluster.host_step{host=<rank>}`` etc.) from this
    host's own stamp — the labeled series a scraper graphs per worker."""
    reg = registry if registry is not None else obs.default_registry()
    h = str(bootstrap.process_index() if host is None else host)
    reg.gauge("cluster.host_step", host=h).set(int(hb.step))
    reg.gauge("cluster.host_rows", host=h).set(int(hb.rows))
    reg.gauge("cluster.host_beat_t", host=h).set(float(hb.t_last))
