"""Snapshot/restore of a live :class:`~repro_torch.sketchserve.service.SketchService`.

Rides the :mod:`repro_torch.train.checkpoint` atomic-rename protocol
(``save_arrays`` / ``load_arrays``: manifest.json + arrays.npz + ``latest``
pointer), so a serving snapshot is crash-safe the same way a training
checkpoint is. The manifest, the array names and the JSON are the
reference's (``repro.sketchserve.snapshot``, format ``sketchserve-v1``): a
snapshot either package writes restores in the other. What is written is
exactly what a restarted process cannot re-derive:

- per group: the Plan (as JSON, ``dtype`` as its numpy name, e.g.
  ``"float32"``; an explicit mesh as its geometry, ``{"axis_names",
  "shape"}`` via ``api.plan.mesh_spec``, rebuilt over the restoring run's
  processes), the shared PRNG key, the
  cursor's replay counters (``chunk`` / ``count`` / ``chunk_rows`` /
  ``n_sketches``) and dimensionality ``p``, plus the retained ingest buffer
  when the group keeps one for refine replay;
- per tenant: kind, constructor params, its own Plan when it differs from the
  group's (co-registered tenants may fold differently — only the sketch
  geometry is shared), and the estimator's fold state via
  ``SketchedEstimator.state_arrays`` (the EngineState protocol wire format of
  ``repro_torch.stream.state``);
- per service: the snapshot step counter (so a restored service's next
  ``snapshot()`` continues at step N+1 instead of clobbering the original
  run's earlier checkpoints under the same path) and the evicted-group map
  (groups parked under ``evict_dir`` stay lazily restorable after a restart).

NOT written: the SketchSpec (re-derived deterministically from
(plan, key, p) by ``cursor.ensure_spec``) and every finalized attribute
(recomputed lazily at the next query). Restore therefore resumes
*bit-identically*: the restored cursor continues at the same chunk index, so
the next ingested chunk folds under the same (step, shard) mask key it would
have in the original process, and queries before/after the round-trip agree
exactly (``tests/test_torch_sketchserve.py``).

A reference snapshot whose plan names an ``impl`` the port refuses ("jnp",
"interpret") fails to restore with the Plan's ``ValueError``, which names
the field.

The same format serves tenant eviction: ``save_service(svc, path,
gids=[gid])`` writes one group, and :func:`restore_group` folds a parked
group back into a LIVE service (first-touch lazy restore).

Mid-step states (a sharded reducer holding shard sketches not yet all-reduced, a
K-means fold between apply boundaries) refuse to snapshot with a clear error
— ingest to a step boundary first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.plan import Plan, mesh_from_spec, mesh_spec
from repro_torch.train import checkpoint


def _dtype_name(dtype) -> str:
    """``Plan.dtype`` ("float32", a numpy or a torch dtype) as the numpy name
    the reference writes, e.g. "float32"."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def plan_to_json(plan: Plan) -> dict:
    """Plan → JSON-safe dict, the reference's encoding. Round-trips through
    :func:`plan_from_json` (and the reference's)."""
    d = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
    d["mesh"] = mesh_spec(plan.mesh)
    d["dtype"] = _dtype_name(plan.dtype)
    return d


def plan_from_json(d: dict) -> Plan:
    d = dict(d)
    d["mesh"] = mesh_from_spec(d.get("mesh"))
    return Plan(**d)


def save_service(svc, path: str, step: int = 1,
                 gids: "list[str] | None" = None) -> None:
    """Write one checkpoint step of every live group/tenant under ``path``
    (or just ``gids`` — the eviction path). The registry view is copied under
    the service's locks, so a snapshot can never see a group mid-restore; the
    state arrays themselves are read lock-free, which is safe because the
    caller guarantees no fold is in flight (worker-thread fold boundary, or a
    quiesced pool)."""
    with svc._evict_lock:
        with svc._reg_lock:
            live = dict(svc._groups)
            evicted = {gid: dict(ev) for gid, ev in svc._evicted.items()}
    if gids is None:
        items = live
    else:
        items = {gid: live[gid] for gid in gids}
        evicted = {}
    arrays: dict[str, np.ndarray] = {}
    groups: dict[str, dict] = {}
    for gid, g in items.items():
        gplan = plan_to_json(g.plan)
        ginfo: dict = {
            "plan": gplan,
            "p": None if g.cursor.spec is None else int(g.cursor.spec.p),
            "chunk": int(g.cursor.chunk),
            "count": int(g.cursor.count),
            "n_sketches": int(g.cursor.n_sketches),
            "retain_ingest": g.retain_ingest,
            "tenants": {},
        }
        arrays[f"{gid}/__key__"] = np.asarray(g.key)
        arrays[f"{gid}/__chunk_rows__"] = np.asarray(g.cursor.chunk_rows,
                                                     dtype=np.int64)
        if g.retained:
            arrays[f"{gid}/__retained__"] = np.concatenate(
                [checkpoint.to_host(c) for c in g.retained])
            arrays[f"{gid}/__retained_rows__"] = np.array(
                [c.shape[0] for c in g.retained], np.int64)
        for tid, t in g.tenants.items():
            tplan = plan_to_json(t.est.plan)
            ginfo["tenants"][tid] = {
                "kind": t.kind,
                "params": t.params,
                "plan": None if tplan == gplan else tplan,
            }
            if g.cursor.spec is not None:
                for name, v in t.est.state_arrays().items():
                    arrays[f"{gid}/{tid}/{name}"] = np.asarray(v)
        groups[gid] = ginfo
    extra = {"format": "sketchserve-v1", "groups": groups,
             "snap_step": int(step)}
    if evicted:
        extra["evicted"] = evicted
    checkpoint.save_arrays(path, step, arrays, extra=extra)


def _load_group(svc, gid: str, ginfo: dict, arrays: dict) -> None:
    """Materialize one snapshotted group (and its tenants) into ``svc``."""
    gplan = plan_from_json(ginfo["plan"])
    key = np.asarray(arrays[f"{gid}/__key__"], dtype=np.uint32)
    for tid, tinfo in ginfo["tenants"].items():
        tplan = (plan_from_json(tinfo["plan"]) if tinfo["plan"] is not None
                 else gplan)
        resp = svc._create_tenant(tid, tinfo["kind"], tplan, key, gid,
                                  ginfo["retain_ingest"],
                                  dict(tinfo["params"]))
        if not resp.ok:
            raise RuntimeError(f"restore of tenant {tid!r}: {resp.error}")
    g = svc._groups[gid]
    if f"{gid}/__retained__" in arrays:
        flat = arrays[f"{gid}/__retained__"]
        i = 0
        for n in arrays[f"{gid}/__retained_rows__"].tolist():
            g.retained.append(flat[i:i + n])
            i += n
    if ginfo["p"] is not None:
        cur = g.cursor
        cur.ensure_spec(int(ginfo["p"]))   # spec re-derives; binds reducers
        cur.chunk = int(ginfo["chunk"])
        cur.count = int(ginfo["count"])
        cur.n_sketches = int(ginfo["n_sketches"])
        cur.chunk_rows = arrays[f"{gid}/__chunk_rows__"].tolist()
        for tid, t in g.tenants.items():
            prefix = f"{gid}/{tid}/"
            sub = {k[len(prefix):]: v for k, v in arrays.items()
                   if k.startswith(prefix)}
            t.est.load_state_arrays(sub)


def restore_service(path: str, **service_kwargs):
    """Rebuild a :class:`SketchService` from the latest snapshot under
    ``path`` (either package's). Returned NOT started — call ``start()`` (or
    use ``with``) before submitting; ``service_kwargs`` override
    queue/batch/admission settings and ``device``."""
    from repro_torch.sketchserve.service import SketchService

    arrays, extra = checkpoint.load_arrays(path)
    if extra.get("format") != "sketchserve-v1":
        raise ValueError(f"{path} is not a sketchserve snapshot "
                         f"(format={extra.get('format')!r})")
    svc = SketchService(**service_kwargs)
    for gid, ginfo in extra["groups"].items():
        _load_group(svc, gid, ginfo, arrays)
    # resume the step counter so the next snapshot() lands at N+1 under the
    # same path instead of restarting at 1 and clobbering earlier checkpoints
    svc._snap_step = int(extra.get("snap_step", 0))
    for gid, ev in extra.get("evicted", {}).items():
        svc._evicted[gid] = {"path": ev["path"],
                             "tenants": list(ev["tenants"])}
        for tid in ev["tenants"]:
            svc._evicted_tenants[tid] = gid
    return svc


def restore_group(svc, gid: str, path: str) -> None:
    """Fold one evicted group back into a LIVE service from its eviction
    snapshot (the lazy first-touch restore). The caller
    (``SketchService._ensure_live``) holds ``_evict_lock`` and has already
    removed the eviction record; ``_create_tenant`` re-registers under
    ``_reg_lock``, so concurrent submits see the group only once complete."""
    arrays, extra = checkpoint.load_arrays(path)
    if extra.get("format") != "sketchserve-v1":
        raise ValueError(f"{path} is not a sketchserve snapshot "
                         f"(format={extra.get('format')!r})")
    if gid not in extra["groups"]:
        raise KeyError(f"group {gid!r} not in snapshot at {path}")
    _load_group(svc, gid, extra["groups"][gid], arrays)
