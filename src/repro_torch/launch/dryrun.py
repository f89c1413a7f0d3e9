"""The dry-run: count every (arch × shape × mesh) cell on the meta device
(the port of ``repro.launch.dryrun``).

Per cell it runs the port's own eager step (``trainer.lower_cell``) on the
meta device under ``roofline.counter.OpCounter`` at full width and the
cell's per-device batch, at the two depth probes of
``roofline.analysis.probe_depths``, and extrapolates to full depth (a
full-depth count of a 32k prefill takes minutes of host time on meta; the
probes seconds). It records the memory a device needs (the meta high-water
mark of live storages, and ``memmodel.peak_model``'s components), the cost a
device pays (flops by dtype, bytes), the collectives' wire bytes, and with
``--roofline`` the probes and the three roofline terms over the H100's
peaks (``roofline.hw``).

Meshes: ``1`` and ``4`` are H100 cards with every axis carrying data (four:
the train step runs placed, FSDP, as rank 0 of a fake process group of four,
its gathers, reduce-scatters, all-reduces and all-to-alls counted; the
record's ``memory.state_bytes`` is the state a card holds: its blocks, the
leaves that stay whole and its part of the residual). ``single`` and
``multi`` are the reference's 16×16 and 2×16×16 production meshes: they need
the model axis, so their records say ``status: "not_ported"``, quoting
ROADMAP's "Expert and TP placement of parameters over the model axis".

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh 1|4|single|multi|all] [--roofline] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

MESHES = ("1", "4", "single", "multi")


def arch_trainer_config(arch: str, shape_kind: str):
    """Per-arch memory/optimizer presets, the reference's."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainerConfig

    opt = OptConfig()
    if arch == "kimi-k2-1t-a32b":
        # 1T params: factored second moment, no first moment
        opt = OptConfig(momentum=False, factored=True, moment_dtype="bfloat16")
    elif arch == "qwen3-moe-235b-a22b":
        opt = OptConfig(moment_dtype="bfloat16")
    return TrainerConfig(opt=opt, sp=True)


def make_mesh(kind: str):
    """None (one card), or a mesh over that many ranks (every position a
    rank of its own, collectives over a process group)."""
    from repro_torch.cluster.bootstrap import Mesh

    shape, axes = {"1": (None, None), "4": ((4,), ("data",)),
                   "single": ((16, 16), ("data", "model")),
                   "multi": ((2, 16, 16), ("pod", "data", "model"))}[kind]
    if shape is None:
        return None
    return Mesh(shape, axes, owners=range(math.prod(shape)), collective=True)


def state_bytes(cfg, shape, mesh, tcfg) -> int | None:
    """The trainer's state bytes a card holds at full depth (None for a
    serving cell): the whole state on one card, rank 0's placed share of it
    on a mesh."""
    from repro_torch.core.grad_compress import CompressConfig
    from repro_torch.models.api import get_api
    from repro_torch.train import fsdp
    from repro_torch.train.trainer import abstract_state
    from repro_torch.utils.tree import tree_size_bytes

    if shape.kind != "train":
        return None
    state = abstract_state(get_api(cfg), tcfg)
    if mesh is None or mesh.size < 2:
        return tree_size_bytes(state)
    chunk_p = (tcfg.compress or CompressConfig()).chunk_p
    return fsdp.Layout.of(state, mesh, chunk_p).state_bytes(state)


def run_cell(arch: str, shape_name: str, mesh_kind: str, roofline: bool = False) -> dict:
    from repro_torch.configs.registry import cell_is_runnable, get_arch, get_shape
    from repro_torch.roofline.analysis import (count_params, extrapolate, probe_cell,
                                               probe_depths, roofline_terms)
    from repro_torch.roofline.memmodel import peak_model
    from repro_torch.roofline import hw

    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    ok, why = cell_is_runnable(arch, shape_name)
    if not ok:
        rec["status"] = "skip"
        rec["reason"] = why
        return rec

    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    mesh = make_mesh(mesh_kind)
    tcfg = arch_trainer_config(arch, shape.kind)
    try:
        t0 = time.time()
        probe = probe_cell(cfg, shape, mesh, tcfg)
        count_s = time.time() - t0
    except NotImplementedError as e:   # the model axis: TP placement is not ported
        rec["status"] = "not_ported"
        rec["reason"] = str(e)
        return rec
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug to record
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        return rec

    n_chips = mesh.size if mesh is not None else 1
    per_dev = probe["per_device"]
    d1, d2 = probe_depths(cfg)
    depth = cfg.n_layers - cfg.first_k_dense
    peak = extrapolate(probe["probes"], d1, d2, depth, "peak_bytes")[0]
    counts = [{k: v["count"] for k, v in p["collectives"].items()} for p in probe["probes"]]
    kinds = sorted(set(counts[0]) | set(counts[1]))
    model = peak_model(
        cfg, shape, n_chips, n_chips, 1, count_params(cfg)["total"],
        sp=tcfg.sp, momentum=tcfg.opt.momentum, factored=tcfg.opt.factored,
        moment_bytes=2 if tcfg.opt.moment_dtype == "bfloat16" else 4,
        compress=tcfg.compress)
    rec.update({
        "status": "ok",
        "kind": shape.kind,
        "n_chips": n_chips,
        "count_s": round(count_s, 1),
        "memory": {
            "state_bytes": state_bytes(cfg, shape, mesh, tcfg),
            "peak_bytes": int(peak),
            "fits_80GB": peak < hw.HBM_BYTES,
            "modeled_peak_bytes": model["total"],
            "modeled_components": model["components"],
            "modeled_fits_80GB": model["fits_80GB"],
        },
        "cost": {"flops_per_device": per_dev["flops"],
                 "flops_by_dtype": per_dev["flops_by_dtype"],
                 "bytes_per_device": per_dev["bytes"]},
        "collectives_steady": {
            k: {"wire_bytes": per_dev["wire_by_kind"].get(k, 0.0),
                "count": round(extrapolate(counts, d1, d2, depth, k)[0])} for k in kinds},
    })
    if roofline:
        rec["roofline"] = {**probe,
                           "terms": roofline_terms(per_dev, n_chips, cfg, shape)}
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="all", choices=[*MESHES, "all"])
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import ARCHS, SHAPES

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = os.path.join(args.out, f"{arch}__{shape}__{mesh_kind}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skip", "not_ported"):
                            print(f"cached  {arch} × {shape} × {mesh_kind}")
                            continue
                rec = run_cell(arch, shape, mesh_kind, roofline=args.roofline)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (f" peak={rec['memory']['peak_bytes'] / 1e9:.1f}GB"
                             f" fits={rec['memory']['fits_80GB']}"
                             f" count={rec['count_s']}s")
                if status == "fail":
                    n_fail += 1
                    extra = " " + rec["error"][:160]
                print(f"{status:10s}  {arch} × {shape} × {mesh_kind}{extra}", flush=True)
    print(f"done, failures={n_fail}")
    return n_fail


if __name__ == "__main__":
    raise SystemExit(main())
