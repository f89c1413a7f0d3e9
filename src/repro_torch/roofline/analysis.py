"""The three-term roofline of a cell, counted on the meta device (the port of
``repro.roofline.analysis``).

Method:
1. ``lower_cell`` gives a cell's eager step and its inputs on the meta
   device; ``counter.OpCounter`` counts what the step dispatches: flops by
   dtype, bytes, kernel calls by their models, collectives, the peak of live
   storages. The reference counted a compiled program whose layer loop XLA
   costs once, so it probes two unrolled depths; the port counts every layer
   as it runs, and keeps the reference's two probes at full width (and the
   cell's per-device batch) and their affine extrapolation in the layer
   count, with its clamps:
       f(L) = f(d₁) + slope·(L − d₁),  slope = max((f(d₂)−f(d₁))/(d₂−d₁), 0).
2. The shapes a rank sees are its own, so the counts are per device.
       compute    = Σ_dtype flops ÷ the dtype's peak (bf16 989 TF/s on the
                    tensor cores, float32 67 TF/s on the CUDA cores)
       memory     = bytes ÷ 3.35 TB/s
       collective = wire bytes ÷ 450 GB/s of NVLink each way
3. MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (prefill/decode), with
   N_active counting routed experts at top-k/E weight; MODEL_FLOPS over the
   counted flops exposes recomputation, causal and chunking waste.

Decode reads every weight and its cache once a step, whatever its flops:
:func:`decode_bytes` is that byte bound (for the moe family, of the experts
the step routes to).
"""
from __future__ import annotations

import dataclasses
import functools
import time

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.api import get_api
from repro_torch.roofline import hw
from repro_torch.roofline.counter import OpCounter
from repro_torch.roofline.hlo import collective_stats
from repro_torch.utils.tree import tree_leaves_with_path, tree_size_bytes


def count_params(cfg: ModelConfig) -> dict:
    """Total and activated (per-token) parameter counts from the real param
    tree, built on the meta device (``trainer.abstract_params``)."""
    total, expert, embed, enc, _ = _counts(cfg)
    active = total - expert - embed
    if cfg.n_experts:
        active += expert * cfg.experts_per_token / cfg.n_experts
    return {"total": total, "active": int(active), "expert": expert,
            "embed": embed, "encoder": enc}


def param_bytes(cfg: ModelConfig) -> int:
    """The parameter tree's bytes, each leaf in its own dtype (norm scales
    and the moe family's routers are float32 beside the config's dtype)."""
    return _counts(cfg)[4]


@functools.lru_cache(maxsize=64)
def _counts(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    """(total, expert, embed, encoder, bytes) of the parameter tree on meta,
    once a config (kimi-k2's tree takes seconds to build even there)."""
    from repro_torch.train.trainer import abstract_params

    total = expert = embed = enc = nbytes = 0
    for ks, leaf in tree_leaves_with_path(abstract_params(get_api(cfg))):
        n = leaf.numel()
        total += n
        nbytes += n * leaf.element_size()
        if "moe" in ks and ("w_gate" in ks or "w_up" in ks or "w_down" in ks):
            expert += n
        if ks.endswith("embed']"):
            embed += n          # gather: ~0 matmul flops
        if "enc_layers" in ks:
            enc += n
    return total, expert, embed, enc, nbytes


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference fwd), D = processed tokens.

    N_active excludes embedding gathers; enc-dec prefill (= encode only) uses
    the encoder share of the parameters.
    """
    counts = count_params(cfg)
    n_active = counts["active"]
    if shape.kind == "prefill" and cfg.family == "audio":
        n_active = counts["encoder"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch          # decode: one token per seq


def probe_depths(cfg: ModelConfig) -> tuple[int, int]:
    period = cfg.attn_every or 1
    return period, 2 * period


def _probe_cfg(cfg: ModelConfig, depth: int) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        n_layers=depth + cfg.first_k_dense,
        n_enc_layers=depth if cfg.n_enc_layers else 0,
        scan_unroll=max(depth, 1),
    )


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg=None) -> dict:
    """One run of the cell's step on the meta device under an
    :class:`~repro_torch.roofline.counter.OpCounter`: its counts (flops,
    flops by dtype, bytes, kernels, peak bytes with the inputs' storages
    counted live from the start), its collectives' wire bytes, the kind and
    the seconds the count took."""
    from repro_torch.train.trainer import lower_cell

    t0 = time.time()
    step, args, info = lower_cell(cfg, shape, mesh, tcfg)
    with OpCounter("meta") as c:
        c.track(args)
        step(*args)
    coll = collective_stats(c.collectives)
    return {**c.summary(), "wire": coll["total_wire_bytes"],
            "by_kind": {k: v["wire_bytes"] for k, v in coll["by_kind"].items()},
            "collectives": coll["by_kind"], **info, "count_s": time.time() - t0}


def extrapolate(probes: list[dict], d1: int, d2: int, depth: int, key: str):
    """(f(depth), slope) from the two probes' ``key``, the slope clamped at 0
    and the value at the first probe's (a layer cannot remove work)."""
    f1, f2 = probes[0].get(key, 0.0), probes[1].get(key, 0.0)
    slope = max((f2 - f1) / (d2 - d1), 0.0)
    return max(f1 + slope * (depth - d1), f1), slope


def probe_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg=None) -> dict:
    """Count the two depth probes at full width; extrapolate to full depth."""
    from repro_torch.train.trainer import TrainerConfig

    tcfg = tcfg or TrainerConfig(sp=True)
    d1, d2 = probe_depths(cfg)
    results = []
    for d in (d1, d2):
        r = count_cell(_probe_cfg(cfg, d), shape, mesh, tcfg)
        results.append({"depth": d, **{k: r[k] for k in (
            "flops", "flops_by_dtype", "bytes", "wire", "by_kind", "collectives", "kernels",
            "peak_bytes", "count_s")}})

    L_full = cfg.n_layers - cfg.first_k_dense
    flops, flops_slope = extrapolate(results, d1, d2, L_full, "flops")
    bytes_, bytes_slope = extrapolate(results, d1, d2, L_full, "bytes")
    wire, wire_slope = extrapolate(results, d1, d2, L_full, "wire")
    by_dtype = {dt: extrapolate([r["flops_by_dtype"] for r in results], d1, d2, L_full, dt)[0]
                for dt in sorted(set(results[0]["flops_by_dtype"])
                                 | set(results[1]["flops_by_dtype"]))}
    by_kind = {k: extrapolate([r["by_kind"] for r in results], d1, d2, L_full, k)[0]
               for k in sorted(set(results[0]["by_kind"]) | set(results[1]["by_kind"]))}
    return {
        "per_device": {"flops": flops, "flops_by_dtype": by_dtype, "bytes": bytes_,
                       "wire_bytes": wire, "wire_by_kind": by_kind},
        "slopes": {"flops": flops_slope, "bytes": bytes_slope, "wire": wire_slope},
        "probes": results,
    }


def roofline_terms(per_device: dict, n_chips: int, cfg, shape) -> dict:
    """The reference's terms over ``hw``'s peaks: compute by dtype, memory,
    collective over NVLink; the bound is the largest (perfect overlap)."""
    by_dtype = {dt: f / hw.PEAK_FLOPS[dt] for dt, f in per_device["flops_by_dtype"].items()}
    t_comp = sum(by_dtype.values())
    t_mem = per_device["bytes"] / hw.HBM_BW
    t_coll = per_device["wire_bytes"] / hw.NVLINK_BW
    dominant = max(
        [("compute", t_comp), ("memory", t_mem), ("collective", t_coll)], key=lambda kv: kv[1]
    )[0]
    mf = model_flops(cfg, shape)
    counted_global = per_device["flops"] * n_chips
    step_time = max(t_comp, t_mem, t_coll)    # perfect-overlap lower bound
    mfu = mf / (n_chips * hw.PEAK_FLOPS_BF16 * step_time) if step_time > 0 else 0.0
    return {
        "t_compute_s": t_comp,
        "t_compute_by_dtype_s": by_dtype,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": counted_global,   # the reference's key: the counted flops
        "useful_ratio": mf / counted_global if counted_global else 0.0,
        "roofline_fraction": mfu,             # MODEL_FLOPS-based MFU at the bound
    }


def weights_read(params) -> int:
    """Bytes a decode step reads of the weights: all but the embedding table,
    of which it gathers B rows."""
    return tree_size_bytes(params) - params["embed"].numel() * params["embed"].element_size()


def decode_bytes(params, state, cfg: ModelConfig | None = None, distinct=None) -> int:
    """The bytes a decode step must read: the weights once (:func:`weights_read`)
    and its cache or state once. For the moe family, ``distinct`` (with
    ``cfg``) lists for each MoE layer how many experts the step's tokens
    route to: the experts no token chose are not read."""
    full = tree_size_bytes(state) + weights_read(params)
    if distinct is None:
        return full
    moe = params["layers"]["moe"]
    b_expert = sum(moe[w][0, 0].numel() * moe[w].element_size()
                   for w in ("w_gate", "w_up", "w_down"))
    n_moe = cfg.n_layers - cfg.first_k_dense
    if len(distinct) != n_moe:
        raise ValueError(f"{len(distinct)} counts of routed experts for {n_moe} MoE layers")
    return full - (cfg.n_experts * n_moe - sum(distinct)) * b_expert
