"""Analytic per-device memory of a cell on the H100 (the port of
``repro.roofline.memmodel``).

The dry-run reports two numbers a cell: the meta device's high-water mark of
live storages (``counter.OpCounter``, exact for the eager step that runs,
extrapolated from the depth probes) and this model, which names where the
bytes go. Its state components are the port's own state, to the byte where
the optimizer is not factored:

- ``params``: the parameter tree's bytes, each leaf in its own dtype
  (``analysis.param_bytes``: norm scales and routers are float32 beside
  the config's dtype);
- ``grads``: the flat zero-padded float32 gradient vector the trainer sums
  the micro-batches into (``trainer.grads_into``);
- ``residual``: the float32 error-feedback residual (with compression);
- ``optimizer``: AdamW's moments in ``OptConfig.moment_dtype``, m only with
  momentum, a factored v (rows and columns) as ≈ 1 % of a full one, as the
  reference takes it.

The activation terms keep the reference's residences. Only data parallelism
is ported: every rank holds the whole state (the parameters are replicated,
``n_tp`` is 1), so only the activations shrink with more devices.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import param_bytes

def _moe_buffer_bytes(cfg: ModelConfig, tokens_loc: int, n_tp: int) -> int:
    if not cfg.n_experts:
        return 0
    t_l = max(1, tokens_loc // n_tp)
    cap_s = math.ceil(t_l * cfg.experts_per_token / n_tp * cfg.capacity_factor)
    cap_s = max(8, -(-cap_s // 8) * 8)
    send = n_tp * cap_s * cfg.d_model * 2
    e_loc = max(1, cfg.n_experts // n_tp)
    cap_e = max(8, math.ceil(n_tp * cap_s / e_loc * cfg.capacity_factor))
    buf = e_loc * cap_e * cfg.d_model * 2
    hid = e_loc * cap_e * cfg.moe_d_ff * 2 * 2
    # fwd + bwd copies of the four stages
    return 2 * (2 * send + buf + hid)


def opt_bytes(total_params: int, momentum: bool, factored: bool, moment_bytes: int) -> int:
    """AdamW's state: m (with momentum) and v, a factored v ≈ 1 % of a full
    one, and the step count."""
    b = total_params * moment_bytes if momentum else 0
    b += total_params * moment_bytes * (0.01 if factored else 1)
    return int(b) + 4          # and the int32 step


def grads_bytes(total_params: int, chunk_p: int = 1) -> int:
    """The flat float32 gradient vector, zero-padded to whole ``chunk_p``s."""
    return (total_params + (-total_params % chunk_p)) * 4


def peak_model(cfg: ModelConfig, shape: ShapeConfig, n_dev: int, n_dp: int, n_tp: int,
               total_params: int, *, sp: bool = True, momentum: bool = True,
               factored: bool = False, moment_bytes: int = 4, ce_chunks: int = 8,
               compress=None) -> dict:
    """Per-device peak bytes for one cell: the component breakdown, the total
    and whether it fits the card's 80 GB. ``compress`` is the trainer's
    ``CompressConfig`` (or None)."""
    d = cfg.d_model
    L = cfg.n_layers + cfg.n_enc_layers
    comp: dict[str, float] = {}
    comp["params"] = param_bytes(cfg)      # whole on every rank
    if shape.kind == "train":
        tokens_loc = shape.global_batch * shape.seq_len / n_dp
        comp["optimizer"] = opt_bytes(total_params, momentum, factored, moment_bytes)
        comp["grads"] = grads_bytes(total_params, compress.chunk_p if compress else 1)
        if compress is not None and compress.error_feedback:
            comp["residual"] = total_params * 4
        comp["saved_x"] = L * tokens_loc * d * 2 / (n_tp if sp else 1)
        comp["logits"] = tokens_loc * cfg.vocab_size / n_tp * 2 \
            + tokens_loc / ce_chunks * cfg.vocab_size / n_tp * 4
        # per-layer fwd+bwd workspace (qkv/mlp/norm temporaries), ~12 residences
        comp["layer_ws"] = 12 * tokens_loc * d * 2
        comp["moe_ws"] = _moe_buffer_bytes(cfg, int(tokens_loc), n_tp)
        if cfg.ssm_state:
            q = cfg.ssm_chunk
            h = cfg.ssm_heads
            h_loc = h / n_tp if h % n_tp == 0 else h
            comp["ssd_ws"] = 2 * tokens_loc * q * h_loc * 4
    elif shape.kind == "prefill":
        tokens_loc = shape.global_batch * shape.seq_len / n_dp
        if cfg.n_heads:   # attention-free archs have no KV cache
            comp["cache_out"] = (2 * L * tokens_loc * cfg.n_kv_heads * cfg.hd * 2
                                 / max(1, n_tp if sp else 1))
        comp["layer_ws"] = 8 * tokens_loc * d * 2
        comp["moe_ws"] = _moe_buffer_bytes(cfg, int(tokens_loc), n_tp)
        if cfg.ssm_state:
            h_loc = cfg.ssm_heads / n_tp if cfg.ssm_heads % n_tp == 0 else cfg.ssm_heads
            comp["ssd_ws"] = 2 * tokens_loc * cfg.ssm_chunk * h_loc * 4
            comp["states_out"] = (cfg.n_layers * (shape.global_batch / n_dp) * cfg.ssm_heads
                                  * cfg.ssm_state * cfg.ssm_head_dim * 4)
    else:  # decode
        b_loc = max(1, shape.global_batch / n_dp)
        if cfg.ssm_state and cfg.attn_every == 0:
            comp["state"] = (cfg.n_layers * b_loc * cfg.ssm_heads * cfg.ssm_state
                             * cfg.ssm_head_dim * 4 / n_tp)
        else:
            sites = (cfg.n_layers // cfg.attn_every if cfg.attn_every
                     else (cfg.n_layers + cfg.n_enc_layers))
            seq_shard = n_tp if shape.seq_len % n_tp == 0 else 1
            comp["kv_cache"] = (2 * sites * b_loc * shape.seq_len * cfg.n_kv_heads * cfg.hd * 2
                                / seq_shard)
            if cfg.ssm_state:
                comp["state"] = (cfg.n_layers * b_loc * cfg.ssm_heads * cfg.ssm_state
                                 * cfg.ssm_head_dim * 4 / n_tp)
        s_loc = shape.seq_len / (n_tp if shape.seq_len % n_tp == 0 else 1)
        comp["workspace"] = 4 * b_loc * max(s_loc * cfg.n_heads / max(1, n_tp) * 4, d * 16)
    total = int(sum(comp.values()))
    return {"components": {k: int(v) for k, v in comp.items()}, "total": total,
            "fits_80GB": total < hw.HBM_BYTES}
