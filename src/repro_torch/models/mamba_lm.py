"""The attention-free Mamba-2 LM: embed → Mamba-2 layers → head (the port of
``repro.models.mamba_lm``).

The parameters are the reference's tree, each layer leaf stacked as
``(n_layers, ...)``, so leaves flatten in the reference's order (a
checkpoint's names, the gradient compressor's flat vector). The forward
runs the layers in a Python loop, each recomputed in the backward pass when
``cfg.remat`` (the reference's ``jax.checkpoint``).

Decoding keeps a constant-size recurrent state, no KV cache: ``{"ssm":
(L, B, H, N, P) float32, "conv": (L, B, W−1, C)}``. ``decode_step`` writes
each layer's new state into the stacked tensors in place (the reference
returns new ones); a conv state whose dtype the step promotes (a bf16 state
in a float32 model, as the reference's default state is) is replaced by one
of the promoted dtype, as the reference's concatenation gives.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.common import (
    cross_entropy_loss,
    embed,
    init_embedding,
    init_rms,
    rms_norm,
    run_blocks,
    truncated_normal_init,
    unstack,
)
from repro_torch.models.transformer import NO_DIST, Dist, generator
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


# the top-level keys of the parameter tree
TREE_KEYS = frozenset({"embed", "layers", "final_norm", "lm_head"})


def init_mamba_lm_params(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's parameter tree for ``cfg``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = generator(seed, device)
    dtype = getattr(torch, cfg.dtype)
    lead = (cfg.n_layers,)
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "layers": {"ln": init_rms(cfg.d_model, device, lead),
                   "mamba": ssm.init_mamba2_params(gen, cfg, dtype, device, lead)},
        "final_norm": init_rms(cfg.d_model, device),
        "lm_head": truncated_normal_init(gen, (cfg.d_model, cfg.vocab_size), 1.0, dtype, device),
    }


def _layer(x, lp, cfg):
    return x + ssm.mamba2_forward(lp["mamba"], rms_norm(x, lp["ln"], cfg.rms_eps), cfg)


def run_layers(lps: list[dict], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x through the Mamba-2 layers ``lps`` (residual blocks)."""
    return run_blocks(_layer, x, lps, cfg.remat, cfg)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, dist: Dist = NO_DIST, **_):
    """tokens (B, S) → logits (B, S, V)."""
    x = run_layers(unstack(params["layers"]), embed(params["embed"], tokens), cfg)
    return rms_norm(x, params["final_norm"], cfg.rms_eps) @ params["lm_head"]


def mamba_lm_loss(params: dict, batch: dict, cfg: ModelConfig, dist: Dist = NO_DIST, **_):
    logits = forward(params, batch["tokens"], cfg, dist)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"nll": loss}


@torch.inference_mode()
def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, dist: Dist = NO_DIST):
    """The prompt pass: (last-token logits (B, V), the per-layer states
    ``{"ssm": (L,B,H,N,P) float32, "conv": (L,B,W−1,C)}``), each layer's
    written into the stacked tensors as it runs."""
    x = embed(params["embed"], tokens)
    states = None
    for i in range(cfg.n_layers):
        lp = tree_map(lambda leaf: leaf[i], params["layers"])
        y, st = ssm.mamba2_forward(lp["mamba"], rms_norm(x, lp["ln"], cfg.rms_eps), cfg,
                                   return_state=True)
        x = x + y
        if states is None:
            states = {k: torch.empty((cfg.n_layers, *v.shape), dtype=v.dtype, device=v.device)
                      for k, v in st.items()}
        for k, v in st.items():
            states[k][i] = v
    x = rms_norm(x[:, -1], params["final_norm"], cfg.rms_eps)
    return x @ params["lm_head"], states


def init_decode_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """A zero state ``{"ssm": (L,B,H,N,P) float32, "conv": (L,B,W−1,C) dtype}``."""
    return ssm.init_mamba2_state(cfg, batch, dtype, resolve_device(device), (cfg.n_layers,))


def write_states(state: dict, i: int, new: dict) -> None:
    """Layer ``i``'s new ``{"ssm", "conv"}`` into the stacked ``state`` in
    place; a stacked tensor of another dtype is first replaced by its cast."""
    for k, v in new.items():
        if state[k].dtype != v.dtype:
            state[k] = state[k].to(v.dtype)
        state[k][i] = v


@torch.inference_mode()
def decode_step(params: dict, token: torch.Tensor, state: dict, cur_len, cfg: ModelConfig,
                dist: Dist = NO_DIST):
    """One token (B, 1) through every layer's recurrence: (logits (B, V),
    the state, updated in place). ``cur_len`` is unused (the state holds the
    position), as in the reference."""
    x = embed(params["embed"], token)
    for i in range(cfg.n_layers):
        lp = tree_map(lambda leaf: leaf[i], params["layers"])
        y, new = ssm.mamba2_decode_step(lp["mamba"], rms_norm(x, lp["ln"], cfg.rms_eps),
                                        {"ssm": state["ssm"][i], "conv": state["conv"][i]}, cfg)
        x = x + y
        write_states(state, i, new)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"])[:, 0], state
