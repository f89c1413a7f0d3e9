"""The per-architecture API the trainer, the serving engine and the launchers
use (the port of ``repro.models.api``): each family's ``init_params``,
``loss_fn``, ``prefill_fn``, ``decode_fn`` and ``init_decode_state``.

The serving calls take the reference's arguments plus ``device=`` (default
"cuda", which raises without a card): ``prefill_fn`` and ``decode_fn`` move
their inputs there, ``init_decode_state`` allocates the cache or state
there. Per family, as the reference's:

- dense, moe, vlm: ``prefill_fn`` gives (last-token logits, the KV cache;
  with leading dense layers also theirs, ``pre_k``/``pre_v``);
- ssm: ``prefill_fn`` gives (last-token logits, the stacked per-layer
  ``{"ssm", "conv"}`` states), from which ``decode_fn`` continues;
- hybrid: ``prefill_fn`` gives (last-token logits, None): no prefill cache,
  a prompt is decoded token by token into ``init_decode_state``'s;
- audio: ``prefill_fn(params, {"frames": ...}, max_len=)`` gives (None,
  the cache of ``encdec.init_decode_cache``, in ``cache_dtype``, bf16 by
  default) and ``init_decode_state`` is None.

``params_from_reference`` carries the reference's parameter tree of any
family into the port (``params_to_reference`` back): the moe family's
``pre_layers`` list and ``moe`` subtrees (a float32 router beside the
experts in the config's dtype) too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, mamba_lm
from repro_torch.models import transformer as tr
from repro_torch.models.common import params_to_reference, tree_from_reference  # noqa: F401
from repro_torch.models.transformer import NO_DIST
from repro_torch.utils.device import resolve_device
from repro_torch.utils.host import on_device


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable[..., Any]         # (seed, device) -> params
    loss_fn: Callable[..., Any]             # (params, batch, dist) -> (loss, metrics)
    prefill_fn: Callable[..., Any]          # (params, batch, dist) -> (logits, cache)
    decode_fn: Callable[..., Any]           # (params, token, cache, cur_len, dist) -> (logits, cache)
    init_decode_state: Callable[..., Any]   # (batch, max_len) -> cache


# the modules of the families that are not the transformer's, which name
# their parameter tree's keys
_FAMILY = {"ssm": mamba_lm, "hybrid": hybrid, "audio": encdec}


def params_from_reference(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's parameter tree of ``cfg``'s family (nested dicts of
    numpy arrays, layers stacked; bfloat16 as ``ml_dtypes`` arrays or their
    2-byte words) as the port's tensors on ``device``: the port then
    computes what the reference computes."""
    keys = _FAMILY[cfg.family].TREE_KEYS if cfg.family in _FAMILY else tr.tree_keys(cfg)
    return tree_from_reference(tree, keys, cfg, device)


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "ssm":
        return _ssm_api(cfg)
    if cfg.family == "hybrid":
        return _hybrid_api(cfg)
    if cfg.family == "audio":
        return _audio_api(cfg)

    def loss_fn(params, batch, dist=NO_DIST, **kw):
        return tr.lm_loss(params, batch, cfg, dist, **kw)

    def prefill_fn(params, batch, dist=NO_DIST, device="cuda", **kw):
        dev = resolve_device(device)
        extra = {k: on_device(batch[k], dev) for k in ("positions", "vision_embeds") if k in batch}
        return tr.prefill(params, on_device(batch["tokens"], dev), cfg, dist, **extra, **kw)

    def decode_fn(params, token, cache, cur_len, dist=NO_DIST, device="cuda"):
        return tr.decode_step(params, on_device(token, resolve_device(device)), cache, cur_len, cfg,
                              dist)

    def init_decode_state(batch, max_len, device="cuda"):
        return tr.init_kv_cache(cfg, batch, max_len, device=device)

    return ModelAPI(
        cfg=cfg,
        init_params=lambda seed, device="cuda": tr.init_lm_params(seed, cfg, device),
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        init_decode_state=init_decode_state,
    )


def _ssm_api(cfg: ModelConfig) -> ModelAPI:
    def ssm_prefill(params, batch, dist=NO_DIST, device="cuda", **kw):
        return mamba_lm.prefill(params, on_device(batch["tokens"], resolve_device(device)), cfg,
                                dist)

    def decode_fn(params, token, cache, cur_len, dist=NO_DIST, device="cuda"):
        return mamba_lm.decode_step(params, on_device(token, resolve_device(device)), cache,
                                    cur_len, cfg, dist)

    return ModelAPI(
        cfg=cfg,
        init_params=lambda seed, device="cuda": mamba_lm.init_mamba_lm_params(seed, cfg, device),
        loss_fn=lambda params, batch, dist=NO_DIST, **kw: mamba_lm.mamba_lm_loss(params, batch,
                                                                                 cfg, dist),
        prefill_fn=ssm_prefill,
        decode_fn=decode_fn,
        init_decode_state=lambda batch, max_len, device="cuda": mamba_lm.init_decode_state(
            cfg, batch, device=device),
    )


def _hybrid_api(cfg: ModelConfig) -> ModelAPI:
    def hyb_prefill(params, batch, dist=NO_DIST, device="cuda", **kw):
        # the training-style pass is the prefill compute; decode states are
        # rebuilt by decoding the prompt, as in the reference
        tokens = on_device(batch["tokens"], resolve_device(device))
        return hybrid.prefill_logits(params, tokens, cfg, dist, **kw), None

    def decode_fn(params, token, cache, cur_len, dist=NO_DIST, device="cuda"):
        return hybrid.decode_step(params, on_device(token, resolve_device(device)), cache, cur_len,
                                  cfg, dist)

    return ModelAPI(
        cfg=cfg,
        init_params=lambda seed, device="cuda": hybrid.init_hybrid_params(seed, cfg, device),
        loss_fn=lambda params, batch, dist=NO_DIST, **kw: hybrid.hybrid_loss(params, batch, cfg,
                                                                             dist, **kw),
        prefill_fn=hyb_prefill,
        decode_fn=decode_fn,
        init_decode_state=lambda batch, max_len, device="cuda": hybrid.init_decode_state(
            cfg, batch, max_len, device=device),
    )


def _audio_api(cfg: ModelConfig) -> ModelAPI:
    def audio_prefill(params, batch, dist=NO_DIST, max_len: int = 128, device="cuda",
                      cache_dtype=torch.bfloat16, **kw):
        frames = on_device(batch["frames"], resolve_device(device))
        return None, encdec.init_decode_cache(params, frames, cfg, max_len, dist, cache_dtype)

    def decode_fn(params, token, cache, cur_len, dist=NO_DIST, device="cuda"):
        return encdec.decode_step(params, on_device(token, resolve_device(device)), cache, cur_len,
                                  cfg, dist)

    return ModelAPI(
        cfg=cfg,
        init_params=lambda seed, device="cuda": encdec.init_encdec_params(seed, cfg, device),
        loss_fn=lambda params, batch, dist=NO_DIST, **kw: encdec.encdec_loss(params, batch, cfg,
                                                                             dist, **kw),
        prefill_fn=audio_prefill,
        decode_fn=decode_fn,
        init_decode_state=None,  # built by prefill (needs the encoder's output)
    )
