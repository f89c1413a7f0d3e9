"""The per-architecture API the trainer, the serving engine and the launchers
use (the port of ``repro.models.api``): the dense and vlm families'
``init_params``, ``loss_fn``, ``prefill_fn``, ``decode_fn`` and
``init_decode_state``.

The serving calls take the reference's arguments plus ``device=`` (default
"cuda", which raises without a card): ``prefill_fn`` and ``decode_fn`` move
their inputs there, ``init_decode_state`` allocates the cache there. The
other families (moe, ssm, hybrid, audio) are not ported yet: ``get_api``
raises ``not_ported``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.models.transformer import NO_DIST
from repro_torch.utils.device import not_ported, resolve_device
from repro_torch.utils.host import on_device


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable[..., Any]         # (seed, device) -> params
    loss_fn: Callable[..., Any]             # (params, batch, dist) -> (loss, metrics)
    prefill_fn: Callable[..., Any]          # (params, batch, dist) -> (logits, cache)
    decode_fn: Callable[..., Any]           # (params, token, cache, cur_len, dist) -> (logits, cache)
    init_decode_state: Callable[..., Any]   # (batch, max_len) -> cache


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in ("dense", "vlm"):
        raise not_ported(f"the {cfg.family} family", "LM side, last")

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
