"""The per-architecture API the trainer and launcher use (the port of
``repro.models.api``): the dense family's ``init_params`` and ``loss_fn``.

Serving (``prefill_fn``, ``decode_fn``, ``init_decode_state``) and the other
families (moe, vlm, ssm, hybrid, audio) are not ported yet: they raise
``not_ported``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.models.transformer import NO_DIST
from repro_torch.utils.device import not_ported


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable[..., Any]         # (seed, device) -> params
    loss_fn: Callable[..., Any]             # (params, batch, dist) -> (loss, metrics)
    prefill_fn: Callable[..., Any]
    decode_fn: Callable[..., Any]
    init_decode_state: Callable[..., Any]


def _serving(what: str) -> Callable[..., Any]:
    def fn(*args, **kwargs):
        raise not_ported(what, "LM side, last")
    return fn


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "dense":
        raise not_ported(f"the {cfg.family} family", "LM side, last")

    def loss_fn(params, batch, dist=NO_DIST, **kw):
        return tr.lm_loss(params, batch, cfg, dist, **kw)

    return ModelAPI(
        cfg=cfg,
        init_params=lambda seed, device="cuda": tr.init_lm_params(seed, cfg, device),
        loss_fn=loss_fn,
        prefill_fn=_serving("prefill (serving the dense family)"),
        decode_fn=_serving("decode_step (serving the dense family)"),
        init_decode_state=_serving("init_kv_cache (serving the dense family)"),
    )
