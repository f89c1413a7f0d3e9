"""Architecture registry: ``--arch <id>`` resolution for every assigned config."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_coder_33b,
    gemma3_1b,
    glm4_9b,
    kimi_k2_1t_a32b,
    mamba2_1p3b,
    phi3_medium_14b,
    qwen2_vl_2b,
    qwen3_moe_235b_a22b,
    seamless_m4t_large_v2,
    zamba2_1p2b,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, cell_is_runnable  # noqa: F401

ARCHS: dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (
        kimi_k2_1t_a32b,
        qwen3_moe_235b_a22b,
        qwen2_vl_2b,
        deepseek_coder_33b,
        glm4_9b,
        gemma3_1b,
        phi3_medium_14b,
        seamless_m4t_large_v2,
        zamba2_1p2b,
        mamba2_1p3b,
    )
}


def get_arch(name: str, reduced: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    return cfg.reduced() if reduced else cfg


def get_shape(name: str, reduced: bool = False) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    s = SHAPES[name]
    return s.reduced() if reduced else s


def all_cells():
    """Every (arch, shape) pair with its runnability verdict — 40 cells."""
    for a in ARCHS:
        for s in SHAPES:
            ok, why = cell_is_runnable(a, s)
            yield a, s, ok, why
