"""Model/shape configuration dataclasses shared by all assigned architectures
(the port's own copy of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "vlm", "audio", "hybrid", "ssm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                 # per-expert hidden size
    n_shared_experts: int = 0
    first_k_dense: int = 0            # leading dense layers (DeepSeek/Kimi style)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # --- attention patterns ---
    sliding_window: int = 0           # >0 → local layers use this window
    local_global_ratio: int = 0       # gemma3: 5 local per 1 global
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0    # gemma3 global layers use 1e6
    mrope_sections: tuple[int, int, int] | None = None   # qwen2-vl
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4
    attn_every: int = 0               # zamba2: shared attn block period
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    # --- misc ---
    n_vision_tokens: int = 64         # vlm stub: precomputed patch embeddings
    rms_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"        # "full" | "save_attn" (keep flash outputs)
    scan_unroll: int = 1              # >1 only for roofline depth probes

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self) -> "ModelConfig":
        """Smoke-test config: same family/topology, tiny sizes, CPU-friendly."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.attn_every or self.local_global_ratio else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            first_k_dense=min(self.first_k_dense, 1),
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            mrope_sections=(4, 2, 2) if self.mrope_sections else None,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 128,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2) if self.n_enc_layers else 0,
            n_vision_tokens=8,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    def reduced(self) -> "ShapeConfig":
        return dataclasses.replace(self, seq_len=min(self.seq_len, 32), global_batch=min(self.global_batch, 2))


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence handling: run for SSM/hybrid and the
# 5:1-local gemma3; skip for pure full-attention archs (see DESIGN.md §4).
LONG_CONTEXT_ARCHS = {"mamba2-1.3b", "zamba2-1.2b", "gemma3-1b"}


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "skip: pure full-attention arch at 500k decode (DESIGN.md §4)"
    return True, ""
