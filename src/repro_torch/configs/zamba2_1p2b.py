"""Zamba2 1.2B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf].

Assignment: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
38 Mamba2 layers; a single weight-tied transformer block (MHA 32 heads +
FFN 8192) is applied after every 6th Mamba layer (Zamba2's shared-block design,
simplified: no LoRA adapters per call site — noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    attn_every=6,
    rope_theta=1e4,
)
