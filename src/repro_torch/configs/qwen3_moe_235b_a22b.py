"""Qwen3-MoE 235B-A22B — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family; hf].

Assignment: 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8.
All layers are MoE (no shared experts), per Qwen3-MoE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=12288,                   # unused (no dense layers); kept for completeness
    moe_d_ff=1536,
    n_experts=128,
    experts_per_token=8,
    n_shared_experts=0,
    first_k_dense=0,
    vocab_size=151936,
    rope_theta=1e6,
)
