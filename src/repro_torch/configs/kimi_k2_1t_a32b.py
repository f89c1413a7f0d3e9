"""Kimi K2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2; unverified].

Assignment: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8.
d_ff=2048 is the per-expert hidden size (DeepSeek-V3-style); we keep Kimi's one
shared expert and one leading dense layer (dense-layer FFN = 8 experts' width).
The paper-exact MLA attention is approximated by GQA kv=8 per the assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,                 # 7168 / 64
    d_ff=16384,                   # dense (first_k_dense) layers' FFN
    moe_d_ff=2048,
    n_experts=384,
    experts_per_token=8,
    n_shared_experts=1,
    first_k_dense=1,
    vocab_size=163840,
    rope_theta=5e4,
)
