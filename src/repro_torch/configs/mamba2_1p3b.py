"""Mamba2 1.3B — SSD (state-space duality), attention-free [arXiv:2405.21060; unverified].

Assignment: 48L d_model=2048 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
d_inner = 2·d_model = 4096, head_dim 64 → 64 SSD heads, ngroups=1, conv width 4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
)
