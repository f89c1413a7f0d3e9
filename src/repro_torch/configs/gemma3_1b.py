"""Gemma 3 1B — 5:1 local:global attention, 128k ctx [hf:google/gemma-3-1b-pt; unverified].

Assignment: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
Local layers use a 512-token sliding window with rope θ=1e4; every 6th layer is
global with θ=1e6 (the 5:1 pattern). head_dim=256 (decoupled from d_model/H).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    sliding_window=512,
    local_global_ratio=5,
    rope_theta=1e4,
    rope_theta_global=1e6,
)
