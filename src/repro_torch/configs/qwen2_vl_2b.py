"""Qwen2-VL 2B — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Assignment: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
The vision tower is a STUB: input_specs() supplies precomputed patch embeddings
merged into the token stream; the backbone applies multimodal RoPE with
(t, h, w) sections (16, 24, 24) over head_dim 128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    n_vision_tokens=256,
)
