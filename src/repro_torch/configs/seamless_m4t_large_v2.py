"""SeamlessM4T large v2 — enc-dec, multimodal [arXiv:2308.11596; hf].

Assignment: 24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
Interpreted as 24 encoder + 24 decoder layers (the seamless large text stacks).
The audio frontend is a STUB: input_specs() supplies precomputed frame
embeddings (B, S, d) for the encoder; the decoder consumes text tokens with
cross-attention into the encoder output.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                  # decoder layers
    n_enc_layers=24,              # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=1e4,
)
