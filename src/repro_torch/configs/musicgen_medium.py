"""MusicGen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284]  Audio modality frontend (EnCodec + codebook interleave)
is a stub: ``input_specs`` supplies precomputed frame embeddings (B, S, D);
the decoder transformer below is fully implemented.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    mlp_type="gelu",
    norm_type="layernorm",
    sliding_window=4096,
    audio_frontend=True,
    source="arXiv:2306.05284",
)
