"""Llama-3.2-Vision-90B — 100 layers: gated cross-attention every 5th.

[hf:meta-llama/Llama-3.2-11B-Vision family]  The ViT vision encoder +
projector is a stub (``input_specs`` supplies patch embeddings of shape
(B, 1601, 7680)); the language decoder with interleaved gated cross-attn
layers is fully implemented.  100 layers = 20 superblocks x (1 cross + 4
self).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    num_image_tokens=1601,
    vision_dim=7680,
    sliding_window=4096,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
