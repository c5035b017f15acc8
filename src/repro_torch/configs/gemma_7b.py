"""Gemma-7B — GeGLU MLP, head_dim 256. [arXiv:2403.08295]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="geglu",
    sliding_window=4096,
    tie_embeddings=True,
    source="arXiv:2403.08295",
)
