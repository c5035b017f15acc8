"""Hymba-1.5B — hybrid: parallel attention + mamba heads per layer.

[arXiv:2411.13676]  25 attn heads (hd 64, kv=5) in parallel with SSD heads
(d_inner 3200, 50 heads, state 16); outputs mean-combined.  Meta tokens
are not modelled (noted in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_heads=50,
    ssm_head_dim=64,
    sliding_window=4096,
    source="arXiv:2411.13676",
)
