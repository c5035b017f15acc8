"""Granite-MoE 3B-a800m — 40 experts, top-8, per-expert d_ff=512.

[hf:ibm-granite/granite-3.0-1b-a400m-base family]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    num_experts_per_tok=8,
    sliding_window=4096,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
