"""Qwen2-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B]  Shared expert = one dense MLP of width
4 x 1408; router renormalises top-4 probs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
