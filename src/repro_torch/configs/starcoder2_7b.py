"""StarCoder2-7B — GQA kv=4, RoPE, layernorm + gelu MLP. [arXiv:2402.19173]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    qkv_bias=True,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_theta=100_000.0,
    sliding_window=4096,
    source="arXiv:2402.19173",
)
