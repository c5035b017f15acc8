"""TinyLlama-1.1B — llama2-arch small, GQA kv=4. [arXiv:2401.02385]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    sliding_window=4096,
    source="arXiv:2401.02385",
)
