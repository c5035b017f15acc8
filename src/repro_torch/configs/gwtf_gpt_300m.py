"""The paper's GPT-like evaluation model (Sec. VI)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gwtf-gpt-300m",
    arch_type="dense",
    num_layers=16,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=50257,
    mlp_type="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
    source="GWTF paper Sec. VI",
)
