"""LLaMA-7B as used in the paper's convergence experiment (Sec. VI)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gwtf-llama-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    source="GWTF paper Sec. VI / arXiv:2302.13971",
)
