"""The paper's LLaMA-like evaluation model (Sec. VI: d_model=1024, 16
layers; the paper lists n_heads=18 which does not divide 1024 — we use 16
heads of dim 64 and note the adjustment in DESIGN.md)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gwtf-llama-300m",
    arch_type="dense",
    num_layers=16,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=32000,
    source="GWTF paper Sec. VI",
)
