"""Mamba2-130m — attention-free SSD (state-space duality) decoder.

[arXiv:2405.21060]  d_inner = 2*768 = 1536; 24 SSD heads of dim 64;
state N=128.  long_500k runs on the native O(1)-state decode path.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_heads=24,
    ssm_head_dim=64,
    source="arXiv:2405.21060",
)
