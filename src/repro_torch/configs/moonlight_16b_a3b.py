"""Moonlight-16B-A3B — DeepSeek-V3 layers: latent attention (MLA), 64
sigmoid-routed experts top-6 plus 2 shared, one leading dense layer.

[hf:moonshotai/Moonlight-16B-A3B] (``model_type`` ``deepseek_v3``;
arXiv:2412.19437 Sec. 2.1).  No query compression (``q_lora_rank``
null): q = x W_q, 16 heads x (128 + 64 rotary); [c, k_r] = x W_kva, a
512-wide latent and one 64-wide rotary key all heads share; RMSNorm(c)
W_kvb gives 16 x (128 key + 128 value).  The router scores
sigmoid(x W_r), chooses the top 6 of the scores plus a per-expert bias,
and weighs the chosen scores renormalised, times 2.446.  A port-only
config: the JAX package has no MLA.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,                       # a query/key head: 128 + 64 rotary
    d_ff=1408,                          # each routed expert
    vocab_size=163840,
    rope_theta=50_000.0,
    norm_eps=1e-5,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    router_score="sigmoid",
    norm_topk_prob=True,
    routed_scaling_factor=2.446,
    first_dense_layers=1,
    dense_d_ff=11264,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
