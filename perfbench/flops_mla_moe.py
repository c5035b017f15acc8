"""Operation and byte counts of a DeepSeek-V3-style model (latent attention,
routed and shared experts, leading dense layers), written out from the
shapes; ``flops.py`` holds the dense decoder's and the H100's peaks.

Per token, with D = ``d_model``, H heads, dn, dr, dv the no-rotary,
rotary and value head widths, r = ``kv_lora_rank``, E experts of width F,
k of them a token, ``num_shared_experts`` shared of width F each, and the
dense layers' width Fd, the weights a token multiplies:

* MLA, every layer: W_q D x H (dn + dr), W_kva D x (r + dr), W_kvb
  r x H (dn + dv), W_o H dv x D;
* a dense layer: SwiGLU, 3 D Fd;
* an MoE layer: the router D x E, the k chosen experts 3 D F each, the
  shared experts 3 D F each;
* the untied LM head D x V (the embedding lookup multiplies nothing).

Attention, a layer and a causal sequence of S tokens: 2 (dn + dr) per
attended pair and head for q k^T, 2 dv for the product with v.
"""
from __future__ import annotations

from perfbench import flops


def mla_params(cfg: dict) -> int:
    D, H = cfg["d_model"], cfg["num_heads"]
    dn, dr, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                     cfg["kv_lora_rank"])
    return D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) + H * dv * D


def active_params(cfg: dict) -> int:
    """The matmul weights one token multiplies through the model and head."""
    D, L, nd = cfg["d_model"], cfg["num_layers"], cfg["first_dense_layers"]
    dense_ffn = 3 * D * cfg["dense_d_ff"]
    moe_ffn = (D * cfg["num_experts"]
               + (cfg["num_experts_per_tok"] + cfg["num_shared_experts"]) * 3 * D * cfg["d_ff"])
    return L * mla_params(cfg) + nd * dense_ffn + (L - nd) * moe_ffn + D * cfg["vocab_size"]


def attention_flops(cfg: dict, S: int) -> int:
    """One layer's q k^T and its product with v over a causal sequence of S."""
    per_pair = 2 * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) + 2 * cfg["v_head_dim"]
    return per_pair * cfg["num_heads"] * flops.attended_pairs(S, True, None)


def train_flops(cfg: dict, sequences: int, S: int) -> int:
    """Model FLOPs of a forward and backward over ``sequences`` of S tokens:
    6 times the active weights a token, plus three times each layer's
    causal attention.  Recomputed and replayed work is not counted."""
    return sequences * (6 * active_params(cfg) * S
                        + 3 * cfg["num_layers"] * attention_flops(cfg, S))


def expert_forward_flops(cfg: dict, tokens: int) -> int:
    """The routed experts' three products in one MoE layer's forward over
    ``tokens``: 2 x (tokens x k pairs) x 3 x D x F."""
    pairs = tokens * cfg["num_experts_per_tok"]
    return 2 * pairs * 3 * cfg["d_model"] * cfg["d_ff"]


def expert_forward_bytes(cfg: dict, tokens: int, elem: int = 2) -> int:
    """The least bytes those products move in one call: every expert's
    three weights once, each pair's row read by the gate and up products,
    their two results written and read, the down product's row written."""
    D, Fe, E = cfg["d_model"], cfg["d_ff"], cfg["num_experts"]
    pairs = tokens * cfg["num_experts_per_tok"]
    return elem * (3 * E * D * Fe + pairs * (2 * D + 4 * Fe + D))
