"""Model configuration for all supported architectures.

A copy of ``repro.models.config`` (the JAX package's ``ModelConfig`` and
the four input shapes of the dry run), kept here so that the PyTorch port
never imports the JAX package.  One frozen
dataclass covers the 6 architecture families assigned to this paper
(dense / ssm / moe / hybrid / vlm / audio) plus the paper's own GPT-like
and LLaMA-like models.  Every field is explicit so a config file under
``repro_torch/configs/`` is a single readable literal.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                      # query heads (0 for attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int                           # dense-MLP hidden (per-expert size for MoE)
    vocab_size: int

    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # decode-time SWA window (long_500k)

    # --- mlp / norm ---
    mlp_type: str = "swiglu"            # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6

    # --- ssm (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- moe ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0         # qwen2-moe style shared expert(s)
    router_aux_coef: float = 0.01       # load-balance loss coefficient
    router_score: str = "softmax"       # softmax | sigmoid (DeepSeek-V3)
    norm_topk_prob: bool = True         # renormalise the top-k weights
    routed_scaling_factor: float = 1.0  # times the routed experts' weights
    first_dense_layers: int = 0         # leading layers with a dense MLP
    dense_d_ff: int = 0                 # ... of this width

    # --- latent attention (MLA, DeepSeek-V2/V3; on when kv_lora_rank > 0)
    kv_lora_rank: int = 0               # the shared K/V latent's width
    qk_nope_head_dim: int = 0           # a head's query/key width, no RoPE
    qk_rope_head_dim: int = 0           # ... with RoPE (one key all heads share)
    v_head_dim: int = 0

    # --- vlm (cross-attention image layers) ---
    cross_attn_every: int = 0           # every k-th layer is cross-attn (0 = none)
    num_image_tokens: int = 0
    vision_dim: int = 0                 # stub vision-encoder output dim

    # --- audio (decoder over codec-frame embeddings) ---
    audio_frontend: bool = False        # inputs are precomputed frame embeddings

    # --- misc ---
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    remat: bool = True                  # activation checkpointing on layer blocks
    source: str = ""                    # citation

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.arch_type in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def mla_attention_params(self) -> int:
        """One MLA layer's weights: W_q, W_kva, the latent's norm, W_kvb, W_o."""
        D, H = self.d_model, self.num_heads
        qk = self.qk_nope_head_dim + self.qk_rope_head_dim
        return (D * H * qk + D * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank
                + self.kv_lora_rank * H * (self.qk_nope_head_dim + self.v_head_dim)
                + H * self.v_head_dim * D)

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims, runnable on CPU."""
        scale = d_model / self.d_model
        head_dim = min(self.head_dim, 64)
        num_heads = max(1, min(self.num_heads, d_model // head_dim)) if self.num_heads else 0
        num_kv = max(1, min(self.num_kv_heads, num_heads)) if self.num_kv_heads else 0
        if num_heads and num_heads % max(num_kv, 1):
            num_kv = 1
        experts = min(self.num_experts, max_experts)
        topk = min(self.num_experts_per_tok, experts) if experts else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=max(64, int(self.d_ff * scale)) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            ssm_state=min(self.ssm_state, 16),
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            num_experts=experts,
            num_experts_per_tok=topk,
            num_shared_experts=min(self.num_shared_experts, 1),
            cross_attn_every=min(self.cross_attn_every, num_layers) if self.cross_attn_every else 0,
            num_image_tokens=min(self.num_image_tokens, 16),
            vision_dim=min(self.vision_dim, 128) if self.vision_dim else 0,
            first_dense_layers=min(self.first_dense_layers, num_layers - 1),
            dense_d_ff=max(64, int(self.dense_d_ff * scale)) if self.dense_d_ff else 0,
            kv_lora_rank=min(self.kv_lora_rank, d_model // 2),
            qk_nope_head_dim=min(self.qk_nope_head_dim, 32),
            qk_rope_head_dim=min(self.qk_rope_head_dim, 16),
            v_head_dim=min(self.v_head_dim, 32),
            param_dtype="float32",
            remat=False,
        )

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        per_layer = 0
        if self.has_mla:
            per_layer += self.mla_attention_params
        elif self.has_attention:
            per_layer += D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            if self.qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
        if self.has_ssm:
            di = self.d_inner
            ns, nh = self.ssm_state, self.ssm_heads
            per_layer += D * (2 * di + 2 * ns + nh) + di * D + di  # in/out proj + conv-ish
        gated = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        moe_ffn = 0
        if self.is_moe:
            moe_ffn += D * self.num_experts                        # router
            if self.router_score == "sigmoid":
                moe_ffn += self.num_experts                        # choice bias
            e_ff = gated * D * F
            moe_ffn += self.num_experts * e_ff
            moe_ffn += self.num_shared_experts * e_ff
            per_layer += moe_ffn
        elif F:
            per_layer += gated * D * F
        if self.cross_attn_every:
            # cross-attn layers mirror self-attn layers (K/V consume the
            # projected vision embeddings at d_model width) + one vision
            # projector; total layer params ~ per_layer * L.
            per_layer_total = per_layer * L + self.vision_dim * D
        else:
            per_layer_total = per_layer * L
        if self.first_dense_layers:
            # the leading layers hold a dense MLP in place of the experts
            per_layer_total += self.first_dense_layers * (
                gated * D * self.dense_d_ff - moe_ffn)
        embed = V * D * (1 if self.tie_embeddings else 2)
        return per_layer_total + embed + 2 * L * D  # + norms


# The fields that the JAX package's ``ModelConfig`` lacks: a model only the
# port runs (``configs.PORT_ONLY_IDS``) sets them; every config of the JAX
# registry leaves them at their defaults.
PORT_ONLY_FIELDS = ("norm_eps", "router_score", "norm_topk_prob",
                    "routed_scaling_factor", "first_dense_layers", "dense_d_ff",
                    "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                    "v_head_dim")


def port_only_defaults() -> Dict[str, Any]:
    """Each port-only field's default."""
    return {f.name: f.default for f in dataclasses.fields(ModelConfig)
            if f.name in PORT_ONLY_FIELDS}


@functools.lru_cache(maxsize=None)
def dense_layer_config(cfg: ModelConfig) -> ModelConfig:
    """The config of ``cfg``'s leading dense layers (``first_dense_layers``):
    the same attention, with a dense MLP of width ``dense_d_ff``."""
    return dataclasses.replace(cfg, num_experts=0, num_experts_per_tok=0,
                               num_shared_experts=0, d_ff=cfg.dense_d_ff,
                               first_dense_layers=0)


def refuse_mla(cfg: ModelConfig, what: str) -> None:
    """Raise for a path that has no latent attention yet: ``init_cache``
    (serving needs the latent cache, so every serving path stops there),
    the sharded train step and the dry run (no MLA rules)."""
    if cfg.has_mla:
        raise NotImplementedError(
            f"{cfg.name}: {what} does not take latent attention (MLA) yet; "
            "it trains through the staged runtime (--mode gwtf) only")


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
