"""Operation and byte counts, and the H100's published peaks.

Frozen here so that a later change to a kernel or to the program cannot
move the yardstick.  ``attended_pairs`` and ``bound`` are copied from
``chip_smoke.py``; the model counts are written out below from the shapes.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W: 989
TFLOP/s in bf16, 3.35 TB/s of HBM.  A share of a peak is stated with the
card's power limit beside it (``nvidia-smi``'s ``power.limit``).
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def attended_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs the rows attend: what this input needs."""
    return sum((i + 1 if causal else S) - (max(0, i - window + 1) if window else 0)
               for i in range(S))


def bound(shape, elem_bytes: int, causal: bool, window, peak=PEAK_FLOPS_BF16):
    """Least time of one flash-attention call of ``shape`` (B, S, H, KH, D):
    q, k, v and o each moved once, and the attended pairs' Q K^T and P V at
    ``peak``.  Returns (ms, "bytes" or "operations")."""
    B, S, H, KH, D = shape
    nbytes = (2 * B * S * H * D + 2 * B * S * KH * D) * elem_bytes   # q, o, k, v
    flops = 4 * D * attended_pairs(S, causal, window) * B * H        # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def layer_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies in a dense decoder layer: Q, K, V and
    the output projection (D x H hd, 2 x D x KH hd, H hd x D), and the MLP
    (2 D F for a GELU MLP, 3 D F for a gated one).  Biases and norms are
    elementwise and not counted."""
    D, hd = cfg["d_model"], cfg["head_dim"]
    q, kv = cfg["num_heads"] * hd, cfg["num_kv_heads"] * hd
    mlp = (3 if cfg["mlp_type"] in ("swiglu", "geglu") else 2) * D * cfg["d_ff"]
    return 2 * D * q + 2 * D * kv + mlp


def attention_flops(cfg: dict, S: int) -> int:
    """One layer's Q K^T and P V over one causal sequence of S tokens:
    4 hd per attended pair and query head."""
    pairs = attended_pairs(S, True, cfg.get("sliding_window"))
    return 4 * cfg["head_dim"] * cfg["num_heads"] * pairs


def train_flops(cfg: dict, sequences: int, S: int) -> int:
    """Model FLOPs of a forward and backward over ``sequences`` sequences
    of S tokens: 6 N per token, N the layers' matmul weights plus the LM
    head (D x V), plus three times each layer's causal attention (the
    backward costs twice the forward).  The embedding lookup multiplies
    nothing.  Recomputed and replayed work is not counted."""
    N = cfg["num_layers"] * layer_matmul_params(cfg) + cfg["d_model"] * cfg["vocab_size"]
    return sequences * (6 * N * S + 3 * cfg["num_layers"] * attention_flops(cfg, S))


def prefill_flops(cfg: dict, B: int, S: int) -> int:
    """Model FLOPs of a prefill of B prompts of S tokens: 2 N per token
    over the layers' matmul weights, each layer's causal attention, and the
    LM head for the last position of each prompt only (the port's prefill
    returns the last logits)."""
    layers = cfg["num_layers"]
    per_seq = 2 * layers * layer_matmul_params(cfg) * S + layers * attention_flops(cfg, S)
    return B * (per_seq + 2 * cfg["d_model"] * cfg["vocab_size"])
