"""Abstract input stand-ins for every (arch x input-shape) pair.

Port of ``repro.launch.specs``: where JAX builds ``ShapeDtypeStruct``s,
the port builds tensors on the ``meta`` device, of JAX's shapes and
dtypes, which hold no storage (``llama3_2_vision_90b``'s parameters alone
are 180 GB in bf16).  The dry run turns them into shards of fake tensors
on its mesh (``parallel.sharding.distribute``).
The audio/VLM modality frontends are stubs — ``input_specs`` supplies the
precomputed frame/patch embeddings the decoder consumes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.transformer import (init_cache, init_params,
                                            stack_params)

DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


def sds(shape, dtype: str) -> torch.Tensor:
    """The counterpart of ``jax.ShapeDtypeStruct``: a meta tensor."""
    return torch.empty(shape, dtype=DTYPES[dtype], device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape,
                      grad_accum: int = 1) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    lead: Tuple[int, ...] = ()
    if grad_accum > 1:
        assert B % grad_accum == 0, (B, grad_accum)
        lead, B = (grad_accum,), B // grad_accum
    batch: Dict[str, Any] = {"labels": sds(lead + (B, S), "int32")}
    if cfg.audio_frontend:
        batch["embeds"] = sds(lead + (B, S, cfg.d_model), "bfloat16")
    else:
        batch["tokens"] = sds(lead + (B, S), "int32")
    if cfg.arch_type == "vlm":
        batch["vision"] = sds(lead + (B, cfg.num_image_tokens, cfg.vision_dim),
                              "bfloat16")
    return batch


def prefill_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    if cfg.audio_frontend:
        batch["embeds"] = sds((B, S, cfg.d_model), "bfloat16")
    else:
        batch["tokens"] = sds((B, S), "int32")
    if cfg.arch_type == "vlm":
        batch["vision"] = sds((B, cfg.num_image_tokens, cfg.vision_dim),
                              "bfloat16")
    return batch


def decode_cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    """long_500k uses the sliding-window ring buffer (sub-quadratic)."""
    if shape.seq_len > 65536 and cfg.sliding_window:
        return cfg.sliding_window
    return shape.seq_len


def pad_kv_heads(cfg: ModelConfig, tp: int = 16) -> int:
    """Decode-cache head padding: when kvH does not divide the model axis,
    the flattened kv_dim sharding splits head_dim and the whole per-layer
    cache is all-gathered (~GBs/step).  Padding kvH up to the next
    multiple of tp gives fully local per-head attention.  Only worth it
    when the memory overhead is small (<= 1.7x): kvH 20 -> 32 (qwen1.5),
    24 -> 32 (musicgen).  Returns 0 for "no padding"."""
    if not cfg.has_attention or cfg.num_kv_heads % tp == 0:
        return 0
    padded = ((cfg.num_kv_heads + tp - 1) // tp) * tp
    if padded / cfg.num_kv_heads <= 1.7:
        return padded
    return 0


def decode_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B = shape.global_batch
    cache_len = decode_cache_len(cfg, shape)
    pad = pad_kv_heads(cfg)
    cache = init_cache(cfg, B, cache_len, dtype=torch.bfloat16, device="meta",
                       kv_heads_override=pad or None)
    batch: Dict[str, Any] = {"cache": cache,
                             "index": sds((), "int32")}
    batch["tokens"] = sds((B, 1), "int32")       # decode feeds back tokens
    if cfg.arch_type == "vlm":
        batch["vision"] = sds((B, cfg.num_image_tokens, cfg.vision_dim),
                              "bfloat16")
    return batch


def input_specs(cfg: ModelConfig, shape_name: Union[str, InputShape],
                grad_accum: int = 1) -> Dict[str, Any]:
    """The step's inputs for a shape of ``INPUT_SHAPES`` (by name) or any
    other ``InputShape``."""
    shape = (shape_name if isinstance(shape_name, InputShape)
             else INPUT_SHAPES[shape_name])
    if shape.kind == "train":
        return train_batch_specs(cfg, shape, grad_accum)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return decode_specs(cfg, shape)


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree in the JAX package's stacked layout and names
    (``transformer.stack_params``), as meta tensors."""
    model = init_params(cfg, torch.Generator(), device="meta")
    return stack_params(cfg, model)

