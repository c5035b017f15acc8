"""Process-wide cache of the staged runtime's initial parameters.

Port of ``repro.core.runtime.cache``.  :func:`initial_params` gives the
per-stage parameter trees (stacked blocks, as ``init_stage_params``
draws them) and the data-node head, keyed on ``(ModelConfig,
num_stages, seed, device)``.  They are drawn on the CPU from
``torch.Generator`` streams derived from ``seed`` (stage ``s`` from
``(seed, s)``, the head from ``(seed, 999)``, as the JAX package folds
its key) and then moved to ``device``, so the CPU and the GPU start from
the same weights; ``torch.Generator`` cannot reproduce the JAX keys, so
tests that hold the port against the JAX package load the JAX package's
draw through ``repro_torch.weights.initial_params_from_jax`` instead.
Trainers replace their parameter trees on update and never write into
them, so sharing the cached trees cannot leak training state.

There is no kernel cache: the port compiles nothing per configuration.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device, spans
from repro_torch.core.runtime.stages import init_head_params, init_stage_params
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


def _generator(*key: int) -> torch.Generator:
    seed = np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


@lru_cache(maxsize=None)
def _initial_params(cfg: ModelConfig, num_stages: int, seed: int,
                    device: torch.device) -> Tuple[tuple, dict]:
    with spans.span("init.params"):
        stage_p = tuple(
            tree_map(lambda t: t.to(device),
                     init_stage_params(cfg, s, num_stages,
                                       _generator(seed, s)))
            for s in range(num_stages))
        head_p = tree_map(lambda t: t.to(device),
                          init_head_params(cfg, _generator(seed, 999)))
    return stage_p, head_p


def initial_params(cfg: ModelConfig, num_stages: int, seed: int = 0,
                   device="cuda") -> Tuple[tuple, dict]:
    """Seeded initial parameters: ``(stage_param_trees, head_params)``."""
    return _initial_params(cfg, num_stages, seed, resolve_device(device))


def cache_info() -> dict:
    return {"initial_params": _initial_params.cache_info()._asdict()}


def clear() -> None:
    _initial_params.cache_clear()
