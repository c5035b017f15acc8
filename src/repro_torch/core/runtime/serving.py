"""Seeded serving inputs of the PyTorch port.

Port of ``repro.core.runtime.serving.serving_inputs`` for the dense, SSM
and hybrid models (``init_params`` draws the SSM weights at the JAX
package's scales).  The flow-routed ``ServeTrainer`` is not ported yet
(ROADMAP.md, Queue 1 item 3).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, init_params


def _generators(seed: int, device):
    """Independent generators for params, prompt and sampling, on
    ``device``, from one seed (``torch.Generator`` cannot reproduce the
    JAX keys; tests hand both packages the same numpy inputs instead)."""
    states = np.random.SeedSequence(seed).generate_state(3, dtype=np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in states)


def serving_inputs(cfg: ModelConfig, *, seed: int, batch: int,
                   prompt_len: int, device="cuda"):
    """Seeded ``(model, prompt, sample_generator)`` setup on ``device``."""
    dev = resolve_device(device)
    g_params, g_prompt, g_sample = _generators(seed, dev)
    model: Transformer = init_params(cfg, g_params, dev)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g_prompt, device=dev)
    return model, prompt, g_sample
