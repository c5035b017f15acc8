"""Architecture config registry of the PyTorch port.

The same ids and aliases as ``repro.configs``, each config module a copy
of the JAX package's with its import rewritten: all 13 architectures
(dense, SSM, hybrid, MoE, VLM and audio).  ``PORT_ONLY_IDS`` are configs
of the port alone, whose mechanisms the JAX package lacks (latent
attention); ``get_config`` takes both lists, and what is held against
the JAX package iterates ``ARCH_IDS``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# the JAX package's ids in its order: the ten assigned architectures, then
# the paper's own evaluation models (``launch.dryrun --all`` takes the ten)
ARCH_IDS = ["musicgen_medium", "mamba2_130m", "qwen1_5_4b", "gemma_7b",
            "tinyllama_1_1b", "hymba_1_5b", "granite_moe_3b_a800m",
            "llama3_2_vision_90b", "qwen2_moe_a2_7b", "starcoder2_7b",
            "gwtf_llama_300m", "gwtf_gpt_300m", "gwtf_llama_7b"]

# configs of the port alone
PORT_ONLY_IDS = ["moonlight_16b_a3b"]

_ALIASES = {
    "musicgen-medium": "musicgen_medium",
    "mamba2-130m": "mamba2_130m",
    "qwen1.5-4b": "qwen1_5_4b",
    "gemma-7b": "gemma_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "hymba-1.5b": "hymba_1_5b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "starcoder2-7b": "starcoder2_7b",
    "gwtf-llama-300m": "gwtf_llama_300m",
    "gwtf-gpt-300m": "gwtf_gpt_300m",
    "gwtf-llama-7b": "gwtf_llama_7b",
    "moonlight-16b-a3b": "moonlight_16b_a3b",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS and mod_name not in PORT_ONLY_IDS:
        raise KeyError(f"unknown arch {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
