"""PyTorch/CUDA port of the GWTF reproduction (``repro`` is the JAX reference).

The port imports ``torch`` and never ``jax`` or anything of ``repro``;
where it needs a module of the JAX package it keeps its own copy.  Every
entry point runs on ``cuda`` unless the caller asks for the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; a missing GPU is an error.

    ``"cuda"`` is never quietly replaced by the CPU: only an explicit
    ``"cpu"`` runs there.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run on the CPU")
    return dev
