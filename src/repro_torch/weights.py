"""Load the JAX package's parameters into the port.

``params_from_jax`` (serving) takes the JAX params as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``): ``embed/...``, ``final_norm/...``
and the stacked blocks at ``blocks/<name>/<leaf>`` with a leading layer
axis.  It unstacks the blocks into the port's ``Transformer``.  bf16,
which numpy holds as ``ml_dtypes.bfloat16`` or as its uint16 bits, becomes
``torch.bfloat16`` bit for bit.

``initial_params_from_jax`` (training) takes the staged runtime's
``repro.core.runtime.cache.initial_params(cfg, stages, seed)`` as numpy
and keeps its layout: one tree per stage with the stage's blocks stacked
along a leading axis, and the data-node head.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.runtime.stages import stage_bounds
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.tree import leaves, tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device="cuda") -> Transformer:
    dev = resolve_device(device)
    blocks = tree["blocks"]
    for name, sub in blocks.items():
        for leaf, arr in sub.items():
            if np.shape(arr)[0] != cfg.num_layers:
                raise ValueError(f"blocks/{name}/{leaf} has shape "
                                 f"{np.shape(arr)}, want a leading axis of "
                                 f"{cfg.num_layers} layers")
    per_layer = [{name: {leaf: _to_tensor(np.asarray(arr)[i], dev)
                         for leaf, arr in sub.items()}
                  for name, sub in blocks.items()}
                 for i in range(cfg.num_layers)]
    params = {"embed": {k: _to_tensor(a, dev) for k, a in tree["embed"].items()},
              "final_norm": {k: _to_tensor(a, dev)
                             for k, a in tree["final_norm"].items()},
              "blocks": per_layer}
    return Transformer(cfg, params)


def initial_params_from_jax(cfg: ModelConfig, params, device="cuda"):
    """``(stage_trees, head)`` as torch trees from the JAX package's
    ``(stage_param_trees, head_params)`` given as numpy; each stage tree's
    leading axis must hold that stage's blocks."""
    dev = resolve_device(device)
    stage_p, head_p = params
    for s, tree in enumerate(stage_p):
        lo, hi = stage_bounds(cfg, s, len(stage_p))
        for a in leaves(tree):
            if np.shape(a)[0] != hi - lo:
                raise ValueError(f"stage {s} leaf of shape {np.shape(a)}, "
                                 f"want a leading axis of {hi - lo} blocks")
    to_t = lambda a: _to_tensor(a, dev)  # noqa: E731
    return (tuple(tree_map(to_t, tree) for tree in stage_p),
            tree_map(to_t, head_p))
