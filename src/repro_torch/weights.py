"""Load the JAX package's parameters into the port.

``params_from_jax`` (serving) takes the JAX params as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``): ``embed/...``, ``final_norm/...``
and the stacked blocks at ``blocks/<name>/<leaf>`` (and
``blocks/moe/shared/<leaf>``) with a leading layer axis; a VLM's
``self_blocks`` with two leading axes (superblock, layer),
``cross_blocks`` with one, and ``vision_proj``.  It unstacks the blocks
into the port's ``Transformer``.  bf16, which numpy holds as
``ml_dtypes.bfloat16`` or as its uint16 bits, becomes ``torch.bfloat16``
bit for bit.  ``params_to_jax`` is the inverse: the model's parameters
as numpy in JAX's stacked layout and names, bf16 as its uint16 bits.

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
from repro_torch.checkpoint.store import _to_numpy
from repro_torch.core.runtime.stages import stage_bounds
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, is_vlm,
                                            stack_params, superblocks)
from repro_torch.tree import leaves, tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _paths(tree: Dict[str, Any], prefix: str):
    """(path, array) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _layer(tree: Dict[str, Any], idx, dev) -> Dict[str, Any]:
    """Layer ``idx`` (an index or a tuple of them) of a stacked nested
    dict, as tensors on ``dev``."""
    return {k: _layer(v, idx, dev) if isinstance(v, dict)
            else _to_tensor(np.asarray(v)[idx], dev) for k, v in tree.items()}


def _check_lead(tree: Dict[str, Any], name: str, lead, what: str) -> None:
    """Every leaf of ``tree[name]`` has the leading axes ``lead``."""
    for path, arr in _paths(tree[name], name):
        if np.shape(arr)[:len(lead)] != lead:
            raise ValueError(f"{path} has shape {np.shape(arr)}, want the "
                             f"leading axes {lead} of {what}")


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device="cuda") -> Transformer:
    dev = resolve_device(device)
    to_t = lambda a: _to_tensor(a, dev)  # noqa: E731
    params = {"embed": tree_map(to_t, tree["embed"]),
              "final_norm": tree_map(to_t, tree["final_norm"])}
    if is_vlm(cfg):
        nb, k = superblocks(cfg)
        _check_lead(tree, "self_blocks", (nb, k - 1),
                    f"{nb} superblocks x {k - 1} self layers")
        _check_lead(tree, "cross_blocks", (nb,), f"{nb} cross layers")
        params["self_blocks"] = [[_layer(tree["self_blocks"], (i, j), dev)
                                  for j in range(k - 1)] for i in range(nb)]
        params["cross_blocks"] = [_layer(tree["cross_blocks"], i, dev)
                                  for i in range(nb)]
        params["vision_proj"] = tree_map(to_t, tree["vision_proj"])
    else:
        _check_lead(tree, "blocks", (cfg.num_layers,),
                    f"{cfg.num_layers} layers")
        params["blocks"] = [_layer(tree["blocks"], i, dev)
                            for i in range(cfg.num_layers)]
    return Transformer(cfg, params)


def params_to_jax(cfg: ModelConfig, model: Transformer) -> Dict[str, Any]:
    """The model's parameters as a numpy tree in the JAX package's stacked
    layout and names (``transformer.stack_params``), bf16 leaves as their
    uint16 bit patterns; ``params_from_jax`` takes it back."""
    return tree_map(lambda t: _to_numpy(t)[0], stack_params(cfg, model))


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
