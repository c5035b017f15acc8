"""Load the JAX package's parameters into the port's model.

``params_from_jax`` takes the JAX params as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``): ``embed/...``, ``final_norm/...``
and the stacked blocks at ``blocks/<name>/<leaf>`` with a leading layer
axis.  It unstacks the blocks into the port's ``Transformer``.  bf16,
which numpy holds as ``ml_dtypes.bfloat16`` or as its uint16 bits, becomes
``torch.bfloat16`` bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


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
