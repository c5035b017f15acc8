"""Seeded weights, drawn on the device, one generator call a leaf.

A leaf is named by a key such as ``stage1/attn/wq``.  Its values come from
a ``torch.Generator`` on the leaf's device seeded by ``(seed, key)``, so the
program and the plain reference get the same tensor from the same seed,
and any leaf can be drawn again alone.  The scale follows the leaf's last
name: a norm's ``scale`` is 1 + 0.1 n, a ``bias`` and the ``bq``/``bk``/
``bv`` projections' biases 0.02 n, the embedding ``table`` 0.02 n, and any
other leaf a matrix (..., fan_in, fan_out) at fan_in^-1/2, as the port's
own initialiser scales it.  Norms and biases are drawn away from 1 and 0
so that a path that drops them reads wrong.
"""
from __future__ import annotations

import hashlib
from typing import Dict

import torch

BIASES = ("bias", "bq", "bk", "bv")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def key_seed(seed: int, key: str) -> int:
    """A 63-bit generator seed from the run's seed and a name."""
    digest = hashlib.sha256(f"{seed}/{key}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, key: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key_seed(seed, key))


def draw(key: str, shape, dtype, seed: int, device) -> torch.Tensor:
    """The leaf ``key`` of the given shape, in ``dtype``, on ``device``."""
    name = key.rsplit("/", 1)[-1]
    x = torch.randn(tuple(shape), generator=generator(seed, key, device),
                    dtype=torch.float32, device=device)
    if name == "scale":
        x.mul_(0.1).add_(1.0)
    elif name in BIASES or name == "table":
        x.mul_(0.02)
    else:
        x.mul_(shape[-2] ** -0.5)
    return x.to(dtype)


def flat(tree, prefix: str) -> Dict[str, torch.Tensor]:
    """``{prefix/path: leaf}`` of a nested dict of tensors."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{name}"))
        else:
            out[f"{prefix}/{name}"] = v
    return out


def like(tree, prefix: str, seed: int, device=None):
    """A tree of the same structure, shapes and dtypes as ``tree``, every
    leaf drawn as ``prefix/path``."""
    out = {}
    for name, v in tree.items():
        key = f"{prefix}/{name}"
        out[name] = (like(v, key, seed, device) if isinstance(v, dict) else
                     draw(key, v.shape, v.dtype, seed, device or v.device))
    return out
