"""Checkpointing: pytree save/restore in the JAX package's npz format.

Port of ``repro.checkpoint.store``; a checkpoint written by either
package reads in the other.  The archive holds ``leaf_<i>`` entries in
``jax.tree.flatten`` order (``repro_torch.tree.flatten``: dict keys
sorted, ``AdamWState`` in field order), bf16 leaves as their uint16 bit
patterns with a ``bf16_<i>`` marker (npz cannot hold bf16), and
``__step``; a ``.json`` sidecar carries ``num_leaves``.  Per-stage
checkpoints let a stage replica bootstrap a joining node ("downloads the
weights of the stage it will serve", Sec. V-E).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """``(array, is_bf16)``; bf16 becomes its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), True
    return a, False


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Any, int]:
    leaves, spec = flatten(tree)
    flat = {}
    for i, leaf in enumerate(leaves):
        a, bf16 = _to_numpy(leaf)
        if bf16:
            flat[f"bf16_{i}"] = np.asarray(1)
        flat[f"leaf_{i}"] = a
    return flat, spec, len(leaves)


def _replace(tmp: str, final: str, mode: str, write) -> None:
    try:
        with open(tmp, mode) as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save(path: str, tree, step: int = 0, meta: dict | None = None):
    """Atomically write ``<path>.npz`` (+ ``.json`` sidecar).

    Both files go through a same-directory temp file + ``os.replace``, so
    a crash mid-save never leaves a truncated archive under the final
    name; the npz lands before the sidecar, and a stale sidecar over a
    new archive fails loudly in ``restore`` via the leaf-count check.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat, spec, num_leaves = _flatten(tree)
    flat["__step"] = np.asarray(step)
    npz_path = path if path.endswith(".npz") else path + ".npz"
    _replace(npz_path + ".tmp", npz_path, "wb", lambda f: np.savez(f, **flat))
    sidecar = {"treedef": repr(spec), "num_leaves": num_leaves, "step": step,
               **(meta or {})}
    _replace(npz_path + ".json.tmp", npz_path + ".json", "w",
             lambda f: json.dump(sidecar, f))


def _tensor(a: np.ndarray, bf16: bool, like: torch.Tensor) -> torch.Tensor:
    if bf16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dtype=like.dtype, device=like.device)


def restore(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors giving
    each leaf's shape, dtype and device).

    The stored leaf count is checked against the sidecar (when present)
    and the template before anything is unflattened, so a mismatch fails
    with a structural error instead of a silent mis-assignment.
    """
    npz_path = path if path.endswith(".npz") else path + ".npz"
    data = np.load(npz_path)
    leaves, spec = flatten(like)
    stored = sum(1 for k in data.files if k.startswith("leaf_"))
    if stored != len(leaves):
        raise ValueError(
            f"checkpoint {npz_path} holds {stored} leaves but the "
            f"restore template has {len(leaves)}: structure mismatch")
    sidecar_path = npz_path + ".json"
    if os.path.exists(sidecar_path):
        with open(sidecar_path) as f:
            declared = json.load(f).get("num_leaves")
        if declared is not None and declared != stored:
            raise ValueError(
                f"checkpoint {npz_path} is corrupt: sidecar declares "
                f"{declared} leaves, archive holds {stored}")
    loaded = []
    for i, want in enumerate(leaves):
        got = _tensor(data[f"leaf_{i}"], f"bf16_{i}" in data, want)
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch: {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
        loaded.append(got)
    step = int(data["__step"]) if "__step" in data else 0
    return unflatten(spec, loaded), step


def save_stage(dirpath: str, stage: int, params, step: int = 0):
    save(os.path.join(dirpath, f"stage_{stage:03d}.npz"), params, step=step)


def restore_stage(dirpath: str, stage: int, like):
    return restore(os.path.join(dirpath, f"stage_{stage:03d}.npz"), like)
