"""The port's checkpoint store against the JAX package's npz format.

A bf16 stage tree with its AdamW state, written by one package and read
by the other, in both directions, comes back bit for bit (bf16 through
its uint16 bits); the port's own round trip, validation and atomic
writes behave as the JAX package's.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.checkpoint import store as jstore
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.checkpoint import store
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves, tree_map
from repro_torch.weights import _to_tensor


def _jax_stage_tree(seed=0):
    """Stacked stage-shaped params (bf16 matrices, an (L, D) f32 norm
    scale) and a non-trivial AdamW state."""
    rng = np.random.default_rng(seed)
    params = {"attn": {"wq": jnp.asarray(rng.standard_normal((2, 8, 16)),
                                         jnp.bfloat16)},
              "ln1": {"scale": jnp.asarray(rng.standard_normal((2, 16)),
                                           jnp.float32)}}
    opt = JAdamW(lr=1e-3)
    grads = jax.tree.map(lambda p: jnp.ones(p.shape, p.dtype), params)
    params, state = opt.update(grads, opt.init(params), params)
    return {"params": params, "opt": state}


def _to_torch(tree):
    return tree_map(lambda a: _to_tensor(np.asarray(a), "cpu"),
                    jax.tree.map(np.asarray, tree))


def _torch_template(tree):
    """The port's tree of the same structure, other values."""
    params = tree_map(torch.zeros_like, _to_torch(tree["params"]))
    return {"params": params, "opt": AdamW().init(params)}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same(torch_tree, jax_tree):
    tl, jl = leaves(torch_tree), jax.tree.leaves(jax_tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == np.shape(j)
        np.testing.assert_array_equal(_bits(t), _bits(j))


def test_jax_written_checkpoint_reads_in_the_port(tmp_path):
    tree = _jax_stage_tree()
    jstore.save_stage(str(tmp_path), 2, tree, step=9)
    got, step = store.restore_stage(str(tmp_path), 2, _torch_template(tree))
    assert step == 9
    assert got["params"]["attn"]["wq"].dtype == torch.bfloat16
    assert got["opt"].step.dtype == torch.int32
    _assert_same(got, tree)


def test_port_written_checkpoint_reads_in_jax(tmp_path):
    tree = _jax_stage_tree()
    ours = _to_torch(tree["params"])
    ours = {"params": ours, "opt": AdamW(lr=1e-3).update(
        tree_map(torch.ones_like, ours), AdamW().init(ours), ours)[1]}
    store.save_stage(str(tmp_path), 0, ours, step=4)
    got, step = jstore.restore_stage(str(tmp_path), 0, _jax_stage_tree(1))
    assert step == 4
    assert got["params"]["attn"]["wq"].dtype == jnp.bfloat16
    _assert_same(ours, got)
    with open(tmp_path / "stage_000.npz.json") as f:
        assert json.load(f)["num_leaves"] == len(leaves(ours))


def test_round_trip_and_validation(tmp_path):
    tree = _to_torch(_jax_stage_tree())
    path = str(tmp_path / "ck.npz")
    store.save(path, tree, step=3)
    got, step = store.restore(path, tree_map(torch.zeros_like, tree))
    assert step == 3
    for a, b in zip(leaves(got), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sorted(os.listdir(tmp_path)) == ["ck.npz", "ck.npz.json"]
    with pytest.raises(ValueError, match="structure mismatch"):
        store.restore(path, {"params": tree["params"]})
    wrong = tree_map(torch.zeros_like, tree)
    wrong["params"]["ln1"]["scale"] = torch.zeros(3, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        store.restore(path, wrong)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    sidecar["num_leaves"] = 99
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)
    with pytest.raises(ValueError, match="corrupt"):
        store.restore(path, tree)


def test_crashed_save_preserves_previous_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.npz")
    store.save(path, {"a": torch.zeros(3)}, step=1)

    def dying_savez(f, **kw):
        f.write(b"\x00" * 16)
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(RuntimeError, match="killed mid-write"):
        store.save(path, {"a": torch.ones(3)}, step=2)
    monkeypatch.undo()
    got, step = store.restore(path, {"a": torch.ones(3)})
    assert step == 1 and torch.equal(got["a"], torch.zeros(3))
    assert sorted(os.listdir(tmp_path)) == ["ck.npz", "ck.npz.json"]
