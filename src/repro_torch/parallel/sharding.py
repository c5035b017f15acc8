"""Logical-axis sharding rules (MaxText-style) for the production mesh.

Port of ``repro.parallel.sharding`` onto DTensor.  Model code annotates
tensors with *logical* axis names via ``shard(x, "batch", None, "tp")``;
the active :class:`ShardingRules` maps logical names to physical mesh
axes.  With no active rules, or when ``x`` is a plain tensor (every
serving and training path of one card), each annotation returns ``x``
untouched, so the model code runs unchanged.

A layout is written as the JAX package writes it: a
:class:`PartitionSpec`, one entry per tensor dim, each ``None``, a mesh
axis name or a tuple of names, so that a spec compares with JAX's
directly.  ``placements`` turns it into DTensor placements, one per mesh
dim: a tensor dim over several mesh axes shards over them in mesh-dim
order, which is the tuple's order only when the tuple follows the mesh
(``("pod", "data")`` does); any other order is refused.

Where an annotation is active and ``x`` is a DTensor, ``shard``
redistributes it to the spec, dropping mesh axes that do not divide the
dim as the JAX package does (DTensor would shard unevenly instead);
``shard_heads`` alone allows an uneven head count.

Physical axes of the production mesh (see launch/mesh.py):
  * ``pod``   — outer data-parallel axis across pods (multi-pod only)
  * ``data``  — data parallel + FSDP (params/optimizer sharded here)
  * ``model`` — tensor parallel (d_ff, flattened head dims, vocab)
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree
from torch.utils._pytree import tree_map_only

from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.tree import tree_map, tree_map_with_path

AxisName = Union[str, Tuple[str, ...], None]

_state = threading.local()


@dataclass(frozen=True)
class ShardingRules:
    """Logical -> physical axis mapping."""
    batch: AxisName = ("pod", "data")
    fsdp: AxisName = "data"          # parameter / optimizer-state sharding
    tp: AxisName = "model"           # tensor parallel
    seq: AxisName = None             # sequence (context) parallel — off by default
    expert: AxisName = None          # expert parallel — off by default (tp shards d_ff)

    def resolve(self, logical: AxisName) -> AxisName:
        if logical is None:
            return None
        if isinstance(logical, tuple):
            parts = []
            for l in logical:
                r = self.resolve(l)
                if r is None:
                    continue
                parts.extend(r if isinstance(r, tuple) else (r,))
            return tuple(parts) if parts else None
        return getattr(self, logical)


class PartitionSpec:
    """A layout in the JAX package's terms: one entry per tensor dim
    (``None``, an axis name or a tuple of names).  A leaf of a spec tree
    (not a tuple, which ``tree`` would walk into); equal to another spec
    or a tuple with the same entries."""
    __slots__ = ("axes",)

    def __init__(self, *axes: AxisName):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other.axes
        return isinstance(other, tuple) and self.axes == other

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.axes!r}"


P = PartitionSpec


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules], mesh=None):
    prev = getattr(_state, "rules", None), getattr(_state, "mesh", None)
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def active_rules():
    return getattr(_state, "rules", None)


def active_mesh():
    return getattr(_state, "mesh", None)


def logical_spec(*logical_axes: AxisName) -> Optional[P]:
    rules = active_rules()
    if rules is None:
        return None
    return P(*(rules.resolve(a) for a in logical_axes))


def _names(axis: AxisName) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that a tensor dim ``d`` names, ``Replicate()`` on the others."""
    order = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in order]
    for d, axis in enumerate(spec):
        names = _names(axis)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} shards over {names}, not in "
                             f"the mesh's order {tuple(order)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def _constrain(x, spec: P):
    """``x`` redistributed to ``spec`` on its own mesh: the counterpart of
    ``jax.lax.with_sharding_constraint``.  A plain tensor passes through."""
    if not isinstance(x, DTensor):
        return x
    want = placements(spec, x.device_mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def split_last(x, n: int):
    """``x`` with its last dim split into ``(n, last // n)``.  A DTensor
    whose last dim is sharded over mesh axes that do not divide ``n`` is
    replicated along them first, so that no dim is sharded unevenly (a
    view of such a dim is refused or mis-laid by DTensor, where GSPMD
    reshards the dim)."""
    if isinstance(x, DTensor):
        d, over = x.ndim - 1, 1
        for size, pl in zip(x.device_mesh.shape, x.placements):
            over *= size if pl.is_shard(d) else 1
        if n % over:
            x = x.redistribute(x.device_mesh, [
                Replicate() if pl.is_shard(d) else pl for pl in x.placements])
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def merge_last(x):
    """``x`` with its last two dims merged.  A DTensor sharded on the inner
    of the two is replicated along it first: the merged dim would be
    sharded with a stride, which one torch version refuses and another
    carries into slow redistribution plans."""
    if isinstance(x, DTensor) and any(pl.is_shard(x.ndim - 1)
                                      for pl in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if pl.is_shard(x.ndim - 1) else pl
            for pl in x.placements])
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def dot_last(a, b):
    """``torch.einsum("bhpn,bn->bhp", a, b)``; on DTensors a product and a
    sum over n, which keeps a's layout (the einsum flattens (h, p) for a
    batched product and shards the merged dim with a stride), and which
    the trace counts as no dot FLOPs."""
    if isinstance(a, DTensor):
        return (a * b[:, None, None, :]).sum(-1)
    return torch.einsum("bhpn,bn->bhp", a, b)


def gather_last(x, index):
    """``x.gather(-1, index[..., None])[..., 0]``.  On a DTensor, a masked
    sum over the last dim instead (a vocab-parallel cross-entropy's gold
    logit: a partial sum over the model axis, then an all-reduce of one
    value a row): DTensor's gather over a sharded dim fails.  The value is
    the same, one term and zeros."""
    if not isinstance(x, DTensor):
        return x.gather(-1, index[..., None].long())[..., 0]
    ids = torch.arange(x.shape[-1], device=index.device)
    return torch.where(ids == index[..., None], x, 0.0).sum(-1)


def replicated(x):
    """``x`` replicated over its mesh (a plain tensor as it is)."""
    if not isinstance(x, DTensor) or all(p.is_replicate() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _keep_dim0(x):
    """``x`` with only its placements on dim 0 (the batch) kept."""
    return x.redistribute(x.device_mesh, [
        p if p.is_shard(0) else Replicate() for p in x.placements])


def _locally(func, args, kwargs):
    """``func`` on the local tensors of its replicated DTensor inputs (made
    contiguous: a gathered shard may be a narrowed view of a padded
    buffer), the results replicated DTensors: any op, each device
    computing all of it."""
    mesh = next(x.device_mesh for x in pytree.tree_leaves((args, kwargs))
                if isinstance(x, DTensor))
    local = lambda x: replicated(x).to_local().contiguous()  # noqa: E731
    out = func(*tree_map_only(DTensor, local, args),
               **tree_map_only(DTensor, local, kwargs))
    return tree_map_only(torch.Tensor, lambda t: DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False), out)


# op name -> how many times ReplicateOnFailure retried it
FALLBACKS: Counter = Counter()


class ReplicateOnFailure(TorchDispatchMode):
    """Runs each op on DTensors as DTensor lays it out; where DTensor
    refuses it (no sharding strategy, a view it cannot take on that
    layout, a redistribution it cannot plan), runs it again on
    redistributed inputs: first on their dim-0 (batch) shards alone, then
    fully replicated, then, for an op DTensor has no strategy for at all,
    on the replicated inputs' local tensors.  GSPMD would reshard there
    too; the collectives a retry adds are counted like any other.  A
    mutated input (an in-place op's target) is never redistributed.
    ``FALLBACKS`` counts the ops retried, by name: what DTensor refuses
    differs between torch versions."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except Exception as first:       # noqa: BLE001 — retried below
            if not any(issubclass(t, DTensor) for t in types):
                raise
            names = [a.name for a in func._schema.arguments]
            written = {a.name for a in func._schema.arguments
                       if a.alias_info is not None and a.alias_info.is_write}

            def moved(step):
                def move(x):
                    return step(x) if isinstance(x, DTensor) else x
                a2 = [x if i < len(names) and names[i] in written
                      else tree_map_only(DTensor, move, x)
                      for i, x in enumerate(args)]
                k2 = {k: v if k in written else tree_map_only(DTensor, move, v)
                      for k, v in kwargs.items()}
                return a2, k2

            for step in (_keep_dim0, replicated, None):
                if step is None and written:
                    break
                try:
                    if step is None:
                        out = _locally(func, args, kwargs)
                    else:
                        a2, k2 = moved(step)
                        out = func(*a2, **k2)
                except Exception as e:   # noqa: BLE001 — the next attempt
                    first.add_note(f"retry: {type(e).__name__}: {e}"[:500])
                    continue
                FALLBACKS[str(func.overloadpacket)] += 1
                return out
            raise first


def shard(x, *logical_axes: AxisName):
    """Annotate ``x`` with a sharding constraint; no-op without rules.

    Drops mesh axes that do not divide the dimension (keeps lowering
    robust for reduced smoke configs)."""
    rules = active_rules()
    mesh = active_mesh()
    if rules is None or mesh is None or not isinstance(x, DTensor):
        return x
    sizes = mesh_axis_sizes(mesh)
    resolved = []
    for dim, a in zip(x.shape, logical_axes):
        r = rules.resolve(a)
        if r is None:
            resolved.append(None)
            continue
        axes = tuple(ax for ax in _names(r) if ax in sizes)
        total = 1
        for ax in axes:
            total *= sizes[ax]
        if not axes or total <= 1 or dim % total != 0:
            resolved.append(None)
        elif len(axes) == 1:
            resolved.append(axes[0])
        else:
            resolved.append(axes)
    return _constrain(x, P(*resolved))


# ---------------------------------------------------------------------------
# Parameter partition specs
# ---------------------------------------------------------------------------

# rules keyed by parameter leaf name -> spec over the *trailing* dims.
_PARAM_RULES = {
    # attention
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    # dense mlp / shared expert
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp"),
    # mamba
    "in_proj": ("fsdp", "tp"), "out_proj": ("tp", "fsdp"),
    "conv_w": (None, "tp"), "conv_b": ("tp",),
    "A_log": (None,), "D": (None,), "dt_bias": (None,), "norm_scale": (None,),
    # moe (3-D expert-stacked) — handled by ndim below
    "router": ("fsdp", None),
    # embeddings
    "table": ("tp", "fsdp"),
    "lm_head": ("fsdp", "tp"),
    # vision projector
    "w_proj": (None, "fsdp"),
    # norms
    "scale": (None,), "bias": (None,),
}

_MOE_RULES = {
    "w_gate": ("expert", "fsdp", "tp"), "w_up": ("expert", "fsdp", "tp"),
    "w_down": ("expert", "tp", "fsdp"),
}


def param_spec_tree(params, rules: ShardingRules, mesh):
    """Build a PartitionSpec tree for a params tree (the stacked layout of
    ``transformer.stack_params``, JAX's leaf names).

    Leaves are matched by name; leading stacking dims (layer scan) get
    ``None``.  Mesh axes that do not divide a dim are dropped.
    """
    sizes = mesh_axis_sizes(mesh)

    def present(axis):
        axes = tuple(ax for ax in _names(axis) if ax in sizes)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes

    def divides(axis, dim):
        total = 1
        for ax in _names(axis):
            total *= sizes.get(ax, 1)
        return dim % total == 0

    def spec_for(path, leaf):
        name = None
        moe = False
        for key in path:
            if key in ("w_gate", "w_up", "w_down") and leaf.ndim >= 3:
                moe = "shared" not in path
            if key in _PARAM_RULES or key in _MOE_RULES:
                name = key
        if name is None:
            return P()
        rule = _MOE_RULES[name] if (moe and name in _MOE_RULES) else _PARAM_RULES[name]
        ndim = leaf.ndim
        trailing = len(rule)
        spec = [None] * (ndim - trailing)
        for dim, logical in zip(leaf.shape[ndim - trailing:], rule):
            r = rules.resolve(logical)
            r = present(r) if r is not None else None
            if r is not None and divides(r, dim):
                spec.append(r)
            else:
                spec.append(None)
        return P(*spec)

    return tree_map_with_path(spec_for, params)


def shard_heads(x, head_dim_index: int):
    """Shard the heads dim over the tp axis, allowing uneven head counts
    (DTensor's ``Shard`` pads as GSPMD does).  Used for train/prefill
    attention where K/V stay replicated (GQA K/V are small) so Q.K^T needs
    no partial-sum all-reduce — the alternative (sharding head_dim) turns
    every score tensor into a giant all-reduce."""
    rules = active_rules()
    mesh = active_mesh()
    if rules is None or mesh is None or not isinstance(x, DTensor):
        return x
    sizes = mesh_axis_sizes(mesh)
    r = rules.resolve("tp")
    if r is None:
        return x
    axes = tuple(ax for ax in _names(r) if ax in sizes)
    if not axes:
        return x
    spec = [None] * x.ndim
    spec[head_dim_index] = axes[0] if len(axes) == 1 else axes
    return _constrain(x, P(*spec))


def tp_size() -> int:
    """Size of the resolved tp axes on the active mesh (1 if none)."""
    rules = active_rules()
    mesh = active_mesh()
    if rules is None or mesh is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    r = rules.resolve("tp")
    if r is None:
        return 1
    total = 1
    for ax in _names(r):
        total *= sizes.get(ax, 1)
    return total


# ---------------------------------------------------------------------------
# Trees of tensors laid out by trees of specs
# ---------------------------------------------------------------------------

def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shard of ``shape`` one device holds under ``spec`` (every named
    axis divides its dim, as the spec functions here guarantee)."""
    sizes = mesh_axis_sizes(mesh)
    out = list(shape)
    for d, axis in enumerate(spec):
        for name in _names(axis):
            if out[d] % sizes[name]:
                raise ValueError(f"{name} ({sizes[name]}) does not divide dim "
                                 f"{d} of {tuple(shape)} under {spec}")
            out[d] //= sizes[name]
    return tuple(out)


def distribute(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` laid out by the
    matching spec of ``specs``.

    A tensor on the ``meta`` device (``specs.abstract_params``, the
    ``input_specs``) becomes a shard of zeros of its local shape on the
    mesh's device type, which under ``FakeTensorMode`` allocates nothing;
    any other tensor is split with ``distribute_tensor``, each rank keeping
    its own shard of the tensor it holds (no communication)."""
    def one(t, spec):
        pl = placements(spec, mesh)
        if t.device.type != "meta":
            return distribute_tensor(t, mesh, pl, src_data_rank=None)
        local = torch.zeros(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device=mesh.device_type)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=_contiguous(t.shape))
    return tree_map(one, tree, specs)


def _contiguous(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))
