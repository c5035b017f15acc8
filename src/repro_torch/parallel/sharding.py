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
``on_shards`` alone shards heads unevenly, as GSPMD pads them.

Physical axes of the production mesh (see launch/mesh.py):
  * ``pod``   — outer data-parallel axis across pods (multi-pod only)
  * ``data``  — data parallel + FSDP (params/optimizer sharded here)
  * ``model`` — tensor parallel (d_ff, flattened head dims, vocab)
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.tree import tree_map, tree_map_with_path

AxisName = Union[str, Tuple[str, ...], None]


class _State:
    """The active rules and mesh, process-wide, not per thread as JAX's:
    the autograd engine runs a CUDA backward, and the recompute of a
    checkpointed layer in it, on a device thread of its own, which must lay
    out the layer as the forward did."""
    rules: Optional["ShardingRules"] = None
    mesh = None


_state = _State()


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
    prev = _state.rules, _state.mesh
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def active_rules():
    return _state.rules


def active_mesh():
    return _state.mesh


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


# ---------------------------------------------------------------------------
# Work laid out by hand: each device's share, computed on its local shards
# ---------------------------------------------------------------------------
#
# DTensor lays out an op by its own sharding strategies, which differ
# between torch versions: one refuses views that another takes (a merge of
# a sharded dim, the views inside ``einsum`` and ``matmul``), and where one
# has no strategy or takes a strided layout, the op runs on replicated
# inputs, each device computing all of it.  GSPMD lays each op out from
# the constraints around it.  So the ops that carry the step's work run on
# local shards under placements chosen here, as GSPMD chooses them: the
# projections (``project``), the splits and merges of heads
# (``split_last``, ``merge_last``) and each per-(batch, head) core
# (``on_shards``: attention, the SSD scan).  Their inputs are
# redistributed first and their outputs wrapped back as DTensors, both
# through autograd, so the backward runs each product in the forward's
# layout.  A plain tensor goes through each of them untouched.

def _dims_of(logical: str, mesh) -> Tuple[int, ...]:
    """The mesh dims the active rules give ``logical`` (``batch``, ``tp``)."""
    rules, names = active_rules(), list(mesh.mesh_dim_names)
    if rules is None:
        return ()
    return tuple(names.index(a) for a in _names(rules.resolve(logical))
                 if a in names)


def _global(local, mesh, pl, shape):
    """``local`` as the shard of a DTensor of ``shape`` under ``pl``."""
    shape = tuple(shape)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous(shape))


def tp_range(size: int) -> Tuple[int, int]:
    """``(offset, count)``: this rank's chunk of a dim of ``size`` (heads)
    sharded over the tp axes as DTensor's ``Shard`` lays it (chunks of
    ceil(size / shards), the last ones short or empty, where GSPMD pads
    every chunk to that size); all of it off a mesh."""
    mesh = active_mesh()
    if mesh is None or active_rules() is None:
        return 0, size
    tdims = _dims_of("tp", mesh)
    pl = [Shard(0) if i in tdims else Replicate() for i in range(mesh.ndim)]
    shape, offset = compute_local_shape_and_global_offset((size,), mesh, pl)
    return offset[0], shape[0]


def _unpartial(x):
    """``x`` with its partial sums reduced (a plain tensor as it is)."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return x


def _gather(x, dim: int):
    """``x`` replicated along the mesh dims that shard ``dim``."""
    if any(p.is_shard(dim) for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_shard(dim) else p for p in x.placements])
    return x


def _view(x, shape):
    """``x.reshape(shape)`` on each device's shard, the placements kept:
    the caller has made the sharded dims whole blocks of the new shape."""
    local = x.to_local().reshape(
        compute_local_shape_and_global_offset(shape, x.device_mesh,
                                              x.placements)[0])
    return _global(local, x.device_mesh, x.placements, shape)


def dim_shards(x, d: int) -> int:
    """How many shards dim ``d`` of ``x`` is split into (1: a plain
    tensor, or a dim no mesh dim shards)."""
    n = 1
    if isinstance(x, DTensor):
        for size, pl in zip(x.device_mesh.shape, x.placements):
            n *= size if pl.is_shard(d) else 1
    return n


def seq_blocks(x, k: int):
    """``x`` (B, S, ...) as (B, k, S / k, ...).  A DTensor whose dim 1 is
    sharded in ``k`` shards has each device's shard as one block, so that
    slicing a block's rows gathers nothing."""
    shape = (x.shape[0], k, x.shape[1] // k, *x.shape[2:])
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _view(x, shape)


def reshape(x, *shape):
    """``x.reshape(shape)`` where dim 0 (the batch) stays the outermost dim,
    merged with the dims after it or split from them.  A DTensor keeps dim
    0's sharding and has its other sharded dims gathered first."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    for d in range(1, x.ndim):
        x = _gather(x, d)
    return _view(x, shape)


def split_last(x, n: int):
    """``x`` with its last dim split into ``(n, last // n)``.  A DTensor
    sharded on its last dim keeps that sharding on the ``n`` dim where its
    shards divide ``n``, and is gathered first where they do not (heads
    the model axis does not divide)."""
    shape = (*x.shape[:-1], n, x.shape[-1] // n)
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    if n % dim_shards(x, x.ndim - 1):
        x = _gather(x, x.ndim - 1)
    return _view(x, shape)


def merge_last(x):
    """``x`` with its last two dims merged.  A DTensor sharded evenly on the
    outer of the two keeps that sharding on the merged dim; one sharded on
    the inner, or unevenly (padded heads), is gathered first."""
    shape = (*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    x = _gather(x, x.ndim - 1)
    if x.shape[-2] % dim_shards(x, x.ndim - 2):
        x = _gather(x, x.ndim - 2)
    return _view(x, shape)


def project(x, w):
    """``x @ w`` for ``x`` (..., K) and a 2-D weight ``w`` (K, N), laid out
    as GSPMD lays out a projection, mesh dim by mesh dim:

    * ``x`` sharded on its batch dim: the weight is gathered there (FSDP);
    * the weight sharded on N (column-parallel): ``x`` is gathered there
      (a sequence-sharded residual's all-gather), the output sharded on N;
    * the weight sharded on K (row-parallel): ``x`` sharded on K to match,
      the output a partial sum;
    * a replicated weight: ``x`` keeps a sharded leading dim (a sequence
      shard), else the product repeats on every device there, as GSPMD
      repeats it (a vocab the model axis does not divide in a decode's lm
      head; the VLM's vision projection, whose weight has no model-axis
      dim).

    Each device multiplies its shards; the gradients come back in the
    same layout (the weight's reduce-scattered over the batch axes)."""
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return x @ w
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    x, w = (_unpartial(t) if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in (x, w))
    n = x.ndim
    xs, ws, outs, gxs, gws = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        lead = px.is_shard() and px.dim < n - 1
        if lead and px.dim == 0:                     # batch: gather the weight
            row = (px, Replicate(), px, px, Partial())
        elif pw.is_shard(1):                         # column-parallel
            row = (Replicate(), pw, Shard(n - 1), Partial(), pw)
        elif pw.is_shard(0):                         # row-parallel
            row = (Shard(n - 1), pw, Partial(), Shard(n - 1), pw)
        elif lead:                                   # a sequence shard
            row = (px, Replicate(), px, px, Partial())
        else:
            row = (Replicate(),) * 5
        for acc, v in zip((xs, ws, outs, gxs, gws), row):
            acc.append(v)
    xl = x.redistribute(mesh, xs).to_local(grad_placements=gxs)
    wl = w.redistribute(mesh, ws).to_local(grad_placements=gws)
    return _global(xl @ wl, mesh, outs, (*x.shape[:-1], w.shape[1]))


def embed(table, tokens):
    """``table[tokens]``, the embedding lookup.  On DTensors a
    vocab-parallel lookup, as GSPMD lays out JAX's: the table gathered over
    the axes that shard its width (FSDP), each device looking up the
    tokens of its own vocab shard and zeroing the rest, the result a
    partial sum over the axes that shard the vocab; the tokens keep their
    batch shard."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tpl, kpl, outs, grads = [], [], [], []
    for pt, pk in zip(table.placements, tokens.placements):
        if pt.is_shard(0):                           # the vocab
            row = (pt, Replicate(), Partial(), pt)
        elif pk.is_shard(0):                         # the batch
            row = (Replicate(), pk, pk, Partial())
        else:
            row = (Replicate(),) * 4
        for acc, v in zip((tpl, kpl, outs, grads), row):
            acc.append(v)
    rows = table.redistribute(mesh, tpl).to_local(grad_placements=grads)
    ids = tokens.redistribute(mesh, kpl).to_local()
    (n, _), (v0, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, tpl)
    mine = (ids >= v0) & (ids < v0 + n)
    out = rows[torch.where(mine, ids - v0, 0)] * mine[..., None].to(rows.dtype)
    return _global(out, mesh, outs, (*tokens.shape, table.shape[1]))


def on_shards(fn, inputs, outputs):
    """``fn`` on each device's share of a computation that is independent
    along the batch dim and along one dim of each tensor (heads, or query
    rows) that the tp axes shard: ``fn(*locals)`` with the local shards,
    the results wrapped back as DTensors.

    ``inputs``: ``(value, tp_dim, batched)`` each.  A DTensor is laid out
    with its dim 0 sharded over the batch axes where any batched input is
    sharded there (``batched``: its dim 0 is the batch), and ``tp_dim``
    sharded over the tp axes (``None``: replicated there); anything else
    is passed as it is.  Where no batched input is sharded over a batch
    axis (a batch of 1), the computation repeats there, as in GSPMD.  ``outputs``: ``(global shape, tp_dim)`` for each
    tensor ``fn`` returns, laid out the same way.  The computation is
    sharded over the tp axes where any input or output names a ``tp_dim``;
    ``fn`` must then compute only its share: an input replicated over axes
    the computation is sharded over gets a gradient that is a partial sum
    there.  Without a DTensor among the inputs, ``fn(*values)``."""
    values = [v for v, *_ in inputs]
    tensors = [v for v in values if isinstance(v, DTensor)]
    if not tensors:
        return fn(*values)
    mesh = tensors[0].device_mesh
    bdims, tdims = _dims_of("batch", mesh), _dims_of("tp", mesh)
    sharded_b = {i for i in bdims for v, _, b in inputs
                 if b and isinstance(v, DTensor) and v.placements[i].is_shard(0)}
    sharded_t = bool(tdims) and (
        any(isinstance(v, DTensor) and t is not None for v, t, _ in inputs)
        or any(t is not None for _, t in outputs))

    def layout(tp_dim, batched, grad):
        pl = []
        for i in range(mesh.ndim):
            if i in sharded_b:
                pl.append(Shard(0) if batched else
                          (Partial() if grad else Replicate()))
            elif i in tdims and tp_dim is not None:
                pl.append(Shard(tp_dim))
            elif i in tdims and sharded_t and grad:
                pl.append(Partial())
            else:
                pl.append(Replicate())
        return pl

    local = []
    for v, tp_dim, batched in inputs:
        if isinstance(v, DTensor):
            v = _unpartial(v).redistribute(mesh, layout(tp_dim, batched, False))
            v = v.to_local(grad_placements=layout(tp_dim, batched, True))
        local.append(v)
    out = fn(*local)
    single = isinstance(out, torch.Tensor)
    outs = [_global(o, mesh, layout(tp_dim, True, False), shape)
            for o, (shape, tp_dim) in zip([out] if single else out, outputs)]
    return outs[0] if single else tuple(outs)


def locally(fn, x):
    """``fn(x)`` on each device's shard, ``x``'s layout kept: for an ``fn``
    that acts on each index of ``x``'s sharded dims alone and keeps its
    shape (RoPE on heads sharded over tp)."""
    if not isinstance(x, DTensor):
        return fn(x)
    return _global(fn(x.to_local()), x.device_mesh, x.placements, x.shape)


def gather_last(x, index):
    """``x.gather(-1, index[..., None])[..., 0]``.  On a DTensor, a masked
    sum over the last dim instead (a vocab-parallel cross-entropy's gold
    logit: a partial sum over the model axis, then an all-reduce of one
    value a row): DTensor's gather over a sharded dim fails.  The value is
    the same, one term and zeros."""
    if not isinstance(x, DTensor):
        return x.gather(-1, index[..., None].long())[..., 0]
    # the vocab ids laid out as x's last dim, so that the mask is built
    # on each device's vocab shard and nothing is gathered
    ids = distribute_tensor(
        torch.arange(x.shape[-1], device=x.to_local().device), x.device_mesh,
        [Shard(0) if p.is_shard(x.ndim - 1) else Replicate()
         for p in x.placements], src_data_rank=None)
    return torch.where(ids == index[..., None], x, 0.0).sum(-1)


def logsumexp_last(x):
    """``torch.logsumexp(x, dim=-1)``.  On a DTensor sharded on its last
    dim (a vocab-parallel cross-entropy), each device reduces its shard:
    an all-reduce of the max and one of the sum, one value a row, where
    DTensor's ``logsumexp`` gathers the whole last dim.  An unsharded last
    dim takes ``torch.logsumexp``, bit for bit."""
    if dim_shards(x, x.ndim - 1) == 1:
        return torch.logsumexp(x, dim=-1)
    m = x.detach().amax(dim=-1, keepdim=True)
    return (m + torch.exp(x - m).sum(dim=-1, keepdim=True).log())[..., 0]


def replicated(x):
    """``x`` replicated over its mesh (a plain tensor as it is)."""
    if not isinstance(x, DTensor) or all(p.is_replicate() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


class NameRefusals(TorchDispatchMode):
    """Runs each op as it is; where an op on DTensors fails (DTensor has
    no strategy for it, or cannot take a view on that layout), raises an
    error that names the op and its inputs' placements.  Nothing is
    retried: a refused op of a sharded step is a fault of the step's
    layout, not a reason to run the op on replicated inputs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except Exception as e:
            if not any(issubclass(t, DTensor) for t in types):
                raise
            layouts = [tuple(x.placements) for x in
                       pytree.tree_leaves((args, kwargs))
                       if isinstance(x, DTensor)]
            raise RuntimeError(f"DTensor refused {func} on placements "
                               f"{layouts}: {type(e).__name__}: {e}") from e


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
