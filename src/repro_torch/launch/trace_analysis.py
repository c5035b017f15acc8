"""Per-device costs of one sharded step, read from an eager trace.

The counterpart of ``repro.launch.hlo_analysis``, which parses the HLO
text XLA compiles for a mesh.  The port has no compiled program: it runs
the step eagerly on DTensors (over fake tensors and a fake process group
in the dry run), once to fill DTensor's caches and once traced, and
counts what each device would do:

* ``dot_flops``         — FLOPs of the local matmuls, attention and
  convolutions of one device (``torch.utils.flop_counter``'s formulas
  over the shard shapes), the counterpart of the HLO's per-device
  ``2 * prod(result_dims) * contraction``;
* ``collective_bytes``  — per collective kind, under ``COLLECTIVES``'s
  names, the bytes of each collective's result on one device, as the HLO
  analysis counts result shapes;
* ``collective_count``;
* ``temp_peak_bytes``   — the peak of what the step allocates on one
  device (``MemTracker`` over the shards; its inputs not counted);
* ``global_flops``      — the FLOPs of the same step run unsharded, as
  one device would run it, over fake tensors of the global shapes
  (``count_flops``; the caller sets it): with every product sharded it
  equals ``dot_flops`` times the devices, and it is less by whatever the
  devices repeat (a replicated product, heads padded to the model axis).

How: a dispatch mode that declines (``NotImplemented``) every op on a
DTensor, as ``CommDebugMode`` does, so DTensor desugars it into local ops
and collectives on the shards, which then reach the mode; sharding
propagation's own shape inference (global shapes, on the meta device or
on fake tensors of another mode) is skipped.
``CommDebugMode`` runs beside it and its counts by op are kept.

Three fields of ``HLOCosts`` have no counterpart.  ``while_loops``: an
eager trace runs a Python loop (layers, KV chunks, microbatches)
iteration by iteration, so nothing is counted once for many trips.
``unparsed_dots``: every op comes with its shapes; nothing is parsed.
``f32_legalization_bytes``: XLA:CPU converts bf16 GEMM operands to f32
copies that no eager op makes.

The step's work is laid out by hand as GSPMD lays it out
(``sharding.project``, ``sharding.on_shards``); where DTensor refuses an
op of the step, the step raises (``sharding.NameRefusals``).  The
collectives still differ from the JAX package's where the port moves data
another way:

* heads the model axis does not divide, gathered before they are split
  and merged (``sharding.split_last``, ``sharding.merge_last``), where
  GSPMD reshards the padded layout;
* the cross-entropy's gold logit as a masked sum over the sharded vocab
  (``sharding.gather_last``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_c10d = torch.ops._c10d_functional
_KIND = {
    _c10d.all_gather_into_tensor: "all-gather",
    _c10d.all_gather_into_tensor_coalesced: "all-gather",
    _c10d.all_reduce: "all-reduce",
    _c10d.all_reduce_coalesced: "all-reduce",
    _c10d.reduce_scatter_tensor: "reduce-scatter",
    _c10d.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _c10d.all_to_all_single: "all-to-all",
    torch.ops._dtensor.shard_dim_alltoall: "all-to-all",
}


@dataclass
class StepCosts:
    dot_flops: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    collective_count: float = 0.0
    global_flops: float = 0.0
    temp_peak_bytes: int = 0
    comm_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def _shard_modes(tree) -> set:
    """The fake modes of the DTensor shards in ``tree`` (empty for real
    shards)."""
    return {t._local_tensor.fake_mode for t in pytree.tree_leaves(tree)
            if isinstance(t, DTensor) and isinstance(t._local_tensor, FakeTensor)}


def _foreign(args, modes: set) -> bool:
    """Whether an op runs on tensors that are no device's shards: sharding
    propagation infers output shapes by running the op at the global
    shapes, on the meta device or as fake tensors of a mode of its own
    (which, depends on the torch version)."""
    for a in pytree.tree_leaves(args):
        if isinstance(a, torch.Tensor):
            if a.device.type == "meta":
                return True
            if modes and isinstance(a, FakeTensor) and a.fake_mode not in modes:
                return True
    return False


class _LocalCosts(TorchDispatchMode):
    """Counts the ops DTensor runs on one device's shards."""

    def __init__(self, costs: StepCosts, modes: set):
        super().__init__()
        self.costs, self.modes = costs, modes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if (func._overloadpacket not in flop_registry
                and func is not torch.ops.prim.device.default):
            # a composite (``matmul``, ``einsum`` under inference mode)
            # reaches the mode whole: count its decomposition, as
            # ``FlopCounterMode`` does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if (isinstance(func, torch._ops.HigherOrderOperator)
                or _foreign((args, kwargs), self.modes)):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.costs.dot_flops += flop_registry[packet](*args, **kwargs,
                                                          out_val=out)
        kind = _KIND.get(packet)
        if kind is not None:
            self.costs.collective_bytes[kind] += _nbytes(out)
            self.costs.collective_count += 1
        return out


def _per_device(snapshot) -> Dict:
    return {dev: per_kind["Total"] for dev, per_kind in snapshot.items()
            if dev.type != "meta"}


def analyze_step(fn, *args, inputs=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` twice, the second time traced, and count
    its per-device costs: ``(result, StepCosts)``.  The first run caches
    DTensor's sharding propagation, so that the traced run allocates none
    of its global-shape tensors, which ``MemTracker`` would count; ``fn``
    must bear running twice (a functional step, or one that rewrites the
    same cache slots).  ``inputs`` (default: the arguments) holds every
    tensor the step is given, a model's parameters among them: their
    shards are tracked from the start and left out of the step's peak
    (``MemTracker`` would count a storage the first time the step takes a
    view of it, a layer's slice of a stacked cache or weight)."""
    fn(*args, **kwargs)
    costs = StepCosts()
    memory = MemTracker()
    shards = [t._local_tensor if isinstance(t, DTensor) else t
              for t in pytree.tree_leaves((args, kwargs) if inputs is None
                                          else inputs)
              if isinstance(t, torch.Tensor) and t.device.type != "meta"]
    memory.track_external(*shards)
    with memory, CommDebugMode() as comm, \
            _LocalCosts(costs, _shard_modes((args, kwargs))):
        given = _per_device(memory.get_tracker_snapshot("current"))
        out = fn(*args, **kwargs)
    # the devices' own memory: sharding propagation's shape inference on
    # the meta device (global shapes, no storage) is left out
    peak = _per_device(memory.get_tracker_snapshot("peak"))
    costs.temp_peak_bytes = max((peak[d] - given.get(d, 0) for d in peak),
                                default=0)
    costs.comm_counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    return out, costs


def count_flops(fn, *args, **kwargs) -> float:
    """The FLOPs ``FlopCounterMode`` counts in ``fn(*args, **kwargs)``, run
    under the fake mode of its fake tensor inputs, so that what it
    allocates is fake too (a step unsharded at its global shapes)."""
    modes = {t.fake_mode for t in pytree.tree_leaves((args, kwargs))
             if isinstance(t, FakeTensor)}
    fake = modes.pop() if modes else contextlib.nullcontext()
    with fake, FlopCounterMode(display=False) as flops:
        fn(*args, **kwargs)
    return float(flops.get_total_flops())
