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
* ``retried``           — the ops ``sharding.ReplicateOnFailure`` ran on
  redistributed inputs, by name;
* ``global_flops``      — ``FlopCounterMode`` over the same step, which
  sees the DTensor-level ops at their global shapes; with every dot
  sharded it equals ``dot_flops`` times the devices, and it is less by
  whatever a device repeats (a replicated product).

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

Where the port departs from GSPMD's layouts, the collectives differ from
the JAX package's, and ``retried`` and the dry run's record name the ops:

* ops DTensor refuses (``sharding.ReplicateOnFailure`` runs them on
  redistributed inputs).  Torch 2.11 refuses views
  that merge a sharded dim into another (``aten.view``,
  ``aten._unsafe_view``: the training backward's head merges; inside
  ``aten.einsum`` and ``aten.matmul``: attention with sharded heads, a
  projection of the sequence-sharded residual) and has no strategy for
  ``aten.flip`` (the SSD scan's backward); torch 2.13 refuses fewer;
* the embedding lookup's tokens, replicated before indexing the
  vocab-sharded table (``layers.embed_tokens``);
* a head count the model axis does not divide, replicated before the
  heads are split (``sharding.split_last``), and a merge whose inner dim
  is sharded (``sharding.merge_last``);
* the cross-entropy's gold logit as a masked sum over the sharded vocab
  (``sharding.gather_last``), and the SSM decode's state contraction as
  a product and a sum (``sharding.dot_last``, no dot FLOPs).
"""
from __future__ import annotations

from collections import Counter
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

from repro_torch.parallel.sharding import FALLBACKS

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
    retried: Dict[str, int] = field(default_factory=dict)

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


def analyze_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` twice, the second time traced, and count
    its per-device costs: ``(result, StepCosts)``.  The first run caches
    DTensor's sharding propagation, so that the traced run allocates none
    of its global-shape tensors, which ``MemTracker`` would count; ``fn``
    must bear running twice (a functional step, or one that rewrites the
    same cache slots)."""
    fn(*args, **kwargs)
    costs = StepCosts()
    before = Counter(FALLBACKS)
    memory = MemTracker()
    with memory, CommDebugMode() as comm, \
            _LocalCosts(costs, _shard_modes((args, kwargs))), \
            FlopCounterMode(display=False) as flops:
        out = fn(*args, **kwargs)
    costs.global_flops = float(flops.get_total_flops())
    # the devices' own memory: sharding propagation's shape inference on
    # the meta device (global shapes, no storage) is left out
    costs.temp_peak_bytes = max(
        (per_kind["Total"] for dev, per_kind in
         memory.get_tracker_snapshot("peak").items() if dev.type != "meta"),
        default=0)
    costs.comm_counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    costs.retried = dict(Counter(FALLBACKS) - before)
    return out, costs
