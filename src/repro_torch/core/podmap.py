"""GWTF on the pod: flow-routed pipeline-stage placement over slices.

Port of ``repro.core.podmap``, on the port's copy of ``GWTFProtocol`` and
the H100's constants from ``launch/mesh.py``.  The paper's core insight —
route microbatches as a min-cost flow and repair flows instead of
pipelines — applied to a production pod of 16 x 16 cards, carved into
slices (sub-grids); each slice is a GWTF "relay node" whose

* capacity      = microbatches in flight (HBM-bounded),
* compute cost  = stage FLOPs / slice peak FLOPs,
* link cost     = activation bytes / link bandwidth x hop distance
                  (2D-torus Manhattan distance between slice centers, the
                  JAX package's model of the pod's interconnect).

Cards do not churn like volunteers, but slices DO leave in practice —
preemptions, maintenance events, failed hosts — so the same
GWTFProtocol + repair machinery schedules pipelines across slices and
re-routes around a lost slice without recomputing whole pipelines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.flow.decentralized import GWTFProtocol
from repro_torch.core.flow.graph import FlowNetwork, Node
from repro_torch.launch.mesh import LINK_BW, PEAK_FLOPS_BF16


@dataclass(frozen=True)
class Slice:
    """A rectangular sub-grid of cards on the pod's 2D torus."""
    id: int
    origin: Tuple[int, int]       # (x, y) on the chip grid
    shape: Tuple[int, int]        # cards (dx, dy)

    @property
    def chips(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def center(self) -> Tuple[float, float]:
        return (self.origin[0] + self.shape[0] / 2,
                self.origin[1] + self.shape[1] / 2)


def carve_pod(pod_shape: Tuple[int, int] = (16, 16),
              slice_shape: Tuple[int, int] = (4, 4)) -> List[Slice]:
    """Tile the pod into equal slices (e.g. 16 slices of 4x4 cards)."""
    sx, sy = slice_shape
    px, py = pod_shape
    slices = []
    sid = 0
    for x in range(0, px, sx):
        for y in range(0, py, sy):
            slices.append(Slice(sid, (x, y), slice_shape))
            sid += 1
    return slices


def ici_hop_distance(a: Slice, b: Slice, pod_shape=(16, 16)) -> float:
    """Torus Manhattan distance between slice centers (link hops)."""
    dx = abs(a.center[0] - b.center[0])
    dy = abs(a.center[1] - b.center[1])
    dx = min(dx, pod_shape[0] - dx)
    dy = min(dy, pod_shape[1] - dy)
    return max(1.0, dx + dy)


def pod_flow_network(cfg, *, num_stages: int, microbatch_tokens: int,
                     pod_shape=(16, 16), slice_shape=(4, 4),
                     inflight_per_slice: int = 2,
                     data_slices: int = 1) -> FlowNetwork:
    """Build a FlowNetwork whose nodes are pod slices.

    cfg: a ModelConfig — stage compute/activation sizes derive from it.
    """
    slices = carve_pod(pod_shape, slice_shape)
    n_relays = len(slices) - data_slices
    per_stage = n_relays // num_stages

    params_per_stage = cfg.param_count() / num_stages
    stage_flops = 2 * params_per_stage * microbatch_tokens     # fwd
    act_bytes = microbatch_tokens * cfg.d_model * 2

    nodes = {}
    nid = 0
    for _ in range(data_slices):
        nodes[nid] = Node(nid, -1, 8, 0.0, is_data=True)
        nid += 1
    stage = 0
    count = 0
    for s in slices[data_slices:]:
        if count >= per_stage and stage < num_stages - 1:
            stage += 1
            count = 0
        compute_s = stage_flops / (s.chips * PEAK_FLOPS_BF16)
        nodes[nid] = Node(nid, stage, inflight_per_slice, compute_s)
        nid += 1
        count += 1

    N = nid
    lat = np.zeros((N, N))
    bw = np.full((N, N), LINK_BW)
    for i in range(N):
        for j in range(N):
            if i == j:
                continue
            si = slices[i] if i < len(slices) else slices[-1]
            sj = slices[j] if j < len(slices) else slices[-1]
            hops = ici_hop_distance(si, sj, pod_shape)
            lat[i, j] = hops * 1e-6            # ~1us per hop
            bw[i, j] = LINK_BW / hops          # store-and-forward per hop
    return FlowNetwork(nodes=nodes, num_stages=num_stages,
                       latency=lat, bandwidth=bw,
                       activation_size=act_bytes)


def schedule_pipelines(cfg, *, num_stages: int = 5,
                       microbatch_tokens: int = 4 * 4096,
                       pod_shape=(16, 16), slice_shape=(4, 4),
                       seed: int = 0) -> Tuple[GWTFProtocol, FlowNetwork]:
    """Run GWTF's decentralized flow construction over the pod slices.

    Returns the converged protocol (complete_flows() = pipeline routes)
    and the network (for repair on slice loss)."""
    net = pod_flow_network(cfg, num_stages=num_stages,
                           microbatch_tokens=microbatch_tokens,
                           pod_shape=pod_shape, slice_shape=slice_shape)
    proto = GWTFProtocol(net, rng=np.random.default_rng(seed))
    proto.run(max_rounds=200)
    return proto, net


def lose_slice(proto: GWTFProtocol, net: FlowNetwork, slice_id: int):
    """A slice is preempted: remove + repair (the paper's crash path)."""
    if net.nodes[slice_id].is_data:
        raise ValueError("data slice loss is unrecoverable (paper Sec. VII-b)")
    net.nodes[slice_id].alive = False
    proto.remove_node(slice_id)
    proto.reclaim_sink_slots()
    proto.run(max_rounds=80)
    return proto.complete_flows()
