"""Membership: simulated DHT peer discovery + leader election.

The paper uses a Kademlia-style DHT [16] for discovery and a robust
election among data nodes [17], [18].  Networking is simulated: the DHT
is a key->contact registry with per-lookup hop costs; elections follow the
bully algorithm over data nodes (lowest alive id wins), which is what
Garcia-Molina-style elections reduce to under crash faults.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np


@dataclass
class Contact:
    node_id: int
    stage: int
    capacity: int
    is_data: bool = False
    alive: bool = True


class DHT:
    """Simulated Kademlia registry.

    ``lookup`` charges O(log N) hop latency to model real DHT cost;
    the returned view can be truncated to model partial knowledge.
    """

    def __init__(self, rng: Optional[np.random.Generator] = None,
                 hop_latency: float = 0.05):
        self.registry: Dict[int, Contact] = {}
        self.rng = rng or np.random.default_rng(0)
        self.hop_latency = hop_latency
        self.lookup_time_total = 0.0

    def publish(self, c: Contact):
        self.registry[c.node_id] = c

    def unpublish(self, node_id: int):
        self.registry.pop(node_id, None)

    def lookup_stage(self, stage: int, k: Optional[int] = None) -> List[Contact]:
        hops = max(1, int(np.log2(max(2, len(self.registry)))))
        self.lookup_time_total += hops * self.hop_latency
        found = [c for c in self.registry.values()
                 if c.stage == stage and c.alive]
        if k is not None and len(found) > k:
            idx = self.rng.choice(len(found), size=k, replace=False)
            found = [found[i] for i in idx]
        return found

    def lookup_data_nodes(self) -> List[Contact]:
        hops = max(1, int(np.log2(max(2, len(self.registry)))))
        self.lookup_time_total += hops * self.hop_latency
        return [c for c in self.registry.values() if c.is_data and c.alive]


def elect_leader(dht: DHT) -> Optional[int]:
    """Bully election among alive data nodes: lowest id wins."""
    data = dht.lookup_data_nodes()
    if not data:
        return None
    return min(c.node_id for c in data)
