"""The churn the training cells inject: the port's per-relay Bernoulli rule
(``core/sim/faults.py::BernoulliChurn``), copied here and run ahead of time
into a trace.

Each iteration every alive relay crashes with probability ``p`` at a
uniform moment of the iteration (it is dead from the next iteration on),
and every dead relay rejoins with probability ``p`` (it serves this
iteration).  Crash and rejoin have equal odds, so the stationary state has
half the relays alive, and the trace starts from it.

The trace's shape (which slot of which stage crashes or rejoins when) is
drawn from the cell's fixed ``trace_seed``; the run's ``--seed`` only
permutes the relays of each stage among the slots.  So every seed sees the
same number of live relays in each stage at each iteration, the same
arrivals in another order, and two seeds do the same work.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def stationary_trace(stages: List[List[int]], p: float, iterations: int,
                     trace_seed: int, seed: int
                     ) -> Tuple[List[int], List[tuple]]:
    """``(dead_at_start, events)`` over ``iterations`` iterations for the
    relay ids of each stage (none at ``p`` = 0: a calm swarm, all alive);
    events are ``(iteration, "crash", id, when)``
    and ``(iteration, "rejoin", id)``, as ``TraceChurn`` takes them."""
    if p == 0:
        return [], []
    rng = np.random.default_rng(trace_seed)
    slots = [(s, i) for s, ids in enumerate(stages) for i in range(len(ids))]
    alive = rng.uniform(size=len(slots)) < 0.5
    dead0 = [j for j in range(len(slots)) if not alive[j]]
    shape = []
    for it in range(iterations):
        for j in range(len(slots)):
            if alive[j]:
                if rng.uniform() < p:
                    shape.append((it, "crash", j, float(rng.uniform())))
                    alive[j] = False
            elif rng.uniform() < p:
                shape.append((it, "rejoin", j))
                alive[j] = True
    prng = np.random.default_rng(seed % (1 << 64))
    perm = [prng.permutation(len(ids)) for ids in stages]

    def relay(j: int) -> int:
        s, i = slots[j]
        return stages[s][perm[s][i]]

    return ([relay(j) for j in dead0],
            [(ev[0], ev[1], relay(ev[2]), *ev[3:]) for ev in shape])
