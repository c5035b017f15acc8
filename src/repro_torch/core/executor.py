"""Trainer facades over the staged real-compute runtime (Fig. 6).

Port of ``repro.core.executor``: the stable entry point for decentralized
training, over the layered :mod:`repro_torch.core.runtime` package
(``stages`` / ``activations`` / ``recovery`` / ``trainer``).

* :class:`DecentralizedTrainer` — GWTF training over a
  :class:`~repro_torch.core.flow.graph.FlowNetwork`, each stage forward
  one residual-capturing autograd pass, each backward from the stored
  residuals, mid-iteration crashes repaired stage-locally (paper
  Sec. V-D), churn from the fault layer and repairs from the routing
  policy of :mod:`repro_torch.core.sim`.
* :class:`CentralizedTrainer` — the no-decentralization baseline; at
  churn 0 the decentralized trajectory coincides with it bit for bit.
"""
from __future__ import annotations

from repro_torch.core.runtime.stages import (embed_fn, init_head_params,
                                             init_stage_params, loss_fn,
                                             stage_bounds, stage_forward)
from repro_torch.core.runtime.trainer import (CentralizedTrainer,
                                              IterationResult, RuntimeTrainer)


class DecentralizedTrainer(RuntimeTrainer):
    """GWTF training over a FlowNetwork with real torch compute.

    The constructor signature ``(cfg, net, *, churn, lr, seed, rng)`` of
    the JAX package's facade, plus every keyword of
    :class:`~repro_torch.core.runtime.trainer.RuntimeTrainer` (``device``
    among them).
    """


__all__ = [
    "CentralizedTrainer",
    "DecentralizedTrainer",
    "IterationResult",
    "RuntimeTrainer",
    "embed_fn",
    "init_head_params",
    "init_stage_params",
    "loss_fn",
    "stage_bounds",
    "stage_forward",
]
