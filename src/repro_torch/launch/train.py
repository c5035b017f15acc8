"""Training driver of the PyTorch port, on the GPU unless ``--device cpu``
is given.

Port of ``repro.launch.train``, with the same flags plus ``--device``.
``--mode gwtf`` is the paper's decentralized training: a FlowNetwork of
data/relay nodes, GWTF flow routing, churn, and per-stage replicas via
:class:`repro_torch.core.executor.DecentralizedTrainer`.  ``--mode spmd``
(single-program training on a device mesh) is not ported: see
ROADMAP.md, Queue 1 item 13.  Its flags ``--steps``, ``--log-every`` and
``--checkpoint`` are refused with the same pointer.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gwtf-llama-300m \
      --mode gwtf --stages 4 --iterations 50 --churn 0.1 --seq-len 512
  PYTHONPATH=src python -m repro_torch.launch.train --mode gwtf --reduced \
      --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.executor import DecentralizedTrainer, IterationResult
from repro_torch.core.flow.graph import geo_distributed_network
from repro_torch.data.pipeline import DataConfig, DataNodeShard


def build_gwtf(args) -> Tuple[DecentralizedTrainer, Dict[int, DataNodeShard]]:
    """The trainer over a seeded geo-distributed network, and one data
    shard per data node."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=max(args.stages, args.layers),
                          d_model=args.d_model)
    rng = np.random.default_rng(args.seed)
    caps = [args.capacity] * (args.stages * args.relays_per_stage)
    net = geo_distributed_network(
        num_stages=args.stages, relay_capacities=caps,
        num_data_nodes=args.data_nodes, data_capacity=args.microbatches,
        rng=rng)
    trainer = DecentralizedTrainer(cfg, net, churn=args.churn, lr=args.lr,
                                   seed=args.seed, device=args.device)
    shards = {d.id: DataNodeShard(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                   batch_size=args.microbatches * args.batch,
                   microbatch_size=args.batch, seed=args.seed + d.id),
        d.id, args.data_nodes) for d in net.data_nodes()}
    return trainer, shards


def train_iteration(trainer: DecentralizedTrainer,
                    shards: Dict[int, DataNodeShard]
                    ) -> Tuple[IterationResult, float, int]:
    """One iteration on fresh batches: ``(result, seconds, tokens)``, the
    seconds of ``trainer.iteration`` alone (the device synchronized on
    both sides) and the tokens of its completed microbatches."""
    batches = {dn: shards[dn].microbatches() for dn in shards}
    sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    r = trainer.iteration(batches)
    sync()
    dc = next(iter(shards.values())).cfg
    return r, time.perf_counter() - t0, r.completed * dc.microbatch_size * dc.seq_len


def run_gwtf(args) -> float:
    trainer, shards = build_gwtf(args)
    for it in range(args.iterations):
        r, secs, tokens = train_iteration(trainer, shards)
        print(f"iter {it:4d} loss {r.loss:.4f} "
              f"completed {r.completed}/{r.launched} dropped {r.dropped} "
              f"rerouted {r.rerouted} ({secs * 1e3:.1f} ms, "
              f"{tokens / secs:.0f} tok/s)")
    print(f"final loss {trainer.losses[-1]:.4f}")
    return trainer.losses[-1]


SPMD_ONLY = "--mode spmd only, which is not ported: refused"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gwtf-llama-300m")
    ap.add_argument("--mode", choices=("spmd", "gwtf"), default="gwtf")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=None, help=SPMD_ONLY)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--relays-per-stage", type=int, default=3)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--data-nodes", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--churn", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=None, help=SPMD_ONLY)
    ap.add_argument("--checkpoint", default=None, help=SPMD_ONLY)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; a missing GPU is an error) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.mode == "spmd":
        raise SystemExit("repro_torch.launch.train: --mode spmd is not ported "
                         "yet: see ROADMAP.md, Queue 1 item 13 (launch "
                         "utilities, last); use --mode gwtf")
    given = [f"--{k.replace('_', '-')}" for k in ("steps", "log_every",
                                                  "checkpoint")
             if getattr(args, k) is not None]
    if given:
        raise SystemExit(f"repro_torch.launch.train: {', '.join(given)} "
                         "belong to --mode spmd, which is not ported yet: "
                         "see ROADMAP.md, Queue 1 item 13")
    return run_gwtf(args)


if __name__ == "__main__":
    main()
