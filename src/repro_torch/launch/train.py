"""Training driver of the PyTorch port, on the GPU unless ``--device cpu``
is given.

Port of ``repro.launch.train``, with the same flags plus ``--device``:

* ``--mode spmd`` — single-program training of the whole model on one
  device: ``launch.steps.make_train_step`` over the JAX package's
  stacked parameter tree, one data shard, AdamW; ``--checkpoint`` writes
  that tree through ``checkpoint.store`` in JAX's npz layout.  (JAX runs
  it over the local device mesh; one card has no mesh.)
* ``--mode gwtf`` — the paper's decentralized training: a FlowNetwork of
  data/relay nodes, GWTF flow routing, churn, and per-stage replicas via
  :class:`repro_torch.core.executor.DecentralizedTrainer`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gwtf-llama-300m \
      --mode gwtf --stages 4 --iterations 50 --churn 0.1 --seq-len 512
  PYTHONPATH=src python -m repro_torch.launch.train --mode gwtf --reduced \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --mode spmd --reduced --steps 50 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.executor import DecentralizedTrainer, IterationResult
from repro_torch.core.flow.graph import geo_distributed_network
from repro_torch.data.pipeline import DataConfig, DataNodeShard
from repro_torch.launch.steps import make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params, stack_params
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_map


def build_gwtf(args, cfg: Optional[ModelConfig] = None
               ) -> Tuple[DecentralizedTrainer, Dict[int, DataNodeShard]]:
    """The trainer over a seeded geo-distributed network, and one data
    shard per data node.  ``cfg`` trains that config in place of
    ``--arch`` (and ``--reduced``): a cut the flags do not express, such as
    a model at full width with fewer layers."""
    if cfg is None:
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def spmd_params(cfg: ModelConfig, seed: int, device):
    """Seeded initial parameters of ``--mode spmd``, in the JAX package's
    stacked layout: drawn on the CPU from ``seed`` and moved to
    ``device``, so that every device starts from the same weights."""
    model = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return tree_map(lambda t: t.to(device), stack_params(cfg, model))


def build_spmd(args, cfg: Optional[ModelConfig] = None):
    """``(cfg, params, opt_state, train_step, shard)`` for ``--mode
    spmd``; ``cfg`` trains that config in place of ``--arch`` (and
    ``--reduced``)."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced(num_layers=args.layers, d_model=args.d_model)
    opt = AdamW(lr=args.lr)
    params = spmd_params(cfg, args.seed, resolve_device(args.device))
    shard = DataNodeShard(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len, batch_size=args.batch,
        microbatch_size=args.batch, seed=args.seed), 0, 1)
    return cfg, params, opt.init(params), make_train_step(cfg, opt), shard


def spmd_step(train_step, params, opt_state, shard: DataNodeShard, device):
    """One step on the shard's next batch: ``(params, opt_state, loss,
    seconds, tokens)``, the seconds of the step alone (the device
    synchronized on both sides)."""
    b = shard.next_batch()
    batch = {k: torch.from_numpy(b[k]).to(device) for k in ("tokens", "labels")}
    _sync(device)
    t0 = time.perf_counter()
    params, opt_state, loss = train_step(params, opt_state, batch)
    _sync(device)
    return params, opt_state, float(loss), time.perf_counter() - t0, batch[
        "tokens"].numel()


def run_spmd(args) -> float:
    device = resolve_device(args.device)
    cfg, params, opt_state, train_step, shard = build_spmd(args)
    for step in range(args.steps):
        params, opt_state, loss, secs, tokens = spmd_step(
            train_step, params, opt_state, shard, device)
        if step % args.log_every == 0:
            print(f"step {step:4d} loss {loss:.4f} ({secs * 1e3:.1f} ms, "
                  f"{tokens / secs:.0f} tok/s)")
    if args.checkpoint:
        store.save(args.checkpoint, params, step=args.steps)
        print("checkpoint ->", args.checkpoint)
    print(f"final loss {loss:.4f}")
    return loss


SPMD_ONLY = "--mode spmd only (--mode gwtf takes --iterations)"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gwtf-llama-300m")
    ap.add_argument("--mode", choices=("spmd", "gwtf"), default="gwtf")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20, help=SPMD_ONLY)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--relays-per-stage", type=int, default=3)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--data-nodes", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--churn", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5, help=SPMD_ONLY)
    ap.add_argument("--checkpoint", default=None, help=SPMD_ONLY)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; a missing GPU is an error) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.mode == "spmd":
        return run_spmd(args)
    return run_gwtf(args)


if __name__ == "__main__":
    main()
