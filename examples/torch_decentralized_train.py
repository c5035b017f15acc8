"""End-to-end driver: decentralized training of the paper's ~300M-family
model (reduced) for a few hundred steps under churn, with the centralized
baseline trained side by side — the Fig. 6 experiment.

The PyTorch port's counterpart of ``examples/decentralized_train.py``:
the same flags, defaults and report lines through ``repro_torch``, on the
GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_decentralized_train.py --iterations 200

The staged runtime writes per-stage snapshots (params + optimizer state)
every ``--checkpoint-every`` iterations when ``--checkpoint-dir`` is
set; ``--resume`` restores from them and continues the run — the same
snapshots that bootstrap rejoining nodes (paper Sec. V-E).  Each report
line includes the reroute/recompute counters of the stage-local
recovery path and the resident activation-store bytes (boundary
activations + VJP residuals kept by the fused dispatch);
``--activation-codec int8`` quantises the store (per-tensor symmetric
int8 + fp32 scale) for ~4x less resident memory at a bounded fidelity
cost, and ``--remat`` switches to the rematerialising oracle backward.
``--wire-codec`` compresses the inter-stage boundary-chunk transfers on
the forward path (bf16 / int8 / top-k, or ``planner`` to follow the
flow layer's per-link codec choices; the centralized baseline gets the
same forced codec so the Fig. 6 gap isolates the scheduling, not the
wire fidelity).
"""
import argparse
import os

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint import store as ckpt
from repro_torch.configs import get_config
from repro_torch.core.executor import CentralizedTrainer, DecentralizedTrainer
from repro_torch.core.flow.graph import geo_distributed_network
from repro_torch.data.pipeline import DataConfig, DataNodeShard


def _cen_state(cen):
    return {"stage_params": cen.stage_params, "head_params": cen.head_params,
            "stage_opt": cen.stage_opt, "head_opt": cen.head_opt}


def _cen_path(d):
    return os.path.join(d, "centralized.npz")


def save_centralized(cen, d, step):
    """The baseline snapshots alongside the stage checkpoints so a
    resumed run compares trainers of the same training age."""
    ckpt.save(_cen_path(d), _cen_state(cen), step=step)


def restore_centralized(cen, d):
    tree, step = ckpt.restore(_cen_path(d), _cen_state(cen))
    cen.stage_params = tree["stage_params"]
    cen.head_params = tree["head_params"]
    cen.stage_opt = tree["stage_opt"]
    cen.head_opt = tree["head_opt"]
    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--churn", type=float, default=0.1)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", type=str, default=None,
                    help="write per-stage snapshots here (and bootstrap "
                         "rejoining nodes from them)")
    ap.add_argument("--checkpoint-every", type=int, default=20,
                    help="snapshot period in iterations")
    ap.add_argument("--resume", action="store_true",
                    help="restore from --checkpoint-dir before training")
    ap.add_argument("--activation-codec", choices=["fp", "int8"],
                    default="fp",
                    help="activation/residual store codec: fp (exact, "
                         "default) or int8 (per-tensor symmetric, ~4x "
                         "smaller resident store)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialising backward (the in-engine "
                         "equality oracle) instead of the fused "
                         "residual-carrying dispatch")
    ap.add_argument("--wire-codec",
                    choices=["fp32", "bf16", "int8", "top-k", "planner"],
                    default="fp32",
                    help="inter-stage wire codec for boundary-chunk "
                         "transfers: fp32 (exact, default), a forced "
                         "codec, or planner (follow the network's "
                         "per-link codec-choice matrix)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; a missing GPU is an error) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("gwtf-llama-300m").reduced(
        num_layers=args.layers, d_model=args.d_model)
    S = 4
    net = geo_distributed_network(
        num_stages=S, relay_capacities=[3] * 12, num_data_nodes=1,
        data_capacity=8, rng=np.random.default_rng(args.seed))
    dec = DecentralizedTrainer(cfg, net, churn=args.churn, lr=1e-3,
                               seed=args.seed,
                               checkpoint_dir=args.checkpoint_dir,
                               checkpoint_every=args.checkpoint_every,
                               activation_codec=args.activation_codec,
                               remat=args.remat,
                               wire_codec=args.wire_codec, device=device)
    cen = CentralizedTrainer(cfg, S, lr=1e-3, seed=args.seed, device=device,
                             activation_codec=args.activation_codec,
                             remat=args.remat,
                             wire_codec=("fp32" if args.wire_codec ==
                                         "planner" else args.wire_codec))
    if args.resume:
        if not args.checkpoint_dir:
            ap.error("--resume requires --checkpoint-dir")
        step = dec.restore_checkpoint(args.checkpoint_dir)
        cen_step = restore_centralized(cen, args.checkpoint_dir)
        print(f"resumed from {args.checkpoint_dir} at step {step} "
              f"(centralized baseline at step {cen_step})")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    batch_size=16, microbatch_size=2, seed=args.seed)
    shard = DataNodeShard(dc, 0, 1)
    dn = net.data_nodes()[0].id

    print(f"training {cfg.name}: {args.iterations} iterations, "
          f"churn={args.churn:.0%}, {S} stages x 3 replicas"
          + (f", snapshots -> {args.checkpoint_dir}"
             if args.checkpoint_dir else ""))
    for it in range(args.iterations):
        mbs = shard.microbatches()
        r = dec.iteration({dn: mbs})
        cl = cen.iteration(mbs)
        if args.checkpoint_dir and dec.step % args.checkpoint_every == 0:
            save_centralized(cen, args.checkpoint_dir, dec.step)
        if it % 10 == 0:
            print(f"iter {it:4d}  GWTF(churn) loss={r.loss:.4f} "
                  f"[{r.completed}/{r.launched} mb, "
                  f"rerouted={r.rerouted} (requeued={r.requeued}), "
                  f"recomputes fwd={r.fwd_recomputes} "
                  f"bwd={r.bwd_replays}, dropped={r.dropped}, "
                  f"store={r.store_peak_bytes / 1e6:.1f}MB "
                  f"{args.activation_codec}, "
                  f"wire={r.wire_bytes / 1e6:.1f}MB "
                  f"{','.join(r.wire_codecs) or 'fp32'}]   "
                  f"centralized loss={cl:.4f}")
    g = np.mean(dec.losses[-10:])
    c = np.mean(cen.losses[-10:])
    print(f"\nfinal (mean last 10): GWTF={g:.4f} centralized={c:.4f} "
          f"gap={abs(g-c):.4f}")
    if dec.joins_bootstrapped:
        print(f"{dec.joins_bootstrapped} rejoining node(s) bootstrapped "
              f"from stage snapshots (Sec. V-E)")
    print("paper Fig. 6: the two curves coincide — GWTF does not change "
          "the training semantics, only the schedule.")


if __name__ == "__main__":
    main()
