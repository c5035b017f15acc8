"""Quickstart: build a decentralized network, route flows, train 10 iterations.

The PyTorch port's counterpart of ``examples/quickstart.py``: the same
network, flows and training loop through ``repro_torch``, on the GPU
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --iterations 3
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.executor import DecentralizedTrainer
from repro_torch.core.flow.graph import geo_distributed_network
from repro_torch.data.pipeline import DataConfig, DataNodeShard


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; a missing GPU is an error) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. A small LLaMA-like model (the paper's eval family), reduced.
    cfg = get_config("gwtf-llama-300m").reduced(num_layers=4, d_model=128)
    print(f"model: {cfg.name} ({cfg.num_layers}L, d_model={cfg.d_model})")

    # 2. A geo-distributed volunteer network: 2 data nodes, 8 relays in 4
    #    stages, heterogeneous capacities, WAN-like links.
    net = geo_distributed_network(
        num_stages=4,
        relay_capacities=[2, 3, 3, 2, 3, 3, 2, 3, 3, 2, 3, 3],
        num_data_nodes=2, data_capacity=4,
        rng=np.random.default_rng(0))
    print(f"network: {len(net.nodes)} nodes, {net.num_stages} stages, "
          f"stage capacities = "
          f"{[net.stage_capacity(s) for s in range(net.num_stages)]}")

    # 3. GWTF: decentralized flow construction + real PyTorch training.
    trainer = DecentralizedTrainer(cfg, net, churn=0.05, lr=3e-3, seed=0,
                                   device=device)
    flows = trainer.protocol.complete_flows()
    print(f"flows built: {len(flows)}")
    for f in flows[:4]:
        print("  flow:", " -> ".join(map(str, f)))

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=8,
                    microbatch_size=2, seed=0)
    shards = {d.id: DataNodeShard(dc, d.id, 2) for d in net.data_nodes()}
    for it in range(args.iterations):
        batches = {dn: s.microbatches() for dn, s in shards.items()}
        r = trainer.iteration(batches)
        print(f"iter {it}: loss={r.loss:.4f} "
              f"microbatches={r.completed}/{r.launched}")


if __name__ == "__main__":
    main()
