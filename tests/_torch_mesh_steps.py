"""The port's sharded steps on a real mesh, for the tests to hold against
the unsharded steps.

Run as a script, in its own process: ``python tests/_torch_mesh_steps.py
arch [arch ...]`` starts 8 CPU processes in a ``gloo`` group laid out as a
(2, 4) ("data", "model") mesh.  Each runs, for each arch reduced to 2
layers of width 64 in f32, a train step, a prefill and a decode step from
the same weights and inputs, once unsharded and once on the mesh (the dry
run's rules and shardings).  Rank 0 prints one JSON object: per arch, the
loss, the AdamW first moments (at a learning rate of 0 they are the
gradients times 1 - beta1), the prefill and the decode logits, each as the
largest difference between the two runs over the largest magnitude of the
unsharded values.  An arch ``name:field=value,...`` replaces those
integer fields of the reduced config (``dataclasses.replace``).
"""
import dataclasses
import json
import socket
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD, B, S = 8, 4, 64


def config(name: str):
    from repro_torch.configs import get_config
    arch, _, fields = name.partition(":")
    cfg = get_config(arch).reduced(num_layers=2, d_model=64)
    override = dict(f.split("=") for f in fields.split(",") if f)
    return dataclasses.replace(cfg, param_dtype="float32",
                               **{k: int(v) for k, v in override.items()})


def compare(plain, sharded) -> float:
    scale = max(float(a.abs().max()) for a in plain) or 1.0
    return max(float((a - b.full_tensor()).abs().max())
               for a, b in zip(plain, sharded)) / scale


def one_arch(name: str, mesh) -> dict:
    from repro_torch.launch import steps
    from repro_torch.launch.train import spmd_params
    from repro_torch.models.transformer import init_cache, model_view
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.sharding import ShardingRules, distribute
    from repro_torch.tree import leaves

    cfg = config(name)
    rng = np.random.default_rng(0)
    ints = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.integers(0, cfg.vocab_size, shape))
    reals = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    inputs = {"embeds": reals(B, S, cfg.d_model)} if cfg.audio_frontend else {
        "tokens": ints(B, S)}
    if cfg.arch_type == "vlm":
        inputs["vision"] = reals(B, cfg.num_image_tokens, cfg.vision_dim)
    params = spmd_params(cfg, 0, "cpu")
    out = {}

    # train: the loss, and AdamW's first moments at lr 0
    opt, rules = AdamW(lr=0.0), ShardingRules(seq="model")
    batch = dict(inputs, labels=ints(B, S))
    state = opt.init(params)
    _, plain_state, plain_loss = steps.make_train_step(cfg, opt)(
        params, state, batch)
    (ps, os_, bs), _ = steps.train_shardings(cfg, params, state, batch,
                                             rules, mesh)
    _, sharded_state, sharded_loss = steps.make_train_step(
        cfg, opt, mesh=mesh, rules=rules)(
        distribute(params, ps, mesh), distribute(state, os_, mesh),
        distribute(batch, bs, mesh))
    out["loss"] = compare([plain_loss], [sharded_loss])
    out["grads"] = compare(leaves(plain_state.m), leaves(sharded_state.m))

    # prefill, then a decode step from the unsharded prefill's cache
    with torch.inference_mode():
        cache_abs = init_cache(cfg, B, S, device="meta")
        (ps, bs), _ = steps.serve_shardings(cfg, params, inputs, rules, mesh,
                                            global_batch=B,
                                            cache_abstract=cache_abs)
        plain_logits, cache = steps.make_prefill_step(cfg, S)(
            model_view(cfg, params), inputs)
        sharded_logits, _ = steps.make_prefill_step(
            cfg, S, mesh=mesh, rules=rules)(
            model_view(cfg, distribute(params, ps, mesh)),
            distribute(inputs, bs, mesh))
        out["prefill"] = compare([plain_logits], [sharded_logits])

        rules = ShardingRules()
        step = {"tokens": ints(B, 1)}
        if "vision" in inputs:
            step["vision"] = inputs["vision"]
        (ps, bs), _ = steps.serve_shardings(
            cfg, params, dict(step, cache=cache_abs), rules, mesh,
            global_batch=B)
        sharded_in = dict(distribute(step, {k: bs[k] for k in step}, mesh),
                          cache=distribute(cache, bs["cache"], mesh),
                          index=S - 1)
        plain_decode, _ = steps.make_decode_step(cfg)(
            model_view(cfg, params), dict(step, cache=cache, index=S - 1))
        sharded_decode, _ = steps.make_decode_step(
            cfg, mesh=mesh, rules=rules)(
            model_view(cfg, distribute(params, ps, mesh)), sharded_in)
        out["decode"] = compare([plain_decode], [sharded_decode])
    return out


def worker(rank: int, port: int, names, queue):
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        result = {name: one_arch(name, mesh) for name in names}
    except BaseException as e:
        result = {"error": f"rank {rank}: {type(e).__name__}: {e}"}
        raise
    finally:
        if rank == 0 or "error" in result:
            queue.put(result)
        dist.destroy_process_group()


def main(names):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(r, port, names, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        result = queue.get(timeout=600)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    print(json.dumps(result))


if __name__ == "__main__":
    main(sys.argv[1:])
