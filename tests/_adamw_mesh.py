"""The fused AdamW kernel on the local shards of DTensor leaves, on one card.

Run as a script, in its own process: ``python tests/_adamw_mesh.py``
starts 4 processes on CUDA device 0 in a ``gloo`` group laid out as a
(2, 2) mesh (NCCL takes one rank a card; gloo sums the CUDA partials).
Each draws the same bf16 tree, updates it whole through the kernel, then
updates its own shards of it as DTensors: leaves sharded on one, both or
neither mesh dimension, unevenly, one shard empty.  Rank 0 prints one JSON
object: over every rank, the largest parameter gap in bf16 ulps at the
operands' magnitude, the largest moment gap over its leaf's largest
moment, whether every step equals 1, and the kernel's launch count.

``--cpu`` runs the same on the CPU, the whole tree through the plain
version and the shards' two launches replaced by ``emulated_update``,
their arithmetic in PyTorch, so that the sharded path's bookkeeping
(which shards the norm counts, the partials summed over each mesh
dimension, the DTensors put back together) runs where there is no card.
"""
import json
import socket
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD, MESH = 4, (2, 2)
HYPER = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
             grad_clip=1.0, divisor=3)


def layout():
    """(shape, placements) of each leaf: S(d) shards tensor dim d, R
    replicates, one entry per mesh dimension."""
    from torch.distributed.tensor import Replicate as R, Shard as S
    return [((4, 6, 10), (S(0), S(1))), ((4, 7, 3), (R(), S(1))),
            ((5, 4099), (S(1), R())), ((9,), (R(), R())),
            ((2, 1), (S(0), R())), ((1,), (S(0), R())),
            ((3, 5), (S(1), S(0)))]


def local(t, placements, coordinate):
    """This rank's shard: tensor dims split as ``torch.chunk`` splits them,
    mesh dimension by mesh dimension, empty where a chunk is missing."""
    for pl, c, n in zip(placements, coordinate, MESH):
        if pl.is_shard():
            pieces = torch.chunk(t, n, pl.dim)
            t = pieces[c] if c < len(pieces) else t.narrow(pl.dim, 0, 0)
    return t.contiguous()


def emulated_update(grads, params, m, v, step, hyper, library, *,
                    counts=None, reduce=None):
    """``kernels/adamw.py::_update`` with the kernels' arithmetic done by
    PyTorch on the CPU: the counted leaves' sum of squares into the first
    of ``NORM_BLOCKS`` partials, ``reduce``, then the step."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import ops
    grads = [g / hyper["divisor"] for g in grads]
    partials = torch.zeros(kadamw.NORM_BLOCKS, dtype=torch.float64)
    partials[0] = sum(g.double().square().sum()
                      for i, g in enumerate(grads) if counts is None or counts[i])
    reduce(partials)
    gnorm = partials.sum().float().sqrt()
    scale = torch.clamp(hyper["grad_clip"] / (gnorm + 1e-9), max=1.0)
    return ops.adamw_update_plain(
        [g.float() * scale for g in grads], params, m, v, step,
        **dict(hyper, grad_clip=None, divisor=1))


def worker(rank: int, port: int, device: str, out):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import ops
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        kadamw._update = emulated_update
        kadamw._plain = lambda t: type(t) in (torch.Tensor, torch.nn.Parameter)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh(device, MESH)
        gen = torch.Generator(device=device).manual_seed(0)
        spec = layout()
        draw = (lambda shape, k: torch.randn(  # noqa: E731
            shape, generator=gen, device=device) * k)
        p = [draw(s, 1.0).to(torch.bfloat16) for s, _ in spec]
        g = [draw(s, 3.0).to(torch.bfloat16) for s, _ in spec]
        m = [draw(s, 1e-3) for s, _ in spec]
        v = [draw(s, 1e-3).abs() for s, _ in spec]
        step = torch.zeros((), dtype=torch.int32, device=device)
        whole = ops.adamw_update if device == "cuda" else ops.adamw_update_plain
        want = whole(g, p, m, v, step, **HYPER)
        coordinate = mesh.get_coordinate()

        def shard(ts):
            return [DTensor.from_local(local(t, pl, coordinate), mesh, pl,
                                       run_check=False, shape=t.shape,
                                       stride=t.stride())
                    for t, (_, pl) in zip(ts, spec)]

        before = ops.adamw_update.launches
        got = ops.adamw_update(
            shard(g), shard(p), shard(m), shard(v),
            DTensor.from_local(step, mesh, [Replicate(), Replicate()],
                               run_check=False), **HYPER)
        launches = ops.adamw_update.launches - before
        ulps = moment = 0.0
        for a, b, before_p, (_, pl) in zip(got[0], want[0], p, spec):
            x = a.to_local().float()
            y = local(b, pl, coordinate).float()
            z = local(before_p, pl, coordinate).float()
            if x.numel():
                mag = torch.maximum(torch.maximum(x.abs(), y.abs()), z.abs())
                ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
                ulps = max(ulps, float(((x - y).abs() / ulp).max()))
        for a, b, (_, pl) in zip(got[1] + got[2], want[1] + want[2], spec + spec):
            x, y = a.to_local(), local(b, pl, coordinate)
            if x.numel():
                moment = max(moment, float((x - y).abs().max() / b.abs().max()))
        steps_ok = int(got[3].to_local()) == 1 and int(want[3]) == 1
        row = torch.tensor([ulps, moment, float(steps_ok), float(launches)])
        rows = [torch.zeros(4) for _ in range(WORLD)]
        dist.all_gather(rows, row)
        if rank == 0:
            rows = torch.stack(rows)
            out.put(dict(param_ulps=float(rows[:, 0].max()),
                         moment_rel=float(rows[:, 1].max()),
                         steps_ok=bool(rows[:, 2].min() == 1),
                         launches=[int(x) for x in rows[:, 3]]))
    finally:
        dist.destroy_process_group()


def main() -> int:
    device = "cpu" if sys.argv[1:] == ["--cpu"] else "cuda"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    mp.start_processes(worker, args=(port, device, out), nprocs=WORLD,
                       start_method="spawn")
    print(json.dumps(out.get()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
