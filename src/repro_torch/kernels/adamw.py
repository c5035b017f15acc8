"""Load and launch the fused AdamW update (``csrc/adamw.cu``).

One tree takes two launches, each over all its leaves: the norm pass
(partial sums of the gradients' squares) and the update pass (the clip and
the step, into new tensors).  The leaves go to the kernels as a table of
:class:`Leaf` records in the launch's arguments, at most ``MAX_LEAVES`` a
tree (the largest tree any configuration updates, a VLM's whole model in
the sharded step, has 24); each leaf is cut into chunks of ``CHUNK``
elements, and ``plan`` lays the chunks out.  DTensor leaves update their
local shards, with the norm's partial sums summed over the mesh between
the two launches.  It is built and loaded by ``kernels/build.py`` at first
use; nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch
import torch.distributed as dist

from repro_torch import spans
from repro_torch.kernels.build import KernelLibrary

CHUNK = 4096          # elements of a chunk: csrc/adamw.cu kChunk
MAX_LEAVES = 48       # leaves of a tree's table: csrc/adamw.cu kMaxLeaves
NORM_BLOCKS = 1024    # most blocks of a norm launch, so most partial sums
DTYPES = (torch.float32, torch.bfloat16)
DECAY, GRAD_BF16, PARAM_BF16 = 1, 2, 4


class Leaf(ctypes.Structure):
    """csrc/adamw.cu's ``Leaf``, field for field."""
    _fields_ = [("g", ctypes.c_void_p), ("p", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("p_out", ctypes.c_void_p), ("m_out", ctypes.c_void_p),
                ("v_out", ctypes.c_void_p), ("numel", ctypes.c_longlong),
                ("chunk_end", ctypes.c_int), ("flags", ctypes.c_int)]


def _bind(lib: ctypes.CDLL) -> None:
    norm = lib.adamw_norm
    norm.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                     + [ctypes.c_float] + [ctypes.c_void_p] * 2)
    norm.restype = ctypes.c_int
    step = lib.adamw_step
    step.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                     + [ctypes.c_int] * 2 + [ctypes.c_float] * 9
                     + [ctypes.c_void_p] * 3)
    step.restype = ctypes.c_int


LIBRARY = KernelLibrary("adamw", _bind)


def plan(numels: Sequence[int]) -> List[int]:
    """Each leaf's cumulative chunk end, for leaves of ``numels`` elements:
    chunk c belongs to the first leaf whose end exceeds c, and the last end
    is the launch's count of chunks."""
    ends, c = [], 0
    for n in numels:
        c += -(-n // CHUNK)
        ends.append(c)
    return ends


def _plain(t) -> bool:
    return type(t) in (torch.Tensor, torch.nn.Parameter) and t.is_cuda


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def takes(leaf) -> bool:
    """Whether the kernel is the path for a tree with this leaf: a plain
    tensor on a CUDA device, or a DTensor whose local shard is one (not a
    fake or a meta tensor)."""
    if isinstance(leaf, _dtensor_type()):
        return _plain(leaf.to_local())
    return _plain(leaf)


def counted(placements, coordinate) -> bool:
    """Whether this rank's shard of a leaf laid out as ``placements`` adds
    to the tree's norm: a leaf replicated along a mesh dimension counts on
    that dimension's first coordinate only, so that the sum of every
    rank's counted shards holds each element once."""
    return all(c == 0 for pl, c in zip(placements, coordinate)
               if pl.is_replicate())


def check_inputs(grads, params, m, v, step) -> None:
    """Raise on anything the kernels do not take."""
    if not (len(grads) == len(params) == len(m) == len(v)) or not params:
        raise ValueError(f"adamw kernel: {len(grads)} gradients, "
                         f"{len(params)} parameters, {len(m)} and {len(v)} "
                         f"moments; wants as many of each, at least one")
    if len(params) > MAX_LEAVES:
        raise ValueError(f"adamw kernel takes at most {MAX_LEAVES} leaves a "
                         f"tree, got {len(params)}")
    device = params[0].device
    for i, (g, p, a, b) in enumerate(zip(grads, params, m, v)):
        if not all(type(t) in (torch.Tensor, torch.nn.Parameter)
                   and t.device == device for t in (g, p, a, b)):
            raise ValueError(f"adamw kernel: leaf {i}'s gradient, parameter "
                             f"and moments must be plain tensors on {device}")
        if g.dtype not in DTYPES or p.dtype not in DTYPES:
            raise ValueError(f"adamw kernel takes f32 or bf16 parameters and "
                             f"gradients, got {p.dtype} and {g.dtype} at "
                             f"leaf {i}")
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            raise ValueError(f"adamw kernel takes f32 moments, got {a.dtype} "
                             f"and {b.dtype} at leaf {i}")
        if not (g.shape == p.shape == a.shape == b.shape):
            raise ValueError(f"adamw kernel: leaf {i}'s gradient "
                             f"{tuple(g.shape)}, parameter {tuple(p.shape)} "
                             f"and moments {tuple(a.shape)}, {tuple(b.shape)} "
                             f"differ")
    if step.dtype != torch.int32 or step.dim() != 0 or step.device != device:
        raise ValueError(f"adamw kernel wants the step an int32 scalar on "
                         f"{device}, got {step.dtype} {tuple(step.shape)} on "
                         f"{step.device}")


def launch(grads, params, m, v, step, *, lr, b1, b2, eps, weight_decay,
           grad_clip, divisor=1, library=LIBRARY):
    """Update one tree's leaves (lists in one order) on the card.

    Returns ``(params, m, v, step)``, all new tensors: nothing is written
    in place.  Allocates the outputs and the norm's partial sums, launches
    on the current stream and raises if a launch was refused.  Does not
    synchronise.  Leaves that are not contiguous are read through a
    contiguous copy; the outputs are contiguous.

    DTensor leaves (one mesh) update their local shards: each rank's norm
    pass sums the shards it counts (``counted``) into a fixed number of
    partials, which are summed over the mesh before the update pass, so
    every rank clips by the norm of the whole tree.
    """
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 grad_clip=grad_clip, divisor=divisor)
    if isinstance(params[0], _dtensor_type()):
        return _launch_sharded(grads, params, m, v, step, hyper, library)
    return _update(grads, params, m, v, step, hyper, library)


def _launch_sharded(grads, params, m, v, step, hyper, library):
    DTensor = _dtensor_type()
    mesh = params[0].device_mesh
    local = [[], [], [], []]
    for i, p in enumerate(params):
        trees = (grads[i], p, m[i], v[i])
        if not all(isinstance(t, DTensor) and t.device_mesh == mesh
                   for t in trees):
            raise ValueError(f"adamw kernel: leaf {i}'s gradient, parameter "
                             f"and moments must be DTensors on one mesh")
        if any(pl.is_partial() for pl in p.placements):
            raise ValueError(f"adamw kernel: parameter {i} is partial "
                             f"({p.placements})")
        for out, t in zip(local, trees):
            if t.placements != p.placements:
                t = t.redistribute(mesh, p.placements)
            out.append(t.to_local())
    coordinate = mesh.get_coordinate()
    counts = [counted(p.placements, coordinate) for p in params]

    def reduce(partials):
        for d in range(mesh.ndim):
            if mesh.size(d) > 1:
                dist.all_reduce(partials, group=mesh.get_group(d))

    sharded_step = isinstance(step, DTensor)
    new_p, new_m, new_v, new_step = _update(
        *local, step.to_local() if sharded_step else step, hyper, library,
        counts=counts, reduce=reduce)

    def wrap(t, like):
        return DTensor.from_local(t, mesh, like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())

    return ([wrap(t, p) for t, p in zip(new_p, params)],
            [wrap(t, p) for t, p in zip(new_m, params)],
            [wrap(t, p) for t, p in zip(new_v, params)],
            wrap(new_step, step) if sharded_step else new_step)


def _table(leaves, ends, grads, params, m, v, new_p, new_m, new_v):
    table = (Leaf * len(leaves))()
    for rec, i, end in zip(table, leaves, ends):
        rec.g, rec.p = grads[i].data_ptr(), params[i].data_ptr()
        rec.m, rec.v = m[i].data_ptr(), v[i].data_ptr()
        rec.p_out, rec.m_out = new_p[i].data_ptr(), new_m[i].data_ptr()
        rec.v_out = new_v[i].data_ptr()
        rec.numel, rec.chunk_end = params[i].numel(), end
        rec.flags = ((DECAY if params[i].ndim >= 2 else 0)
                     | (GRAD_BF16 if grads[i].dtype == torch.bfloat16 else 0)
                     | (PARAM_BF16 if params[i].dtype == torch.bfloat16 else 0))
    return table


def _update(grads, params, m, v, step, hyper, library, *, counts=None,
            reduce=None):
    """The two launches over plain CUDA leaves.  ``counts``: which leaves
    the norm pass sums (all of them if None); ``reduce``: sums the
    partials in place across ranks (a fixed ``NORM_BLOCKS`` of them,
    zero past those the norm pass wrote)."""
    check_inputs(grads, params, m, v, step)
    lib = library.load()
    device = params[0].device
    grads, params, m, v = ([t.contiguous() for t in ts]
                           for ts in (grads, params, m, v))
    new_p = [torch.empty(p.shape, dtype=p.dtype, device=device) for p in params]
    new_m = [torch.empty(p.shape, dtype=torch.float32, device=device)
             for p in params]
    new_v = [torch.empty(p.shape, dtype=torch.float32, device=device)
             for p in params]
    new_step = torch.empty((), dtype=torch.int32, device=device)
    outs = (grads, params, m, v, new_p, new_m, new_v)
    every = list(range(len(params)))
    ends = plan([p.numel() for p in params])
    table = _table(every, ends, *outs)
    clip_on = hyper["grad_clip"] is not None
    divisor = hyper["divisor"]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        partials = torch.empty(0, dtype=torch.float64, device=device)
        if clip_on:
            with spans.span("adamw.clip"):
                summed = every if counts is None else [
                    i for i in every if counts[i]]
                norm_ends = ends if counts is None else plan(
                    [params[i].numel() for i in summed])
                norm_table = table if counts is None else _table(
                    summed, norm_ends, *outs)
                chunks = norm_ends[-1] if summed else 0
                blocks = min(chunks, NORM_BLOCKS)
                partials = (torch.empty(blocks, dtype=torch.float64,
                                        device=device) if reduce is None else
                            torch.zeros(NORM_BLOCKS, dtype=torch.float64,
                                        device=device))
                if blocks:
                    _check(lib.adamw_norm(
                        norm_table, len(summed), chunks, blocks, divisor,
                        partials.data_ptr(), stream), "norm")
                if reduce is not None:
                    reduce(partials)
        with spans.span("adamw.step"):
            _check(lib.adamw_step(
                table, len(table), ends[-1], partials.data_ptr(),
                partials.numel(), int(clip_on),
                hyper["grad_clip"] if clip_on else 0.0, divisor,
                hyper["lr"], hyper["b1"], hyper["b2"], 1 - hyper["b1"],
                1 - hyper["b2"], hyper["eps"], hyper["weight_decay"],
                step.data_ptr(), new_step.data_ptr(), stream), "update")
    return new_p, new_m, new_v, new_step


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"adamw {what} kernel launch failed: cudaError {err}")
