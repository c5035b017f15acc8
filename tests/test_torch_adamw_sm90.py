"""The fused AdamW kernel (``kernels/csrc/adamw.cu``) and the path to it.

On the CPU: which leaves take the plain version (CPU, meta, fake and CPU
DTensor leaves; the kernel's counter stays 0), the ``divisor`` argument
against dividing first, the leaf and chunk table the kernels walk (every
element covered exactly once), the ctypes record against the C struct,
the wrapper's refusals, every configuration's trees within the table's
``MAX_LEAVES``, which ranks' shards of a DTensor leaf add to the clip norm
(every element once over the mesh), and the sharded path on a CPU mesh of
four processes with the launches' arithmetic emulated.

On the card (marker ``card``; they skip elsewhere): the kernel against
the plain version on the same device, on a reduced stacked stage tree
(with leaves of odd, single and more-than-a-chunk sizes) and a head tree,
bf16 and f32, clip on and off, divisor 1 and 3, two steps each from the
same inputs.  Parameters agree within one bf16 ulp at the operands'
magnitude (``tests/test_torch_optim.py::_close``) and 1e-6 on f32;
moments within 1e-6 relative, or 1e-6 of the leaf's largest moment where
the update cancels, because the kernel sums the clip norm in another
order.  Also: zero gradients decay only the leaves with ``ndim >= 2``; two
calls are bit-equal; the inputs are unchanged; the counter counts trees;
the call synchronises nothing; at the 7B cell's tree shapes the kernel
moves its bytes at 65 % or more of the H100's 3.35 TB/s; DTensor leaves
on a one-rank mesh take the kernel, bit-equal to plain tensors; and on a
(2, 2) mesh of four processes on the card (``tests/_adamw_mesh.py``)
each rank's shards update as the whole tree does.  Run them there with
``python3 -m pytest --noconftest -q -p no:cacheprovider
tests/test_torch_adamw_sm90.py`` (the card has no JAX, which the
directory's conftest imports).
"""
import ctypes
import dataclasses
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.runtime.stages import init_head_params, init_stage_params
from repro_torch.models.transformer import init_params, stack_params
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import ops
from repro_torch.kernels.timing import device_ms
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import flatten, leaves, tree_map

SOURCE = kadamw.LIBRARY.source
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
SHARE = 0.65


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _trees(dtype: str, device="cpu"):
    """A reduced stage tree (4 stacked blocks) with three extra leaves,
    and a head tree, drawn on the CPU."""
    cfg = dataclasses.replace(get_config("gwtf-llama-300m").reduced(
        num_layers=4, d_model=64), param_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    stage = init_stage_params(cfg, 0, 2, gen)
    dt = DTYPES[dtype]
    stage["extra"] = {"odd": torch.randn(3, 5, 7, generator=gen).to(dt),
                      "one": torch.randn(1, generator=gen).to(dt),
                      "long": torch.randn(3, 4099, generator=gen).to(dt)}
    trees = {"stage": stage, "head": init_head_params(cfg, gen)}
    return tree_map(lambda t: t.to(device), trees)


def _grads(tree, seed: int, scale: float = 3.0):
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda p: (torch.randn(p.shape, generator=gen) * scale)
                    .to(p.dtype).to(p.device), tree)


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("kind", ["cpu", "meta", "fake_cuda", "dtensor"])
def test_other_leaves_take_the_plain_version(kind):
    """CPU, meta, fake (also on a fake CUDA device) and DTensor leaves
    update through the plain version and never count a kernel launch."""
    opt = AdamW(lr=1e-2)
    p = _trees("float32")["stage"]
    g = _grads(p, 1)
    want, want_state = opt.update(g, opt.init(p), p)
    before = ops.adamw_update.launches
    if kind == "cpu":
        got, state = opt.update(g, opt.init(p), p)
    elif kind == "meta":
        got, state = opt.update(*(tree_map(lambda t: t.to("meta"), x)
                                  for x in (g, opt.init(p), p)))
        assert all(leaf.is_meta for leaf in leaves(got))
    elif kind == "fake_cuda":
        with FakeTensorMode(allow_non_fake_inputs=True):
            cuda = (lambda t: torch.empty(t.shape, dtype=t.dtype, device="cuda"))
            got, state = opt.update(tree_map(cuda, g), opt.init(tree_map(cuda, p)),
                                    tree_map(cuda, p))
        assert all(leaf.is_cuda for leaf in leaves(got))
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, distribute_tensor
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh("cpu", (1,))
            on = (lambda t: distribute_tensor(t, mesh, [Replicate()]))
            got, state = opt.update(tree_map(on, g), tree_map(on, opt.init(p)),
                                    tree_map(on, p))
            assert all(type(leaf).__name__ == "DTensor" for leaf in leaves(got))
            got = tree_map(lambda t: t.full_tensor(), got)
            state = tree_map(lambda t: t.full_tensor(), state)
        finally:
            dist.destroy_process_group()
    assert ops.adamw_update.launches == before
    for a, b in zip(leaves((got, state)), leaves((want, want_state))):
        assert a.shape == b.shape and a.dtype == b.dtype
        if kind in ("cpu", "dtensor"):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_divisor_equals_dividing_first(dtype, clip):
    """``update(g, divisor=n)`` is bit-equal to ``update(g / n)``, which
    the trainers did before the divide was folded in."""
    opt = AdamW(lr=1e-2, grad_clip=clip)
    for name, p in _trees(dtype).items():
        g = _grads(p, 2)
        a, sa = opt.update(g, opt.init(p), p, divisor=3)
        b, sb = opt.update(tree_map(lambda x: x / 3, g), opt.init(p), p)
        for x, y in zip(leaves((a, sa)), leaves((b, sb))):
            assert torch.equal(x, y), name


def _locate(ends, numels, c):
    """``(leaf, first element, end)`` of chunk ``c``, found as the kernels
    find it: the first leaf whose chunk end exceeds ``c``."""
    j = 0
    while c >= ends[j]:
        j += 1
    lo = (c - (ends[j - 1] if j else 0)) * kadamw.CHUNK
    return j, lo, min(lo + kadamw.CHUNK, numels[j])


@pytest.mark.parametrize("numels", [
    [0], [1], [4097], [4096],
    [0, 1, 7, 4095, 4096, 4097, 3 * 4096 + 5, 0, 1_000_003],
    [5, 0, 9000, 1, 0, 0, 12_289, 3, 4096],
])
def test_the_chunk_table_covers_every_element_once(numels):
    ends = kadamw.plan(numels)
    assert len(ends) == len(numels)
    hits = [np.zeros(n, np.int64) for n in numels]
    for c in range(ends[-1]):
        leaf, lo, hi = _locate(ends, numels, c)
        assert lo % kadamw.CHUNK == 0 and 0 <= lo < hi <= lo + kadamw.CHUNK
        hits[leaf][lo:hi] += 1
    for n, h in zip(numels, hits):
        assert (h == 1).all(), n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_configurations_trees_fit_one_table(arch):
    """The trees the trainers and the sharded step update (a stage of
    every layer, a data node's head, the whole stacked model) have at most
    ``MAX_LEAVES`` leaves, so each takes one launch of each pass."""
    cfg, gen = get_config(arch), torch.Generator()
    trees = (init_stage_params(cfg, 0, 1, gen, device="meta"),
             init_head_params(cfg, gen, device="meta"),
             stack_params(cfg, init_params(cfg, gen, device="meta")))
    assert max(len(leaves(t)) for t in trees) <= kadamw.MAX_LEAVES


def _placements():
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0), Shard(1), Replicate()]


@pytest.mark.parametrize("mesh_shape", [(2, 2), (3, 2), (4,)])
def test_each_element_adds_to_the_norm_on_one_rank(mesh_shape):
    """Over every rank of the mesh, the shards that ``counted`` lets into
    the norm hold each element of a (5, 6) leaf once, for every layout of
    shards and replicas."""
    for placements in itertools.product(_placements(), repeat=len(mesh_shape)):
        hits = np.zeros((5, 6), np.int64)
        for coordinate in itertools.product(*map(range, mesh_shape)):
            if not kadamw.counted(placements, coordinate):
                continue
            region = [np.arange(5), np.arange(6)]
            for pl, c, n in zip(placements, coordinate, mesh_shape):
                if pl.is_shard():
                    region[pl.dim] = np.array_split(region[pl.dim], n)[c]
            owned = np.zeros((5, 6), np.int64)
            owned[np.ix_(*region)] = 1
            hits += owned
        assert (hits == 1).all(), placements


def test_leaf_record_and_constants_mirror_the_source():
    text = SOURCE.read_text()
    body = re.search(r"struct Leaf \{(.*?)\};", text, re.S).group(1)
    fields = re.findall(r"(\w[\w\s\*]*?)\s*\*?\s*(\w+);", body)
    assert [name for _, name in fields] == [f for f, _ in kadamw.Leaf._fields_]
    assert ctypes.sizeof(kadamw.Leaf) == int(re.search(
        r"static_assert\(sizeof\(Leaf\) == (\d+)", text).group(1))
    for c_name, value in (("kChunk", kadamw.CHUNK),
                          ("kMaxLeaves", kadamw.MAX_LEAVES)):
        assert int(re.search(rf"{c_name} = (\d+);", text).group(1)) == value
    flags = dict(re.findall(r"k(Decay|GradBf16|ParamBf16) = (\d+)", text))
    assert {k: int(v) for k, v in flags.items()} == {
        "Decay": kadamw.DECAY, "GradBf16": kadamw.GRAD_BF16,
        "ParamBf16": kadamw.PARAM_BF16}


def test_sharded_bookkeeping_on_a_cpu_mesh():
    """``tests/_adamw_mesh.py --cpu``: four CPU ranks of a (2, 2) gloo mesh
    through the sharded path with the launches' arithmetic emulated: each
    rank's shards update as the whole tree does through the plain version
    (the norm counted once an element and summed over the mesh), one
    counted launch a rank."""
    out = subprocess.run([sys.executable, str(Path(__file__).with_name(
        "_adamw_mesh.py")), "--cpu"], capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["param_ulps"] <= 1 and got["moment_rel"] <= 1e-6, got
    assert got["steps_ok"] and got["launches"] == [1] * 4, got


def _leaves(**over):
    p = torch.zeros(4, 4, dtype=torch.bfloat16)
    base = dict(grads=[p.clone()], params=[p], m=[torch.zeros(4, 4)],
                v=[torch.zeros(4, 4)], step=torch.zeros((), dtype=torch.int32))
    base.update(over)
    return base


@pytest.mark.parametrize("over,match", [
    (dict(grads=[], params=[], m=[], v=[]), "at least one"),
    ({k: [torch.zeros(1)] * (kadamw.MAX_LEAVES + 1)
      for k in ("grads", "params", "m", "v")}, "at most 48 leaves"),
    (dict(grads=[torch.zeros(4, 4, dtype=torch.float16)]), "f32 or bf16"),
    (dict(m=[torch.zeros(4, 4, dtype=torch.float64)]), "f32 moments"),
    (dict(v=[torch.zeros(4, 5)]), "differ"),
    (dict(step=torch.zeros((), dtype=torch.int64)), "int32 scalar"),
    (dict(grads=[torch.zeros(4, 4, dtype=torch.bfloat16, device="meta")]),
     "plain tensors on cpu"),
])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(over, match):
    with pytest.raises(ValueError, match=match):
        kadamw.check_inputs(**_leaves(**over))


# ---------------------------------------------------------------- card

HYPER = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _flat(tree):
    return flatten(tree)[0]


def _check_params(got, want, before):
    """One bf16 ulp at the operands' magnitude on bf16 leaves (the leaf
    before the update and both results), 1e-6 on f32."""
    for a, b, p in zip(got, want, before):
        x, y, z = a.double(), b.double(), p.double()
        if a.dtype == torch.bfloat16:
            mag = torch.maximum(torch.maximum(x.abs(), y.abs()), z.abs())
            ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
            assert ((x - y).abs() <= ulp).all(), (x - y).abs().max()
        else:
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def _check_moments(got, want):
    for a, b in zip(got, want):
        x, y = a.double(), b.double()
        floor = 1e-6 * y.abs().max() if y.numel() else 0.0
        assert ((x - y).abs() <= torch.clamp(1e-6 * y.abs(), min=floor)).all(), \
            (x - y).abs().max()


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("divisor", [1, 3])
def test_kernel_matches_the_plain_version(card, dtype, clip, divisor):
    for name, p in _trees(dtype, "cuda").items():
        ps = _flat(p)
        m = [torch.zeros(t.shape, device="cuda") for t in ps]
        v = [t.clone() for t in m]
        step = torch.zeros((), dtype=torch.int32, device="cuda")
        for seed in (1, 2):
            g = _flat(_grads(p, seed))
            args = (g, ps, m, v, step)
            kw = dict(HYPER, grad_clip=clip, divisor=divisor)
            got = ops.adamw_update(*args, **kw)
            want = ops.adamw_update_plain(*args, **kw)
            _check_params(got[0], want[0], ps)
            _check_moments(got[1], want[1])
            _check_moments(got[2], want[2])
            assert int(got[3]) == int(want[3]) == seed, name
            ps, m, v, step = got


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_zero_gradients_decay_only_matrices(card, dtype):
    """With zero gradients (a zero clip norm) only the decay moves a leaf,
    and only where ``ndim >= 2``."""
    ps = _flat(_trees(dtype, "cuda")["stage"])
    zeros = [torch.zeros(t.shape, device="cuda") for t in ps]
    args = ([torch.zeros_like(t) for t in ps], ps, zeros, zeros,
            torch.zeros((), dtype=torch.int32, device="cuda"))
    kw = dict(HYPER, lr=0.1, grad_clip=1.0)   # a decay of 1 %, over a bf16 ulp
    got = ops.adamw_update(*args, **kw)
    want = ops.adamw_update_plain(*args, **kw)
    for a, b, p in zip(got[0], want[0], ps):
        assert torch.equal(a, b)
        assert torch.equal(a, p) == (p.ndim < 2)
    for a in got[1] + got[2]:
        assert not a.any()


@pytest.mark.card
def test_kernel_is_deterministic_pure_counted_and_sync_free(card):
    opt = AdamW(lr=1e-2)
    trees = _trees("bfloat16", "cuda")
    state = {k: opt.init(p) for k, p in trees.items()}
    grads = {k: _grads(p, 3) for k, p in trees.items()}
    before = tree_map(torch.clone, (trees, state, grads))
    launches = ops.adamw_update.launches
    runs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            runs.append([opt.update(grads[k], state[k], trees[k], divisor=3)
                         for k in trees])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.adamw_update.launches == launches + 2 * len(trees)
    for a, b in zip(leaves(runs[0]), leaves(runs[1])):
        assert torch.equal(a, b)
    for a, b in zip(leaves((trees, state, grads)), leaves(before)):
        assert torch.equal(a, b)


@pytest.mark.card
def test_bandwidth_at_the_7b_cells_trees(card):
    """The 7B cell's trees (two stages of 4 StarCoder2-7B blocks and the
    untied head, 2.19 B parameters) update at 65 % or more of 3.35 TB/s,
    counting each byte the two passes must move once (g twice), on the
    device's time of calls queued back to back."""
    cfg = dataclasses.replace(get_config("starcoder2-7b"), num_layers=8)
    gen = torch.Generator()
    shapes = {"stage": init_stage_params(cfg, 0, 2, gen, device="meta"),
              "head": init_head_params(cfg, gen, device="meta")}
    total_bytes = total_ms = 0.0
    for name, count in (("stage", 2), ("head", 1)):
        metas = _flat(shapes[name])
        ps = [torch.randn(t.shape, device="cuda").to(t.dtype) for t in metas]
        gs = [torch.randn(t.shape, device="cuda").to(t.dtype) for t in metas]
        mus = [torch.randn(t.shape, device="cuda") * 1e-3 for t in metas]
        nus = [torch.rand(t.shape, device="cuda") * 1e-3 for t in metas]
        args = (gs, ps, mus, nus, torch.zeros((), dtype=torch.int32, device="cuda"))
        kw = dict(HYPER, grad_clip=1.0, divisor=4)
        ms = device_ms(lambda: ops.adamw_update(*args, **kw), reps=3)
        total_ms += count * ms
        total_bytes += count * sum(t.numel() * (2 * g.element_size() + 2 * t.element_size() + 16)
                                   for t, g in zip(ps, gs))
        del ps, gs, mus, nus, args
        torch.cuda.empty_cache()
    rate = total_bytes / (total_ms * 1e-3)
    assert rate >= SHARE * HBM_BYTES_PER_S, (total_ms, rate / HBM_BYTES_PER_S)


@pytest.mark.card
def test_dtensor_leaves_on_one_rank_take_the_kernel(card):
    """On a one-rank mesh the sharded path updates the local shards
    through the kernel, bit-equal to the same leaves as plain tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    ps = _flat(_trees("bfloat16", "cuda")["stage"])
    args = (_flat(_grads(_trees("bfloat16", "cuda")["stage"], 4)), ps,
            [torch.zeros(t.shape, device="cuda") for t in ps],
            [torch.zeros(t.shape, device="cuda") for t in ps],
            torch.zeros((), dtype=torch.int32, device="cuda"))
    kw = dict(HYPER, grad_clip=1.0, divisor=3)
    want = ops.adamw_update(*args, **kw)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        on = (lambda t: distribute_tensor(  # noqa: E731
            t, mesh, [Shard(0) if t.ndim else Replicate()]))
        before = ops.adamw_update.launches
        got = ops.adamw_update(*([on(t) for t in ts] for ts in args[:4]),
                               on(args[4]), **kw)
        assert ops.adamw_update.launches == before + 1
        got = [[t.to_local() for t in ts] for ts in got[:3]] + [got[3].to_local()]
    finally:
        dist.destroy_process_group()
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.card
def test_sharded_leaves_update_as_the_whole_tree(card):
    """Four ranks of a (2, 2) gloo mesh on the card, leaves sharded on one,
    both or neither mesh dimension (unevenly, one shard empty): every
    rank's shards within one bf16 ulp and 1e-6 of each leaf's largest
    moment of the whole tree's update, one launch a rank."""
    out = subprocess.run([sys.executable, str(Path(__file__).with_name(
        "_adamw_mesh.py"))], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["param_ulps"] <= 1 and got["moment_rel"] <= 1e-6, got
    assert got["steps_ok"] and got["launches"] == [1] * 4, got
