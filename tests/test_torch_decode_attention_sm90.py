"""The split-KV decode attention kernel (``kernels/csrc/decode_attention.cu``)
and the path to it.

On the CPU: the split plan (its count at the serve cells' shapes, every
split non-empty, the splits covering the live slots exactly), the plain
version bit for bit equal to the body ``layers._decode_attention`` had
before the kernel (kept below as ``_former_decode_attention``), fake and
meta tensors through the plain version with the counter at 0, the
wrapper's refusals, and the wrapper's constants against the C source.

On the card (marker ``card``; they skip elsewhere): the kernel against the
plain version on the same device at the serve cells' shapes (64 rows of
1,088 slots, 32 rows of 4,096, each at a partly and a wholly live cache),
one live slot, a count of live slots that is no multiple of the tile, MHA,
head_dim 16, 64, 128 and 256, a bf16 cache, the ``kv_heads`` maps
``_attend`` builds on a 2-way and a 3-way head split, a head-padded cache
and strided q.  With q in bf16 each output element lies within one bf16
ulp at the magnitude of its row (the largest element of its (row, head));
with q in f32 the kernel's largest error against the plain version run in
f64 is at most twice the plain version's own (both sum in f32, in other
orders).  Also: one count a call, no host sync, bit-equal repeats,
untouched inputs, the wrapper's refusals of CUDA tensors, and a reduced
serve through ``generate`` whose greedy tokens equal the CPU's and whose
launches are layers x steps.  Run them there with ``python3 -m pytest
--noconftest -q -p no:cacheprovider tests/test_torch_decode_attention_sm90.py``
(the card has no JAX, which the directory's conftest imports).
"""
import dataclasses
import re

import pytest

pytest.importorskip("torch")

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.core.runtime.serving import serving_inputs
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import ops
from repro_torch.launch.serve import generate
from repro_torch.models import layers

SOURCE = kdec.LIBRARY.source
NEG_INF = -1e30


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


def _former_decode_attention(q, ck, cv, kv_valid, KH, hd, block=2048,
                             kv_heads=None):
    """``layers._decode_attention`` as it was before the kernel, line for
    line (``split_last`` on a plain tensor is this reshape)."""
    B, _, H, _ = q.shape
    C = ck.shape[1]
    block = min(block, C)
    if C % block:
        raise ValueError(f"cache length {C} not divisible by block {block}")
    rep = H // KH if kv_heads is None else 1
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype).item()
    qf = (q[:, 0] * scale).float()
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
    for start in range(0, C, block):
        kc = ck[:, start:start + block].reshape(B, -1, KH, ck.shape[2] // KH)
        vc = cv[:, start:start + block].reshape(B, -1, KH, cv.shape[2] // KH)
        if kv_heads is not None:
            kc, vc = kc.index_select(2, kv_heads), vc.index_select(2, kv_heads)
        elif rep > 1:
            kc = kc.repeat_interleave(rep, dim=2)
            vc = vc.repeat_interleave(rep, dim=2)
        sc = torch.einsum("bhd,bkhd->bhk", qf, kc.float())
        pos = torch.arange(start, start + block, device=q.device)
        sc = sc.masked_fill(~(pos < kv_valid)[None, None, :], NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        pch = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + pch.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhk,bkhd->bhd", pch.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out[:, None].to(q.dtype)


def _inputs(B, C, H, KH, hd, q_dtype, kv_dtype, device="cpu", seed=0,
            spread=2.0):
    """q, ck, cv drawn from ``seed``; K scaled by ``spread`` so that the
    softmax is neither flat nor one-hot."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, H, hd, generator=g).to(q_dtype)
    ck = (torch.randn(B, C, KH * hd, generator=g) * spread).to(kv_dtype)
    cv = torch.randn(B, C, KH * hd, generator=g).to(kv_dtype)
    return q.to(device), ck.to(device), cv.to(device)


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("pairs, kv_valid, want", [
    (64 * 4, 1025, (4, 288)), (64 * 4, 1088, (4, 288)),      # serve-decode
    (32 * 4, 4033, (8, 512)), (32 * 4, 4096, (8, 512)),      # serve-long
])
def test_split_plan_at_the_serve_cells_shapes(pairs, kv_valid, want):
    """Four splits of 288 slots at 64 rows x 4 K/V heads (1,024 blocks),
    eight of 512 at 32 x 4 (1,024 blocks)."""
    assert kdec.plan(pairs, kv_valid) == want


@pytest.mark.parametrize("pairs", [1, 3, 16, 128, 256, 2048])
@pytest.mark.parametrize("kv_valid", [1, 31, 32, 33, 100, 129, 1025, 4033,
                                      32768])
def test_splits_cover_the_live_slots_once(pairs, kv_valid):
    splits, chunk = kdec.plan(pairs, kv_valid)
    assert splits >= 1 and chunk % kdec.TILE == 0
    spans = [(i * chunk, min((i + 1) * chunk, kv_valid)) for i in range(splits)]
    assert all(lo < hi for lo, hi in spans), spans
    assert [lo for lo, _ in spans[1:]] == [hi for _, hi in spans[:-1]]
    assert spans[0][0] == 0 and spans[-1][1] == kv_valid
    assert splits <= -(-kv_valid // kdec.MIN_SPLIT)
    assert splits * pairs <= max(kdec.TARGET_BLOCKS, pairs) + pairs


@pytest.mark.parametrize("case", [
    dict(B=2, C=64, H=8, KH=2, hd=64, kv_valid=5, block=16),
    dict(B=2, C=64, H=8, KH=8, hd=64, kv_valid=64, block=16),
    dict(B=3, C=96, H=9, KH=1, hd=32, kv_valid=70, block=32),
    dict(B=2, C=48, H=6, KH=3, hd=16, kv_valid=48, block=2048),
    dict(B=2, C=32, H=4, KH=4, hd=64, kv_valid=20, block=16,
         q_dtype=torch.bfloat16),
    dict(B=2, C=32, H=4, KH=4, hd=64, kv_valid=20, block=16,
         q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16),
    dict(B=2, C=40, H=6, KH=2, hd=32, kv_valid=33, block=8,
         kv_heads=[1, 1, 0, 0, 1, 0]),
])
def test_the_plain_version_is_the_former_body_bit_for_bit(case):
    """On the CPU ``ops.decode_attention`` and ``layers._decode_attention``
    are the former body, to the bit, and launch nothing."""
    case = dict(case)
    block, kv_valid = case.pop("block"), case.pop("kv_valid")
    kv_heads = case.pop("kv_heads", None)
    q, ck, cv = _inputs(**{"q_dtype": torch.float32,
                           "kv_dtype": torch.float32, **case})
    KH, hd = case["KH"], case["hd"]
    kv_heads = None if kv_heads is None else torch.tensor(kv_heads)
    want = _former_decode_attention(q, ck, cv, kv_valid, KH, hd, block=block,
                                    kv_heads=kv_heads)
    before = ops.decode_attention.launches
    for got in (ops.decode_attention(q, ck, cv, kv_valid, KH, hd, block=block,
                                     kv_heads=kv_heads),
                layers._decode_attention(q, ck, cv, kv_valid, KH, hd,
                                         block=block, kv_heads=kv_heads)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert ops.decode_attention.launches == before


@pytest.mark.parametrize("kind", ["meta", "fake"])
def test_fake_and_meta_tensors_take_the_plain_version(kind):
    """The dry run's fake tensors and meta tensors are traced through the
    plain version, never the kernel; a fake tensor on a (fake) CUDA device
    is not the kernel's either."""
    before = ops.decode_attention.launches
    shapes = ((2, 1, 8, 64), (2, 32, 2 * 64), (2, 32, 2 * 64))
    if kind == "meta":
        q, ck, cv = (torch.empty(s, device="meta") for s in shapes)
        out = ops.decode_attention(q, ck, cv, 20, 2, 64)
        assert out.is_meta
    else:
        with FakeTensorMode():
            assert not kdec.takes(torch.empty(shapes[0], device="cuda"))
            q, ck, cv = (torch.empty(s) for s in shapes)
            out = ops.decode_attention(q, ck, cv, 20, 2, 64)
        assert type(out) is not torch.Tensor
    assert out.shape == (2, 1, 8, 64)
    assert ops.decode_attention.launches == before


def _refused(**over):
    B, C, H, KH, hd = 2, 64, 8, 2, 64
    args = dict(q=torch.zeros(B, 1, H, hd), ck=torch.zeros(B, C, KH * hd),
                cv=torch.zeros(B, C, KH * hd), kv_valid=10, KH=KH, hd=hd,
                kv_heads=None)
    args.update(over)
    return args


@pytest.mark.parametrize("over, match", [
    (dict(q=torch.zeros(2, 1, 8, 12), hd=12, KH=2,
          ck=torch.zeros(2, 64, 24), cv=torch.zeros(2, 64, 24)), "head_dim"),
    (dict(q=torch.zeros(2, 1, 8, 264), hd=264, KH=2,
          ck=torch.zeros(2, 64, 528), cv=torch.zeros(2, 64, 528)), "head_dim"),
    (dict(q=torch.zeros(2, 1, 8, 64, dtype=torch.float16)), "f32 or bf16"),
    (dict(ck=torch.zeros(2, 64, 128, dtype=torch.float16),
          cv=torch.zeros(2, 64, 128, dtype=torch.float16)), "f32 or bf16"),
    (dict(cv=torch.zeros(2, 64, 128, dtype=torch.bfloat16)), "f32 or bf16"),
    (dict(ck=torch.zeros(2, 64, 130)[..., :128],
          cv=torch.zeros(2, 64, 130)[..., :128]), "16-byte"),
    (dict(ck=torch.zeros(2, 128, 64).transpose(1, 2),
          cv=torch.zeros(2, 128, 64).transpose(1, 2)), "16-byte"),
    (dict(q=torch.zeros(2, 1, 64, 8).transpose(2, 3)), "16-byte"),
    (dict(cv=torch.zeros(2, 64, 256)[..., :128]), "16-byte"),
    (dict(kv_valid=0), "kv_valid"),
    (dict(kv_valid=65), "kv_valid"),
    (dict(q=torch.zeros(2, 1, 7, 64)), "kv_heads map"),
    (dict(kv_heads=torch.zeros(7, dtype=torch.int32)), "kv_heads must be"),
    (dict(kv_heads=torch.zeros(8)), "kv_heads must be"),
    (dict(ck=torch.zeros(3, 64, 128), cv=torch.zeros(3, 64, 128)), r"\(B, C"),
    (dict(q=torch.zeros(2, 2, 8, 64)), r"\(B, 1, H"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(over, match):
    with pytest.raises(ValueError, match=match):
        kdec.check_inputs(**_refused(**over))


def test_constants_mirror_the_source():
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kTile") == kdec.TILE
    assert const("kMaxHd") == kdec.MAX_HD
    assert const("kMaxHeads") == kdec.MAX_HEADS


# ---------------------------------------------------------------- card


def _map(H, KH, tp, rank):
    """The ``kv_heads`` map ``_attend`` builds on rank ``rank`` of a
    ``tp``-way head split, and the K/V heads that rank holds: its own where
    ``tp`` divides KH, all of them (replicated) where it does not."""
    rep, step = H // KH, -(-H // tp)
    q0, nq = rank * step, max(0, min(step, H - rank * step))
    own = KH % tp == 0
    k0, kh = (rank * (KH // tp), KH // tp) if own else (0, KH)
    return torch.arange(q0, q0 + nq) // rep - k0, (q0, nq), (k0, kh)


# name, (B, C, kv_valid, H, KH, hd), q dtype, cache dtype
CASES = [
    ("serve-decode, 1,025 live", (64, 1088, 1025, 36, 4, 128), "bf16", "f32"),
    ("serve-decode, all live", (64, 1088, 1088, 36, 4, 128), "bf16", "f32"),
    ("serve-long, 4,033 live", (32, 4096, 4033, 36, 4, 128), "bf16", "f32"),
    ("serve-long, all live", (32, 4096, 4096, 36, 4, 128), "bf16", "f32"),
    ("one live slot", (8, 64, 1, 36, 4, 128), "bf16", "f32"),
    ("77 live, no whole tile", (8, 100, 77, 8, 2, 64), "bf16", "f32"),
    ("MHA 16 x 64", (8, 544, 513, 16, 16, 64), "bf16", "f32"),
    ("head_dim 16", (4, 96, 90, 4, 4, 16), "bf16", "f32"),
    ("head_dim 64, GQA 32/4", (8, 544, 530, 32, 4, 64), "bf16", "f32"),
    ("head_dim 256", (8, 544, 300, 16, 16, 256), "bf16", "f32"),
    ("bf16 cache", (16, 1088, 1025, 36, 4, 128), "bf16", "bf16"),
    ("bf16 cache, head_dim 256", (4, 512, 400, 16, 8, 256), "bf16", "bf16"),
    ("f32 q, f32 cache, MHA", (8, 544, 513, 16, 16, 64), "f32", "f32"),
    ("f32 q, f32 cache, GQA", (8, 1088, 1025, 36, 4, 128), "f32", "f32"),
    ("20 query heads, 1 K/V head", (4, 256, 200, 20, 1, 128), "bf16", "f32"),
]
DT = {"bf16": torch.bfloat16, "f32": torch.float32}


def _exact(q, ck, cv, kv_valid, KH, hd, kv_heads=None):
    """The attention in f64 from q scaled in its dtype, as both versions
    scale it: what each version's f32 sums approximate."""
    B, _, H, _ = q.shape
    qs = (q[:, 0] * torch.tensor(hd ** -0.5, dtype=q.dtype).item()).double()
    heads = (torch.arange(H, device=q.device) // (H // KH) if kv_heads is None
             else kv_heads)
    k = ck[:, :kv_valid].double().reshape(B, kv_valid, KH, hd)[:, :, heads]
    v = cv[:, :kv_valid].double().reshape(B, kv_valid, KH, hd)[:, :, heads]
    p = torch.softmax(torch.einsum("bhd,bkhd->bhk", qs, k), dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v)[:, None]


def _check(got, q, ck, cv, kv_valid, KH, hd, kv_heads=None):
    """``got`` against the plain version on the same device: one ulp of
    q's dtype at its row's magnitude for bf16 q; for f32 q, at most twice
    the plain version's own error against itself in f64."""
    want = ops.decode_attention_plain(q, ck, cv, kv_valid, KH, hd,
                                      kv_heads=kv_heads)
    assert got.shape == want.shape and got.dtype == want.dtype
    x, y = got.double(), want.double()
    assert torch.isfinite(x).all()
    if q.dtype == torch.bfloat16:
        row = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(row)) - 7)
        worst = ((x - y).abs() / ulp).max().item()
        assert worst <= 1.0, f"{worst} ulp"
        return worst
    exact = _exact(q, ck, cv, kv_valid, KH, hd, kv_heads)
    kernel_err = (x - exact).abs().max().item()
    plain_err = (y - exact).abs().max().item()
    assert kernel_err <= 2 * plain_err + 1e-12, (kernel_err, plain_err)
    return kernel_err


@pytest.mark.card
@pytest.mark.parametrize("name, shape, q_dt, kv_dt", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_the_plain_version(card, name, shape, q_dt, kv_dt):
    B, C, kv_valid, H, KH, hd = shape
    q, ck, cv = _inputs(B, C, H, KH, hd, DT[q_dt], DT[kv_dt], "cuda", seed=B + C)
    got = ops.decode_attention(q, ck, cv, kv_valid, KH, hd)
    _check(got, q, ck, cv, kv_valid, KH, hd)


@pytest.mark.card
@pytest.mark.parametrize("tp", [2, 3])
def test_kv_heads_maps_of_a_head_split(card, tp):
    """Each rank's query heads of StarCoder2's 36/4 against the K/V heads
    it holds, as ``_attend`` passes them: on 2 ranks each holds 2 K/V heads
    (the map into them), on 3 all 4 (replicated); with an int64 map as
    ``_attend`` builds it, and with int32."""
    H, KH, hd, B, C, kv_valid = 36, 4, 128, 16, 1088, 1030
    q, ck, cv = _inputs(B, C, H, KH, hd, torch.bfloat16, torch.float32, "cuda")
    for rank in range(tp):
        kv_heads, (q0, nq), (k0, kh) = _map(H, KH, tp, rank)
        ql = q[:, :, q0:q0 + nq].contiguous()
        kl = ck[..., k0 * hd:(k0 + kh) * hd].contiguous()
        vl = cv[..., k0 * hd:(k0 + kh) * hd].contiguous()
        for dtype in (torch.int64, torch.int32):
            m = kv_heads.to(device="cuda", dtype=dtype)
            got = ops.decode_attention(ql, kl, vl, kv_valid, kh, hd, kv_heads=m)
            _check(got, ql, kl, vl, kv_valid, kh, hd, kv_heads=m.long())


@pytest.mark.card
def test_a_head_padded_cache_and_strided_q(card):
    """qwen1.5's 20/20 heads padded to 32 (``kv_heads_override``): zero K/V
    heads after the real ones, q padded by whole heads as
    ``apply_attention`` pads it; and q a strided view of a wider tensor."""
    B, C, kv_valid, H, KH, hd, pad = 8, 544, 520, 20, 20, 128, 32
    q, ck, cv = _inputs(B, C, H, KH, hd, torch.bfloat16, torch.float32, "cuda")
    ckp = torch.zeros(B, C, pad * hd, device="cuda")
    cvp = torch.zeros_like(ckp)
    ckp[..., :KH * hd], cvp[..., :KH * hd] = ck, cv
    qp = layers._pad_heads(q, pad)
    got = ops.decode_attention(qp, ckp, cvp, kv_valid, pad, hd)
    _check(got, qp, ckp, cvp, kv_valid, pad, hd)
    wide = torch.randn(B, 1, H, 2 * hd, device="cuda").bfloat16()
    qs = wide[..., :hd]
    assert not qs.is_contiguous()
    got = ops.decode_attention(qs, ck, cv, kv_valid, KH, hd)
    _check(got, qs, ck, cv, kv_valid, KH, hd)


@pytest.mark.card
def test_kernel_is_counted_sync_free_deterministic_and_pure(card):
    B, C, kv_valid, H, KH, hd = 64, 1088, 1025, 36, 4, 128
    q, ck, cv = _inputs(B, C, H, KH, hd, torch.bfloat16, torch.float32, "cuda")
    before = [t.clone() for t in (q, ck, cv)]
    launches = ops.decode_attention.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [ops.decode_attention(q, ck, cv, kv_valid, KH, hd)
                for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.decode_attention.launches == launches + 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert all(torch.equal(a, b) for a, b in zip((q, ck, cv), before))


@pytest.mark.card
@pytest.mark.parametrize("over, match", [
    (dict(hd=12), "head_dim"),
    (dict(q_dtype=torch.float16), "f32 or bf16"),
    (dict(kv_dtype=torch.float16), "f32 or bf16"),
    (dict(slot_pad=1), "16-byte"),
])
def test_the_launch_refuses_cuda_tensors_it_does_not_take(card, over, match):
    hd = over.get("hd", 64)
    B, C, H, KH = 2, 64, 8, 2
    q = torch.zeros(B, 1, H, hd, dtype=over.get("q_dtype", torch.bfloat16),
                    device="cuda")
    width = KH * hd + over.get("slot_pad", 0)
    ck, cv = (torch.zeros(B, C, width, dtype=over.get("kv_dtype", torch.float32),
                          device="cuda")[..., :KH * hd] for _ in range(2))
    launches = ops.decode_attention.launches
    with pytest.raises(ValueError, match=match):
        ops.decode_attention(q, ck, cv, 10, KH, hd)
    assert ops.decode_attention.launches == launches


@pytest.mark.card
@pytest.mark.parametrize("arch", ["starcoder2-7b", "gwtf-llama-300m"])
def test_a_reduced_serve_decodes_through_the_kernel(card, arch):
    """``generate`` on a reduced f32 model drawn on the CPU (StarCoder2's
    at 8/4 heads, the GPT-like at 8/8): on the card every decode step of
    every layer launches the kernel once, and the greedy tokens equal the
    CPU's."""
    cfg = dataclasses.replace(get_config(arch).reduced(num_layers=3,
                                                       d_model=512),
                              param_dtype="float32")
    gen, streams = 12, {}
    for device in ("cpu", "cuda"):
        model, prompt, _ = serving_inputs(cfg, seed=3, batch=4, prompt_len=40,
                                          device="cpu")
        launches = ops.decode_attention.launches
        out = generate(model.to(device), cfg, prompt.to(device), gen=gen,
                       window=None, temperature=0.0, generator=None)
        streams[device] = out.tokens.cpu()
        counted = ops.decode_attention.launches - launches
        assert counted == (cfg.num_layers * gen if device == "cuda" else 0)
    assert torch.equal(streams["cpu"], streams["cuda"])
