"""Per-(microbatch, stage) activation + residual store — the recovery
and fused-backward substrate.

Port of ``repro.core.runtime.activations``.  The store holds, per stage:

* **boundary activations** (stage ``s``'s entry is the *input* of stage
  ``s``; stage 0's entry is the embedding output) — what a substitute
  replica 'downloads' to recompute a crashed forward, and what the remat
  path reads back for its backward;
* **VJP residuals** (the :class:`~repro_torch.core.runtime.stages.Residuals`
  graph of ``StageCompute.forward_fused``) — what the default backward and
  the residual-based crash replay consume.  ``put_residuals`` encodes
  every tensor the graph saved with the store's codec; the backward
  decodes them as it unpacks them.

The codecs are the JAX package's: :class:`Int8Codec` (per-tensor
symmetric int8 + f32 scale, ``|x - dq(q(x))| <= scale/2``),
:class:`Bf16Codec` (``<= 2**-8`` relative error) and :class:`TopKCodec`
(dropped magnitudes bounded by the smallest kept one); they double as
*wire* codecs on inter-stage boundary transfers (``trainer.py``).  Their
encoded ``nbytes`` of a given tensor equal JAX's.  ``peak_bytes`` tracks
the high-water resident size.  A residual's bytes count the tensors
autograd saves, which are not the set XLA keeps, so residual byte counts
differ from the JAX package's; boundary bytes do not.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import torch


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

def _leaf_nbytes(x) -> int:
    return int(x.nbytes)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


class _Quantized:
    """One int8-encoded tensor: values, per-tensor f32 scale, original
    dtype.  Rows can be sliced before dequantisation."""
    __slots__ = ("q", "scale", "dtype")

    def __init__(self, q, scale, dtype):
        self.q = q
        self.scale = scale
        self.dtype = dtype

    @property
    def nbytes(self) -> int:
        return _leaf_nbytes(self.q) + _leaf_nbytes(self.scale)


class NullCodec:
    """Identity codec: full-precision store, zero-copy (the default —
    bit-identity with `CentralizedTrainer` depends on it)."""
    name = "fp"

    def encode(self, x):
        return x

    def decode(self, enc):
        return enc

    @staticmethod
    def nbytes(enc) -> int:
        return _leaf_nbytes(enc)


class Int8Codec:
    """Per-tensor symmetric int8 quantisation with an f32 scale.

    ``scale = amax(|x|) / 127``; ``q = clip(round(x / scale), -127,
    127)``; ``dq = q * scale``.  Round-half-to-even (``torch.round``, as
    ``jnp.round``) bounds the elementwise error by ``scale / 2``.
    Non-float tensors pass through unquantised.
    """
    name = "int8"

    def encode(self, x):
        if not _is_float(x):
            return x
        amax = x.abs().max().float()
        scale = torch.where(amax > 0, amax / 127.0,
                            torch.ones_like(amax))
        q = torch.clamp(torch.round(x.float() / scale), -127, 127)
        return _Quantized(q.to(torch.int8), scale, x.dtype)

    def decode(self, enc):
        if not isinstance(enc, _Quantized):
            return enc
        return (enc.q.float() * enc.scale).to(enc.dtype)

    @staticmethod
    def nbytes(enc) -> int:
        if isinstance(enc, _Quantized):
            return enc.nbytes
        return _leaf_nbytes(enc)


class _Bf16:
    """One bf16-encoded tensor + its original dtype."""
    __slots__ = ("h", "dtype")

    def __init__(self, h, dtype):
        self.h = h
        self.dtype = dtype

    @property
    def nbytes(self) -> int:
        return _leaf_nbytes(self.h)


class Bf16Codec:
    """Round to bfloat16 on the wire / in the store: elementwise
    ``|x - dq(q(x))| <= 2**-8 * |x|`` for normal values.  Non-float
    tensors pass through."""
    name = "bf16"

    def encode(self, x):
        if not _is_float(x):
            return x
        return _Bf16(x.to(torch.bfloat16), x.dtype)

    def decode(self, enc):
        if not isinstance(enc, _Bf16):
            return enc
        return enc.h.to(enc.dtype)

    @staticmethod
    def nbytes(enc) -> int:
        if isinstance(enc, _Bf16):
            return enc.nbytes
        return _leaf_nbytes(enc)


class _Sparse:
    """One top-k-encoded tensor: kept values, flat int32 indices, and the
    metadata to scatter them back into a dense zero tensor."""
    __slots__ = ("vals", "idx", "shape", "dtype", "size")

    def __init__(self, vals, idx, shape, dtype, size):
        self.vals = vals
        self.idx = idx
        self.shape = shape
        self.dtype = dtype
        self.size = size

    @property
    def nbytes(self) -> int:
        return _leaf_nbytes(self.vals) + _leaf_nbytes(self.idx)


class TopKCodec:
    """Magnitude top-k sparsification: keep the ``k_frac`` largest-|x|
    entries as (value, flat int32 index) pairs; decode scatters them into
    zeros.  ``|x - dq(q(x))| <= min(|kept values|)`` elementwise.  Ties
    may keep other indices than ``jax.lax.top_k`` (lowest first) does;
    the bound holds either way.  Non-float tensors pass through."""
    name = "topk"

    def __init__(self, k_frac: float = 1.0 / 16.0):
        if not 0.0 < k_frac <= 1.0:
            raise ValueError(f"k_frac must be in (0, 1], got {k_frac}")
        self.k_frac = float(k_frac)

    def encode(self, x):
        if not _is_float(x):
            return x
        flat = x.reshape(-1)
        n = flat.numel()
        k = max(1, int(round(self.k_frac * n)))
        idx = torch.topk(flat.abs(), k).indices
        return _Sparse(flat[idx], idx.to(torch.int32), tuple(x.shape),
                       x.dtype, n)

    def decode(self, enc):
        if not isinstance(enc, _Sparse):
            return enc
        dense = torch.zeros(enc.size, dtype=enc.dtype, device=enc.vals.device)
        dense[enc.idx.long()] = enc.vals
        return dense.reshape(enc.shape)

    @staticmethod
    def nbytes(enc) -> int:
        if isinstance(enc, _Sparse):
            return enc.nbytes
        return _leaf_nbytes(enc)


CODECS = {"fp": NullCodec, "int8": Int8Codec, "bf16": Bf16Codec,
          "topk": TopKCodec}

# Planner-side wire-codec names (flow.graph.WIRE_CODECS) map onto the
# runtime codec registry.
CODEC_ALIASES = {"fp32": "fp", "top-k": "topk"}


def make_codec(spec: Union[str, None, NullCodec, Int8Codec]):
    if spec is None:
        return NullCodec()
    if isinstance(spec, str):
        name = CODEC_ALIASES.get(spec, spec)
        try:
            return CODECS[name]()
        except KeyError:
            raise ValueError(
                f"unknown activation codec {spec!r} (choose from "
                f"{sorted(CODECS) + sorted(CODEC_ALIASES)})") from None
    return spec


# ---------------------------------------------------------------------------
# Store
# ---------------------------------------------------------------------------

class ActivationStore:
    """Boundary activations + VJP residuals for the in-flight
    iteration, optionally encoded by ``codec``."""

    def __init__(self, codec: Union[str, None, NullCodec, Int8Codec] = None):
        self.codec = make_codec(codec)
        # stage -> list of (mb_ids tuple, encoded stacked tensor) chunks
        self._chunks: Dict[int, List[Tuple[tuple, Any]]] = {}
        # stage -> list of (mb_ids tuple, Residuals with encoded saves)
        self._residuals: Dict[int, List[Tuple[tuple, Any]]] = {}
        self.puts = 0
        self.hits = 0
        self.misses = 0
        self.peak_bytes = 0

    # ------------------------------------------------------------------
    def put(self, stage: int, mb_ids: Sequence[int], x) -> None:
        """Store the stacked input of ``stage`` for ``mb_ids`` (rows of
        ``x`` split evenly, in order)."""
        self._chunks.setdefault(stage, []).append(
            (tuple(mb_ids), self.codec.encode(x)))
        self.puts += 1
        self._note_peak()

    def get(self, stage: int, mb_id: int):
        """The stored input rows of ``stage`` for one microbatch."""
        for ids, enc in self._chunks.get(stage, ()):
            if mb_id in ids:
                x = self.codec.decode(enc)
                per = x.shape[0] // len(ids)
                k = ids.index(mb_id)
                self.hits += 1
                return x[k * per:(k + 1) * per]
        self.misses += 1
        raise KeyError(f"no stored activation for (mb={mb_id}, "
                       f"stage={stage})")

    def stacked(self, stage: int, mb_ids: Sequence[int]):
        """The stacked input of ``stage`` for exactly ``mb_ids``: the one
        chunk holding exactly these ids as-is, else rows gathered per
        microbatch."""
        want = tuple(mb_ids)
        for ids, enc in self._chunks.get(stage, ()):
            if ids == want:
                self.hits += 1
                return self.codec.decode(enc)
        return torch.cat([self.get(stage, i) for i in want], dim=0)

    # ------------------------------------------------------------------
    # Residuals (fused backward / residual-based crash replay)
    # ------------------------------------------------------------------
    def put_residuals(self, stage: int, mb_ids: Sequence[int],
                      residuals) -> None:
        """Store the residual graph of ``stage`` for the chunk ``mb_ids``,
        every saved tensor encoded with the store's codec."""
        for saved in residuals.saved:
            saved.encode(self.codec)
        self._residuals.setdefault(stage, []).append(
            (tuple(mb_ids), residuals))
        self.puts += 1
        self._note_peak()

    def residuals(self, stage: int, mb_ids: Sequence[int]):
        """The residual graph for exactly the chunk ``mb_ids`` (its saved
        tensors decode as the backward unpacks them)."""
        want = tuple(mb_ids)
        for ids, resid in self._residuals.get(stage, ()):
            if ids == want:
                self.hits += 1
                return resid
        self.misses += 1
        raise KeyError(f"no stored residuals for (mbs={want}, "
                       f"stage={stage})")

    def has_residuals(self, stage: int, mb_ids: Sequence[int]) -> bool:
        want = tuple(mb_ids)
        return any(ids == want for ids, _ in self._residuals.get(stage, ()))

    # ------------------------------------------------------------------
    def drop(self, stage: int, mb_ids: Sequence[int]) -> None:
        """Release one chunk's boundary + residuals (the graph is freed
        with its last reference) once its backward completed."""
        want = tuple(mb_ids)
        chunks = self._chunks.get(stage)
        if chunks is not None:
            chunks[:] = [c for c in chunks if c[0] != want]
            if not chunks:
                del self._chunks[stage]
        resid = self._residuals.get(stage)
        if resid is not None:
            resid[:] = [r for r in resid if r[0] != want]
            if not resid:
                del self._residuals[stage]

    def drop_stage(self, stage: int) -> None:
        """Release a stage's activations + residuals entirely."""
        self._chunks.pop(stage, None)
        self._residuals.pop(stage, None)

    def clear(self) -> None:
        self._chunks.clear()
        self._residuals.clear()

    def reset_peak(self) -> None:
        self.peak_bytes = 0

    def nbytes(self) -> int:
        """Resident encoded bytes (boundaries + residuals)."""
        total = sum(self.codec.nbytes(enc)
                    for chunks in self._chunks.values()
                    for _, enc in chunks)
        total += sum(self.codec.nbytes(s.enc)
                     for chunks in self._residuals.values()
                     for _, resid in chunks for s in resid.saved)
        return int(total)

    def _note_peak(self) -> None:
        n = self.nbytes()
        if n > self.peak_bytes:
            self.peak_bytes = n

    def __len__(self) -> int:
        return (sum(len(c) for c in self._chunks.values())
                + sum(len(c) for c in self._residuals.values()))
