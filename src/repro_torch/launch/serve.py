"""Serving driver of the PyTorch port: batched prefill + decode with a KV
cache, on the GPU unless ``--device cpu`` is given.

The same CLI as ``repro.launch.serve``, plus ``--device``.  On the GPU,
prefill attention always goes through the hand-written flash-attention
kernel and prefill's chunked SSD scan through the hand-written SSD kernel
(there is no ``--use-kernel``), and once a request shape recurs each
decode step is replayed from a CUDA graph (``DecodeGraphs``; a single
call, as this CLI makes, decodes eagerly).  An SSM model's cache holds
no attention slots, so ``--long`` changes nothing for ``mamba2-130m``.
An audio model prefills from stub frame embeddings and a VLM attends to
stub patch embeddings at every step (``serving.serving_aux_inputs``), as
the JAX driver feeds them:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gwtf-llama-300m \
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --batch 4 --prompt-len 32 --gen 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-90b --reduced --device cpu
"""
from __future__ import annotations

import argparse
import itertools
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import spans, sync
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, decode_step,
                                            init_cache, prefill)
from repro_torch.tree import flatten


# the ``request`` id of a call's spans: its place among the process's calls
_REQUESTS = itertools.count()


@dataclass
class Generation:
    tokens: torch.Tensor      # (B, gen + 1): the first sampled token, then one per step
    logits: torch.Tensor      # (gen + 1, B, V) f32: prefill's, then each step's
    prefill_s: float
    decode_s: float


def _sample(logits, temperature: float, generator):
    if temperature <= 0:
        return logits.argmax(dim=-1)[:, None]
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def _launches() -> Dict[object, int]:
    """Each kernel's wrapper and its ``launches`` counter
    (``kops.<kernel>.launches``)."""
    return {f: f.launches for f in vars(kops).values()
            if hasattr(f, "launches")}


def _takes_graphs(model, *inputs) -> bool:
    """Whether ``generate`` replays its decode steps from CUDA graphs: a
    model whose parameters, and inputs, are plain CUDA tensors.  CPU
    tensors, fake and meta tensors and DTensors take the eager loop."""
    if not isinstance(model, torch.nn.Module):
        return False
    param = next(model.parameters(), None)
    return param is not None and all(
        type(t) in (torch.Tensor, torch.nn.Parameter) and t.is_cuda
        for t in (param, *inputs) if t is not None)


# the stream each device's graphs are captured on: capture needs a stream
# other than the default, and cuBLAS keeps a workspace (32 MiB on the
# H100) for every stream it runs on, for the life of the process
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


class DecodeGraphs:
    """The decode steps of one request shape, each captured as a CUDA
    graph, and the tensors they bind: the f32 cache, the token a step
    reads, a VLM's patch embeddings, and the logits a step writes.

    A step's Python ints (its position, cache slot and live slots, and
    the decode kernel's split plan) are constants of its graph, so that a
    replay runs the eager step's kernels on the same inputs and gives its
    numbers bit for bit.  The graphs share one memory pool and are
    replayed in the order they were captured.  A replay adds to each
    kernel's ``launches`` counter what the step's capture added, which
    the capture itself leaves uncounted.

    ``of`` builds one at the second call of a shape in a row (the first
    decodes eagerly, as a call of a shape that never comes back should)
    and keeps it on the model, freed with it, until another shape recurs.
    """

    def __init__(self, model, cfg: ModelConfig, key, *, batch: int,
                 prompt_len: int, gen: int, window: Optional[int],
                 vision: Optional[torch.Tensor], device: torch.device):
        self.key = key
        cache_len = window if window is not None else prompt_len + gen
        self.cache = init_cache(cfg, batch, cache_len, dtype=torch.float32,
                                device=device)
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=device)
        self.vision = None if vision is None else torch.zeros_like(vision)
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.counts: List[List[Tuple[object, int]]] = []

        def step(i):
            return decode_step(model, cfg, tokens=self.tok,
                               vision=self.vision, cache=self.cache,
                               index=prompt_len + i, window=window)[0]

        before = _launches()
        main = torch.cuda.current_stream(device)
        if device not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        side = _CAPTURE_STREAMS[device]
        side.wait_stream(main)
        try:
            # one eager step first, outside any graph: this stream's
            # cuBLAS workspace.  What it writes to the cache, every call
            # zeroes (``start``)
            with torch.cuda.stream(side):
                first = step(0)
            self.logits = torch.empty_like(first)
            pool = torch.cuda.graph_pool_handle()
            with torch.cuda.stream(side):
                for i in range(gen):
                    mark = _launches()
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(pool=pool)
                    try:
                        self.logits.copy_(step(i))
                    finally:                  # never leave the stream capturing
                        graph.capture_end()
                    self.graphs.append(graph)
                    self.counts.append([(f, n - mark[f])
                                        for f, n in _launches().items()
                                        if n != mark[f]])
            main.wait_stream(side)
        finally:
            for f, n in before.items():
                f.launches = n

    @classmethod
    def of(cls, model, cfg: ModelConfig, prompt: torch.Tensor, *, gen: int,
           window: Optional[int], vision: Optional[torch.Tensor],
           request: int) -> Optional["DecodeGraphs"]:
        """The model's graphs for the call ``request``: the kept ones if
        the call's shape is theirs; new ones, captured under a
        ``decode.capture`` span, if the call before had this shape too;
        else None, the call's shape then remembered
        (``model._decode_shape``)."""
        key = (cfg, tuple(prompt.shape), prompt.device, gen, window,
               None if vision is None else (tuple(vision.shape), vision.dtype),
               tuple(p.data_ptr() for p in model.parameters()))
        kept = model.__dict__.get("_decode_graphs")
        if kept is not None and kept.key == key:
            return kept
        if model.__dict__.get("_decode_shape") != key:
            model._decode_shape = key
            return None
        model._decode_graphs = None           # the old cache and pool first
        B, P = prompt.shape
        with spans.span("decode.capture", request=request):
            model._decode_graphs = cls(model, cfg, key, batch=B,
                                       prompt_len=P, gen=gen, window=window,
                                       vision=vision, device=prompt.device)
        return model._decode_graphs

    def start(self, vision: Optional[torch.Tensor]) -> Dict[str, Any]:
        """A call's cache, zeroed as ``init_cache`` makes it, for its
        prefill to fill in place; ``vision`` copied in for its steps."""
        for t in flatten(self.cache)[0]:
            t.zero_()
        if vision is not None:
            self.vision.copy_(vision)
        return self.cache

    def step(self, i: int, tok: torch.Tensor) -> torch.Tensor:
        """Step ``i`` on the tokens ``tok`` (B, 1): its logits, a new
        tensor."""
        self.tok.copy_(tok)
        self.graphs[i].replay()
        for f, n in self.counts[i]:
            f.launches += n
        return self.logits.clone()


@torch.inference_mode()
def generate(model: Transformer, cfg: ModelConfig, prompt: torch.Tensor, *,
             gen: int, window: Optional[int], temperature: float,
             generator: Optional[torch.Generator],
             vision: Optional[torch.Tensor] = None,
             embeds: Optional[torch.Tensor] = None) -> Generation:
    """Prefill ``prompt`` (B, P), or ``embeds`` (B, P, D) in its place,
    then decode ``gen`` steps; ``vision`` (a VLM's patch embeddings) goes
    to the prefill and to every step.

    With ``window`` the attention cache is a ring buffer of ``window``
    slots, else it holds ``P + gen``; the SSM state is O(1) either way.
    The cache is f32 whatever the params' dtype, as in the JAX driver.
    Greedy when ``temperature <= 0``.  Spans (``repro_torch.spans``):
    ``prefill``, each ``decode.step``, and the ``logits`` kept and the
    token ``sample``d after each, all with the call's ``request`` id and
    the decode step's ``step``.

    A model whose parameters and inputs are plain CUDA tensors replays
    each decode step from a CUDA graph (``DecodeGraphs``) from the second
    call of a shape in a row on; that call captures the steps before its
    prefill, under a ``decode.capture`` span, and the spans inside a step
    are recorded at its capture only.  The first call of a shape, and
    anything else (CPU, fake and meta tensors, DTensors), dispatches each
    step eagerly.
    """
    B, P = prompt.shape
    dev = prompt.device
    request = next(_REQUESTS)
    graphs = None
    if gen > 0 and _takes_graphs(model, prompt, vision, embeds):
        graphs = DecodeGraphs.of(model, cfg, prompt, gen=gen, window=window,
                                 vision=vision, request=request)
    if graphs is not None:
        cache = graphs.start(vision)
    else:
        cache_len = window if window is not None else P + gen
        cache = init_cache(cfg, B, cache_len, dtype=torch.float32, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    with spans.span("prefill", request=request):
        if embeds is not None:
            logits, cache = prefill(model, cfg, embeds=embeds, cache=cache)
        else:
            logits, cache = prefill(model, cfg, tokens=prompt, vision=vision,
                                    cache=cache)
    sync(dev)
    prefill_s = time.perf_counter() - t0

    with spans.span("sample", request=request):
        tok = _sample(logits, temperature, generator)
    with spans.span("logits", request=request):
        toks, all_logits = [tok], [logits.float()]
    t0 = time.perf_counter()
    for i in range(gen):
        with spans.span("decode.step", request=request, step=i):
            if graphs is not None:
                logits = graphs.step(i, tok)
            else:
                logits, cache = decode_step(model, cfg, tokens=tok,
                                            vision=vision, cache=cache,
                                            index=P + i, window=window)
        with spans.span("sample", request=request, step=i):
            tok = _sample(logits, temperature, generator)
        toks.append(tok)
        with spans.span("logits", request=request, step=i):
            all_logits.append(logits.float())
    sync(dev)
    decode_s = time.perf_counter() - t0
    return Generation(torch.cat(toks, dim=1), torch.stack(all_logits),
                      prefill_s, decode_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--long", action="store_true",
                    help="sliding-window ring-buffer mode (long_500k path)")
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a missing GPU is an error")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.runtime.serving import (serving_aux_inputs,
                                                  serving_inputs)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=args.layers, d_model=args.d_model)
    window = args.window if args.long else None

    model, prompt, g_sample = serving_inputs(
        cfg, seed=args.seed, batch=args.batch, prompt_len=args.prompt_len,
        device=device)
    vision, embeds = serving_aux_inputs(
        cfg, seed=args.seed, batch=args.batch, prompt_len=args.prompt_len,
        device=device)
    out = generate(model, cfg, prompt, gen=args.gen, window=window,
                   temperature=args.temperature, generator=g_sample,
                   vision=vision, embeds=embeds)
    B = args.batch
    print(f"prefill: bs={B} len={args.prompt_len} ({out.prefill_s:.2f}s)")
    print(f"decoded {args.gen} steps x {B} seqs in {out.decode_s:.2f}s "
          f"({B * args.gen / out.decode_s:.1f} tok/s"
          f"{' , ring-buffer' if args.long else ''})")
    print("sample:", out.tokens[0, :16].tolist())


if __name__ == "__main__":
    main()
