"""Serving driver of the PyTorch port: batched prefill + decode with a KV
cache, on the GPU unless ``--device cpu`` is given.

The same CLI as ``repro.launch.serve``, plus ``--device``.  On the GPU,
prefill attention always goes through the hand-written flash-attention
kernel and prefill's chunked SSD scan through the hand-written SSD kernel
(there is no ``--use-kernel``).  An SSM model's cache holds no attention
slots, so ``--long`` changes nothing for ``mamba2-130m``.  An audio model
prefills from stub frame embeddings and a VLM attends to stub patch
embeddings at every step (``serving.serving_aux_inputs``), as the JAX
driver feeds them:

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
from typing import Optional

import torch

from repro_torch import spans
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, decode_step,
                                            init_cache, prefill)


# the ``request`` id of a call's spans: its place among the process's calls
_REQUESTS = itertools.count()


@dataclass
class Generation:
    tokens: torch.Tensor      # (B, gen + 1): the first sampled token, then one per step
    logits: torch.Tensor      # (gen + 1, B, V) f32: prefill's, then each step's
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample(logits, temperature: float, generator):
    if temperature <= 0:
        return logits.argmax(dim=-1)[:, None]
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


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
    """
    B, P = prompt.shape
    dev = prompt.device
    request = next(_REQUESTS)
    cache_len = window if window is not None else P + gen
    cache = init_cache(cfg, B, cache_len, dtype=torch.float32, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    with spans.span("prefill", request=request):
        if embeds is not None:
            logits, cache = prefill(model, cfg, embeds=embeds, cache=cache)
        else:
            logits, cache = prefill(model, cfg, tokens=prompt, vision=vision,
                                    cache=cache)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    with spans.span("sample", request=request):
        tok = _sample(logits, temperature, generator)
    with spans.span("logits", request=request):
        toks, all_logits = [tok], [logits.float()]
    t0 = time.perf_counter()
    for i in range(gen):
        with spans.span("decode.step", request=request, step=i):
            logits, cache = decode_step(model, cfg, tokens=tok,
                                        vision=vision, cache=cache,
                                        index=P + i, window=window)
        with spans.span("sample", request=request, step=i):
            tok = _sample(logits, temperature, generator)
        toks.append(tok)
        with spans.span("logits", request=request, step=i):
            all_logits.append(logits.float())
    _sync(dev)
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
