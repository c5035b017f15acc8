"""Serving example: prefill + batched KV-cache decoding (reduced config).

The PyTorch port's counterpart of ``examples/serve_decode.py``: the same
prefill and decode code paths, the sliding-window ring buffer included,
through ``repro_torch``, on the GPU unless ``--device cpu`` is given.
``decode_step`` writes the cache in place, and the loop just calls it
(JAX jits its step).

    PYTHONPATH=src python examples/torch_serve_decode.py
"""
import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.runtime.serving import serving_inputs
from repro_torch.models.transformer import decode_step, init_cache, prefill


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; a missing GPU is an error) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("tinyllama-1.1b").reduced(num_layers=4, d_model=256)
    cfg = dataclasses.replace(cfg, sliding_window=64)
    B, prompt_len, gen_len = 4, 32, 24
    model, prompt, _ = serving_inputs(cfg, seed=0, batch=B,
                                      prompt_len=prompt_len, device=device)
    window = cfg.sliding_window

    # sliding-window ring-buffer cache (long-context serving mode)
    cache = init_cache(cfg, B, window, dtype=torch.float32, device=device)

    t0 = time.time()
    logits, cache = prefill(model, cfg, tokens=prompt, cache=cache)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"prefill: {tuple(prompt.shape)} -> logits {tuple(logits.shape)} "
          f"({time.time()-t0:.2f}s)")

    tok = logits.argmax(dim=-1)[:, None]
    out = [tok]
    for i in range(gen_len):
        logits, cache = decode_step(model, cfg, tokens=tok, cache=cache,
                                    index=prompt_len + i, window=window)
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
    gen = torch.cat(out, dim=1)
    print(f"decoded {gen_len} tokens/seq with a {window}-slot ring buffer")
    print("sample token ids:", gen[0].tolist())


if __name__ == "__main__":
    main()
