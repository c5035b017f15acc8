"""Batched serving: ``launch/serve.generate``, a closed loop of one client.

Each request is a batch of ``batch`` prompts of ``prompt_len`` tokens,
uniform over the vocabulary and drawn from (seed, request), followed by
``gen`` greedy tokens; the next request is sent when this one returns.  The
cache is f32, as the serve driver keeps it.  Set-up draws the weights on
the card (``weights.py``, in the configuration's dtype) into the port's
``Transformer`` and serves one request of the same shapes, which builds
the flash kernel on a checkout's first run.

A request's time to first token is the time from its send to the end of
its prefill, the device synchronized: the call's wall time less the
``decode_s`` that ``generate`` measured after its prefill.

Each request keeps, for ``keep_rows`` of its rows drawn from (seed,
request), the logits that its tokens were picked from (copied to the host
after the request, outside its times).

The comparison (``check``), after the window and with the model freed: a
sample of those kept rows drawn from the seed, ``sample_rows`` of them
(every row served the same ``gen + 1`` tokens), each run once through the
plain reference over its prompt and served tokens
(``reference/greedy.py``).  ``logit_gap`` is the widest gap by which a
served token's logit lies below the reference's best; ``logit_error`` the
worst relative root-mean-square error of the served logits at a position.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness, profiling, weights
from perfbench.reference import dense, greedy


def prompts(seed: int, request: int, w: dict, vocab: int, device) -> torch.Tensor:
    g = weights.generator(seed, f"prompt/{request}", device)
    return torch.randint(0, vocab, (w["batch"], w["prompt_len"]), generator=g, device=device)


def build_model(cfg, seed: int, device):
    """The port's ``Transformer`` with the benchmark's weights: each leaf of
    the blocks drawn once for all layers (``blocks/<path>``, stacked)."""
    from repro_torch.models.transformer import Transformer, init_params
    meta = init_params(cfg, torch.Generator(), "meta")
    stacked = {key: weights.draw(key, (cfg.num_layers, *t.shape), t.dtype, seed, device)
               for key, t in weights.flat(meta.blocks[0].tree(), "blocks").items()}
    blocks = [dense.nest({key.split("/", 1)[1]: t[i] for key, t in stacked.items()})
              for i in range(cfg.num_layers)]
    return Transformer(cfg, {"embed": weights.like(meta.embed.tree(), "embed", seed, device),
                             "final_norm": weights.like(meta.final_norm.tree(), "final_norm",
                                                        seed, device),
                             "blocks": blocks})


def run(cell, run):
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import init_cache, prefill
    w, cfg = cell.workload, harness.model_config(cell.config)
    dev = torch.device(run.device)
    sync = torch.cuda.synchronize if run.device == "cuda" else (lambda: None)
    if run.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, run.seed, dev)

    def serve(request: int):
        prompt = prompts(run.seed, request, w, cfg.vocab_size, dev)
        sync()
        t_send = time.perf_counter()
        out = generate(model, cfg, prompt, gen=w["gen"], window=None, temperature=0.0,
                       generator=None)
        return out, time.perf_counter() - t_send

    serve(-1)
    served: List[tuple] = []
    t_start = time.perf_counter()
    run.setup_s = t_start - run.t0
    while True:
        out, wall = serve(len(served))
        finite = bool(torch.isfinite(out.logits).all())
        rows = kept_rows(run.seed, len(served), w)
        served.append((rows, out.tokens[rows].cpu(), out.logits[:, rows].transpose(0, 1).cpu()))
        run.attempted += 1
        run.failed += 0 if finite else 1
        run.records.append({"ttft_s": wall - out.decode_s, "prefill_s": out.prefill_s,
                            "decode_s": out.decode_s, "decoded": w["batch"] * w["gen"]})
        if time.perf_counter() - t_start >= run.seconds:
            break
    run.window_s = time.perf_counter() - t_start
    if run.device == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if run.trace and run.device == "cuda":
        prompt = prompts(run.seed, len(served), w, cfg.vocab_size, dev)
        run.profile, out = profiling.profile(
            lambda: generate(model, cfg, prompt, gen=w["gen"], window=None,
                             temperature=0.0, generator=None))
        run.extra["profiled_decode_s"] = out.decode_s
        run.extra["prefill_profile"], _ = profiling.profile(
            lambda: prefill(model, cfg, tokens=prompt, cache=init_cache(
                cfg, w["batch"], w["prompt_len"] + w["gen"], dtype=torch.float32,
                device=dev)))
    return SimpleNamespace(model=model, served=served)


def kept_rows(seed: int, request: int, w: dict) -> List[int]:
    """The rows of a request whose logits are kept for the check."""
    rng = np.random.default_rng([seed % (1 << 64), 2, request])
    return sorted(int(b) for b in rng.choice(w["batch"], min(w["batch"], w["keep_rows"]),
                                             replace=False))


def reference_model(cell, seed: int, device):
    """(layers, head) of the run's weights, drawn again, in f32."""
    cfg = cell.config
    stacked = {path: weights.draw(f"blocks/{path}", (cfg["num_layers"], *shape),
                                  weights.DTYPES[dt], seed, device).float()
               for path, (shape, dt) in dense.layer_shapes(cfg).items()}
    layers = [dense.nest({p: t[i] for p, t in stacked.items()}) for i in range(cfg["num_layers"])]
    head = dense.nest({p: weights.draw(p, shape, weights.DTYPES[dt], seed, device).float()
                       for p, (shape, dt) in dense.head_shapes(cfg).items()})
    return layers, head


def sample(cell, run, state):
    """(prompts, served tokens, served logits) of the rows the check
    compares: rows drawn from the seed over those the requests kept."""
    w = cell.workload
    rng = np.random.default_rng([run.seed % (1 << 64), 1])
    kept = [(r, i) for r, (rows, _, _) in enumerate(state.served) for i in range(len(rows))]
    picks = [kept[int(j)] for j in sorted(rng.choice(len(kept), min(len(kept), w["sample_rows"]),
                                                     replace=False))]
    dev = torch.device(run.device)
    prompt = torch.stack([prompts(run.seed, r, w, cell.config["vocab_size"], dev)[
        state.served[r][0][i]] for r, i in picks])
    tokens = torch.stack([state.served[r][1][i] for r, i in picks]).to(dev)
    logits = torch.stack([state.served[r][2][i] for r, i in picks])
    return prompt, tokens, logits


def free(state) -> None:
    state.model = None
    harness.release()


def check(cell, run, state) -> Dict[str, tuple]:
    free(state)
    rows, served, logits = sample(cell, run, state)
    layers, head = reference_model(cell, run.seed, run.device)
    with dense.tf32_off():
        gaps, errs = greedy.compare(layers, head, cell.config, rows, served, logits)
    limits = cell.workload["limits"]
    got = {"logit_gap": max(gaps), "logit_error": max(errs)}
    return {k: (v, limits[k]) for k, v in got.items() if k in limits}


def controls(cell, run, state) -> Dict[str, Dict[str, float]]:
    """The program's readings, and the control's: the tokens that the
    reference computed in float8 puts first, and its logits, at the same
    positions."""
    free(state)
    rows, served, logits = sample(cell, run, state)
    layers, head = reference_model(cell, run.seed, run.device)
    with dense.tf32_off():
        prog = greedy.compare(layers, head, cell.config, rows, served, logits)
        ctrl = greedy.compare(layers, head, cell.config, rows, served, control=dense.FP8)
    return {"program": {"logit_gap": max(prog[0]), "logit_error": max(prog[1])},
            "control": {"logit_gap": max(ctrl[0]), "logit_error": max(ctrl[1])}}
