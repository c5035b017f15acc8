"""The port's ``ServeTrainer`` on the hybrid model against JAX, and its
cohort batching and cache replay inside the port.

Against JAX: reduced ``hymba-1.5b`` (d_model 64, attention and SSD heads
in each layer) with a relay crash mid-decode, built as in
``test_torch_serve_trainer.py``: ledgers, summaries, chain plans, fault
timelines, counters and greedy streams exactly equal.  It is the case
that replays an SSM cache.

Inside the port, for a dense, an SSM and a hybrid model:

* a cohort of three rows stacked into one prefill and one ``decode_step``
  a token gives the streams of each row decoded alone, and logits within
  ``LOGITS`` (rtol = atol = 1e-4);
* a cache rebuilt by ``_replay_cache`` (prefill, then the generated
  tokens teacher-forced one at a time) is within ``LOGITS`` of the cache
  the row reached decoding in its cohort;
* a cohort's dispatch leaves every other live sequence's cache unchanged
  bit for bit, also a row that shares the tensor of the prefill it came
  from (``prefill`` and ``decode_step`` write their cache in place);
* a cohort's old cache tensors are freed as soon as its rows move on,
  with the garbage collector off: nothing holds them in a reference
  cycle (a recursive closure in ``repro_torch.tree`` was one).

Neither of the first two holds bit for bit on the CPU, in the port or in
JAX, whatever the JAX package's docstring says: a GEMM's blocking depends
on its row count.  Measured with one torch thread over 8 decode steps,
the stacked decode logits differ from the per-row ones by up to 2.6e-6
(``gwtf-llama-300m``, d_model 32), 3.6e-6 (``mamba2-130m``) and 1.2e-5
(``hymba-1.5b``), the prefill logits by up to 9.5e-7, and the replayed
cache from the incremental one by up to 2.9e-6 on values of magnitude 3
to 11.  ``LOGITS`` is about 8x the largest of these.
"""
import gc

import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.core.runtime import serving
from repro_torch.tree import leaves
from test_torch_serve_trainer import (CRASH, assert_same_run, port_trainer,
                                      run_both, serving_spec_kw)

LOGITS = dict(rtol=1e-4, atol=1e-4)
MODELS = [("gwtf-llama-300m", 32), ("mamba2-130m", 64), ("hymba-1.5b", 64)]
GEN = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_hybrid_serve_trainer_matches_jax_under_crash():
    spec_kw = serving_spec_kw(model="hymba-1.5b", model_d=64, churn=CRASH)
    jt, jm, tt, tm = run_both(spec_kw)
    assert_same_run(jt, jm, tt, tm)
    assert tt.replay_steps > 0 and tt.stacked_rows > tt.decode_dispatches
    calm = port_trainer(dict(spec_kw, churn=[]))
    calm.params, calm._prompts = tt.params, tt._prompts
    calm.run(spec_kw["iterations"])
    for rid in jt.engine.requests:
        assert tt.token_stream(rid) == calm.token_stream(rid), rid


def _trainer(arch, d_model):
    return port_trainer(serving_spec_kw(model=arch, model_d=d_model))


def _decode(tr, seqs, steps):
    """Prefill ``seqs`` as one cohort and decode them ``steps`` tokens as
    one cohort a token."""
    tr._prefill_cohort(seqs)
    for j in range(steps):
        tr._decode_cohort(seqs, tr.prompt_len + j)


@pytest.mark.parametrize("arch,d_model", MODELS)
def test_stacked_cohort_matches_per_row(arch, d_model, monkeypatch):
    tr = _trainer(arch, d_model)
    logits = []

    def recording(fn):
        def call(*args, **kw):
            out, cache = fn(*args, **kw)
            logits.append(out.clone())
            return out, cache
        return call

    monkeypatch.setattr(serving, "prefill", recording(serving.prefill))
    monkeypatch.setattr(serving, "decode_step", recording(serving.decode_step))
    stacked = [serving._Seq(rid) for rid in range(3)]
    _decode(tr, stacked, GEN)
    assert (tr.prefill_calls, tr.decode_dispatches, tr.stacked_rows) \
        == (1, GEN, 3 * GEN)
    want = torch.stack(logits)                         # (1 + GEN, 3, V)
    for rid, s in enumerate(stacked):
        logits.clear()
        alone = serving._Seq(rid)
        _decode(tr, [alone], GEN)
        assert alone.stream == s.stream
        torch.testing.assert_close(torch.stack(logits)[:, 0], want[:, rid],
                                   **LOGITS)


@pytest.mark.parametrize("arch,d_model", MODELS)
def test_replayed_cache_matches_incremental(arch, d_model):
    tr = _trainer(arch, d_model)
    cohort = [serving._Seq(rid) for rid in range(3)]
    _decode(tr, cohort, GEN)
    moved = serving._Seq(1)
    moved.stream = list(cohort[1].stream)
    tr._replay_cache(moved)
    assert tr.replay_steps == GEN and tr.prefill_calls == 2 and moved.live
    for got, want in zip(leaves(moved.cache), leaves(cohort[1].cache)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, **LOGITS)


@pytest.mark.parametrize("arch,d_model", MODELS)
def test_cohort_dispatch_leaves_other_caches(arch, d_model):
    tr = _trainer(arch, d_model)
    seqs = [serving._Seq(rid) for rid in range(4)]
    tr._prefill_cohort(seqs[:3])
    tr._prefill_cohort(seqs[3:])
    assert all(ax == 1 for ax in tr._axes())           # every leaf (L, B, ...)
    # seqs[2] is a view of the first prefill's tensors, which rows 0 and 1
    # came from too
    before = {s.rid: [x.clone() for x in leaves(s.cache)] for s in seqs[2:]}
    for j in range(3):
        tr._decode_cohort(seqs[:2], tr.prompt_len + j)
    for s in seqs[2:]:
        assert len(s.stream) == 1
        assert all(torch.equal(x, y)
                   for x, y in zip(leaves(s.cache), before[s.rid]))
    # and the decoded rows moved on
    assert all(len(s.stream) == 4 for s in seqs[:2])


def test_old_cohort_caches_are_freed_at_once():
    tr = _trainer("gwtf-llama-300m", 32)
    seqs = [serving._Seq(rid) for rid in range(2)]
    made = []                      # each dispatch's cache storage, weakly
    split = tr._split

    def recording_split(cache, batch):
        made.append([StorageWeakRef(x.untyped_storage()) for x in leaves(cache)])
        return split(cache, batch)

    tr._split = recording_split
    enabled = gc.isenabled()
    gc.disable()
    try:
        tr._prefill_cohort(seqs)
        for j in range(3):
            tr._decode_cohort(seqs, tr.prompt_len + j)
            # the rows now live in the newest tensors; every older one is gone
            assert not any(r.expired() for r in made[-1])
            assert all(r.expired() for refs in made[:-1] for r in refs), j
    finally:
        if enabled:
            gc.enable()
