"""The Moonlight cell's driver (``drivers/train_mla_moe.py``) at a reduced
size on the CPU: it runs ``correct`` through the harness, reads the
expert-load counter in a traced run, turns ``correct`` false under a
broken step, refuses a program that cannot build the model, and its
control reads far above the program; ``tools/moe_choice_flips.py`` replays the program's choices in the
reference call for call; the counts of ``flops_mla_moe`` by hand; the
reference imports nothing of the program."""
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from perfbench import flops_mla_moe, harness  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

CELL = "moonlight-5l-train-calm"
CONFIG = {"num_layers": 3, "d_model": 64, "num_heads": 2, "head_dim": 24, "d_ff": 32,
          "vocab_size": 256, "num_experts": 8, "num_experts_per_tok": 2,
          "num_shared_experts": 1, "dense_d_ff": 128, "kv_lora_rank": 32,
          "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
          "param_dtype": "float32"}
WORKLOAD = {"seq_len": 16, "batch": 2, "microbatches": 2}


def _cell():
    return harness.load_cell(CELL, overrides={"config": CONFIG, "workload": WORKLOAD})


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_at_a_reduced_size(trace):
    cell = _cell()
    line, run = tiny.execute(cell, trace=trace)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == set(cell.workload["limits"]) == {"grad_gap", "change_gap"}
    if trace:
        # the only program counter of the cell, read off the card too
        assert line["metrics"]["expert_load_max.train"]["value"] >= 1.0
    else:
        assert line["metrics"] == {}


def _unchanged(monkeypatch):
    from repro_torch.core.runtime.trainer import RuntimeTrainer
    monkeypatch.setattr(RuntimeTrainer, "_apply_update", lambda self, *a: None)


def _half_batch(monkeypatch):
    from repro_torch.core.runtime.trainer import RuntimeTrainer
    execute = RuntimeTrainer._execute

    def half(self, res, *a, **k):
        res.completed = res.completed[::2]
        return execute(self, res, *a, **k)
    monkeypatch.setattr(RuntimeTrainer, "_execute", half)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line, _ = tiny.execute(_cell())
    assert line["correct"] is False


def test_a_program_that_lacks_a_model_key_is_refused_at_once(monkeypatch):
    cell = _cell()
    drv = harness.driver(cell)
    monkeypatch.setattr(drv, "MODEL_KEYS", drv.MODEL_KEYS + ("no_such_key",))
    cell.config["no_such_key"] = 1
    run = harness.Run(device="cpu", seed=3, seconds=0.0, trace=False, t0=time.perf_counter())
    with pytest.raises(SystemExit, match="no_such_key"):
        drv.run(cell, run)
    assert run.attempted == 0 and time.perf_counter() - run.t0 < 5


def test_the_control_reads_far_above_the_program():
    cell = _cell()
    drv = harness.driver(cell)
    run = harness.Run(device="cpu", seed=11, seconds=0.0, trace=False, t0=time.perf_counter())
    got = drv.controls(cell, run, drv.run(cell, run))
    prog, ctrl = got["program"], got["control"]
    assert any(ctrl[k] > 10 * max(prog[k], 1e-6) for k in prog), got
    assert got["state_unchanged"]["change_gap"] == 1.0


def test_the_flip_tool_replays_the_programs_choices_call_for_call():
    """In f32 on the CPU both sides choose alike: replaying the program's
    recorded choices in the reference moves nothing, which holds only if
    each call gets its own rows."""
    tool = harness.load_file(harness.ROOT / "tools" / "moe_choice_flips.py", "moe_choice_flips")
    got = tool.readings(_cell(), 2**31 + 29, "cpu")
    assert got["differ_share_mean"] == 0.0 and len(got["layers"]) == 2
    assert got["gaps_replaying_choices"] == got["gaps"]
    assert got["flips_alone"] == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}


def test_flops_by_hand():
    cfg = {"num_layers": 2, "first_dense_layers": 1, "d_model": 8, "num_heads": 2,
           "qk_nope_head_dim": 3, "qk_rope_head_dim": 1, "v_head_dim": 2, "kv_lora_rank": 4,
           "dense_d_ff": 16, "num_experts": 4, "num_experts_per_tok": 2,
           "num_shared_experts": 1, "d_ff": 5, "vocab_size": 10}
    # MLA: 8x8 + 8x5 + 4x10 + 4x8 = 64 + 40 + 40 + 32 = 176 a layer
    assert flops_mla_moe.mla_params(cfg) == 176
    # 2 x 176 + dense 3x8x16 = 384 + moe (router 32 + 3 experts x 3x8x5 = 360) + head 80
    assert flops_mla_moe.active_params(cfg) == 352 + 384 + 392 + 80
    # causal S = 3: 6 pairs x 2 heads x (2 x 4 + 2 x 2) = 144 a layer
    assert flops_mla_moe.attention_flops(cfg, 3) == 144
    assert flops_mla_moe.train_flops(cfg, 2, 3) == 2 * (6 * 1208 * 3 + 3 * 2 * 144)
    assert flops_mla_moe.expert_forward_flops(cfg, 7) == 2 * 14 * 3 * 8 * 5
    assert flops_mla_moe.expert_forward_bytes(cfg, 7) == 2 * (3 * 4 * 8 * 5 + 14 * (16 + 20 + 8))


def test_the_reference_and_counts_load_nothing_of_the_program():
    code = ("import sys\n"
            "from perfbench.reference import mla_moe\n"
            "from perfbench import flops_mla_moe\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
