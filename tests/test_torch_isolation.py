"""The port imports neither JAX nor anything of the JAX package.

In a fresh interpreter whose ``sys.meta_path`` refuses ``jax``, ``jaxlib``
and ``repro`` (matched on the whole first name, so ``repro_torch`` passes),
every module of ``repro_torch``, ``chip_smoke.py`` and the port's examples
(``examples/torch_*.py``) import, and importing ``chip_smoke.py`` builds,
loads and launches no kernel.  The training
path's, the flow-routed serving path's and the scenario harness's
modules, the copies of the numpy flow/sim/scenario/data modules among
them, the VLM and audio configs, ``launch/steps.py``, the frozen
reference trainer and the multi-device launch layer (``launch.mesh``,
``specs``, ``dryrun``, ``trace_analysis``, ``parallel.sharding``,
``core.podmap``) are on the list; after the imports no process group
exists (importing ``launch.dryrun`` sets up none).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

CHECK = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "repro"}


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
import repro_torch

names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
TRAINING = ["checkpoint.store", "core.executor", "core.flow.decentralized",
            "core.flow.graph", "core.flow.mincost", "core.runtime.activations",
            "core.runtime.cache", "core.runtime.recovery",
            "core.runtime.stages", "core.runtime.trainer", "core.sim.faults",
            "core.sim.policies", "core.sim.timeline", "core.swarm",
            "data.pipeline", "launch.train", "optim.adamw", "tree",
            # the flow-routed serving slice
            "core.sim.engine", "core.sim.metrics", "core.sim.facade",
            "core.flow.reference", "core.scenarios.generate",
            "core.runtime.serving",
            # the scenario harness and the remaining numpy copies
            "core.scenarios.harness", "core.scenarios.corpus",
            "core.flow.hierarchy", "core.sim.reference", "core.simulator",
            "core.join", "core.membership",
            # the rest of the dense family and the MoE models
            "models.moe", "configs.qwen1_5_4b", "configs.starcoder2_7b",
            "configs.gwtf_llama_7b", "configs.gemma_7b",
            "configs.granite_moe_3b_a800m", "configs.qwen2_moe_a2_7b",
            # the VLM and audio models, single-program training, the
            # frozen reference trainer
            "configs.musicgen_medium", "configs.llama3_2_vision_90b",
            "launch.steps", "core.runtime.reference",
            # the multi-device launch layer and pod mapping
            "launch.mesh", "launch.specs", "launch.dryrun",
            "launch.trace_analysis", "parallel.sharding", "core.podmap"]
missing = [m for m in TRAINING if "repro_torch." + m not in names]
assert not missing, missing
for name in names:
    importlib.import_module(name)

for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"script_{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))

from repro_torch.kernels import flash_attention, ops, ssd_scan
for lib in (flash_attention.LIBRARY, flash_attention.SM90_LIBRARY,
            flash_attention.BWD_LIBRARY, ssd_scan.LIBRARY):
    assert lib.lib is None and lib.build_seconds is None
assert not any(flash_attention.BODY_LAUNCHES.values())
assert ops.flash_attention.launches == 0 and ops.ssd_scan.launches == 0
assert ops.flash_attention_bwd.launches == 0
import torch.distributed as dist
assert not dist.is_initialized()     # importing launch.dryrun sets up no group
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names))
"""
EXAMPLES = ["torch_quickstart.py", "torch_decentralized_train.py",
            "torch_serve_decode.py", "torch_scenario_tour.py",
            "torch_churn_recovery.py", "torch_pod_slicing.py"]


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", CHECK,
                           str(ROOT / "chip_smoke.py"),
                           *(str(ROOT / "examples" / e) for e in EXAMPLES)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    assert n >= 61, proc.stdout
