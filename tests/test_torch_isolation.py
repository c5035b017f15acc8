"""The port imports neither JAX nor anything of the JAX package.

In a fresh interpreter whose ``sys.meta_path`` refuses ``jax``, ``jaxlib``
and ``repro`` (matched on the whole first name, so ``repro_torch`` passes),
every module of ``repro_torch`` and ``chip_smoke.py`` import, and importing
``chip_smoke.py`` builds, loads and launches no kernel.
"""
import os
import subprocess
import sys
from pathlib import Path

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
for name in names:
    importlib.import_module(name)

spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)

from repro_torch.kernels import flash_attention, ops, ssd_scan
for lib in (flash_attention.LIBRARY, flash_attention.SM90_LIBRARY,
            ssd_scan.LIBRARY):
    assert lib.lib is None and lib.build_seconds is None
assert not any(flash_attention.BODY_LAUNCHES.values())
assert ops.flash_attention.launches == 0 and ops.ssd_scan.launches == 0
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names))
"""


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", CHECK,
                           str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    assert n >= 15, proc.stdout
