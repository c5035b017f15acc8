"""Pod-slice scheduling in the port: JAX's ``tests/test_podmap.py`` cases,
the flows held to JAX's exactly, and the example.

The port prices slices with the H100's constants (``launch/mesh.py``);
with the JAX package's v5e constants patched into the port's module
(``PEAK_FLOPS_BF16`` 197e12, the link 50e9 bytes/s) both packages
schedule the same flows, at the same max edge cost, before and after a
slice is lost.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import podmap as jpodmap  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import podmap  # noqa: E402
from repro_torch.core.podmap import (carve_pod, ici_hop_distance,  # noqa: E402
                                     lose_slice, pod_flow_network,
                                     schedule_pipelines)

ROOT = Path(__file__).resolve().parents[1]


def test_carve_pod():
    slices = carve_pod((16, 16), (4, 4))
    assert len(slices) == 16
    assert all(s.chips == 16 for s in slices)


def test_torus_distance_symmetric_and_wrapping():
    slices = carve_pod((16, 16), (4, 4))
    a, b = slices[0], slices[3]          # opposite edge: torus wrap
    assert ici_hop_distance(a, b) == ici_hop_distance(b, a)
    # wrap-around shorter than straight-line
    assert ici_hop_distance(a, b) <= 12


def test_schedule_builds_flows():
    cfg = get_config("gemma-7b")
    proto, net = schedule_pipelines(cfg, num_stages=5, seed=0)
    flows = proto.complete_flows()
    assert len(flows) >= 4
    for f in flows:
        assert f[0] == f[-1] == 0                # back to the data slice
        stages = [net.nodes[n].stage for n in f[1:-1]]
        assert stages == sorted(stages)          # stage order


def test_slice_preemption_repair():
    cfg = get_config("gemma-7b")
    proto, net = schedule_pipelines(cfg, num_stages=5, seed=1)
    before = proto.complete_flows()
    victim = before[0][2]
    after = lose_slice(proto, net, victim)
    assert after, "no flows survived repair"
    assert all(victim not in f for f in after)


def test_data_slice_loss_rejected():
    cfg = get_config("tinyllama-1.1b")
    proto, net = schedule_pipelines(cfg, num_stages=3, seed=2)
    with pytest.raises(ValueError):
        lose_slice(proto, net, 0)


def test_costs_scale_with_model():
    small = get_config("tinyllama-1.1b")
    big = get_config("gemma-7b")
    n_small = pod_flow_network(small, num_stages=5, microbatch_tokens=4096)
    n_big = pod_flow_network(big, num_stages=5, microbatch_tokens=4096)
    # bigger model -> higher compute cost per slice
    assert (n_big.nodes[1].compute_cost > n_small.nodes[1].compute_cost)


@pytest.mark.parametrize("arch,stages,seed", [("gemma-7b", 5, 0),
                                              ("gemma-7b", 5, 1),
                                              ("tinyllama-1.1b", 3, 2),
                                              ("qwen2-moe-a2.7b", 4, 3)])
def test_flows_equal_jax_with_its_constants(arch, stages, seed, monkeypatch):
    monkeypatch.setattr(podmap, "PEAK_FLOPS_BF16", jmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(podmap, "LINK_BW", jmesh.ICI_BW)
    jproto, jnet = jpodmap.schedule_pipelines(jax_config(arch),
                                              num_stages=stages, seed=seed)
    proto, net = schedule_pipelines(get_config(arch), num_stages=stages,
                                    seed=seed)
    assert proto.complete_flows() == jproto.complete_flows()
    assert proto.max_edge_cost() == jproto.max_edge_cost()
    victim = jproto.complete_flows()[0][2]
    assert (lose_slice(proto, net, victim)
            == jpodmap.lose_slice(jproto, jnet, victim))
    assert proto.max_edge_cost() == jproto.max_edge_cost()


def test_h100_constants_change_the_costs():
    """Unpatched, the port prices compute at the H100's rate."""
    cfg = get_config("gemma-7b")
    mine = pod_flow_network(cfg, num_stages=5, microbatch_tokens=4096)
    theirs = jpodmap.pod_flow_network(jax_config("gemma-7b"), num_stages=5,
                                      microbatch_tokens=4096)
    ratio = theirs.nodes[1].compute_cost / mine.nodes[1].compute_cost
    assert ratio == pytest.approx(989e12 / 197e12)


def test_example_runs():
    out = subprocess.run([sys.executable, str(ROOT / "examples" /
                                              "torch_pod_slicing.py")],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "pipeline flows across 5 stages" in out.stdout
    assert "repaired:" in out.stdout and ": True" in out.stdout
