"""Production mesh construction, and the H100's constants.

Port of ``repro.launch.mesh``.  FUNCTIONS, not module-level meshes:
importing this module initialises no process group and touches no CUDA
state (the dry run sets up a fake process group of 256 or 512 ranks
first, in its own process).

Single pod : (16, 16)    axes (data, model)       = 256 cards
Multi-pod  : (2, 16, 16) axes (pod, data, model)  = 512 cards

Both take the default process group the caller has initialised (the
dry run's fake one, or a real one of that many ranks) and return a
``DeviceMesh`` over it.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """(1, n) over the default group's n ranks, one card each (tests and
    smoke runs: a group of world size 1 on one card gives (1, 1))."""
    n = dist.get_world_size()
    return init_device_mesh(device_type, (1, n),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh: DeviceMesh) -> dict:
    """``{axis name: size}``, as ``dict(zip(mesh.axis_names,
    mesh.devices.shape))`` in the JAX package."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# NVIDIA H100 SXM5 data sheet, per card: dense bf16 tensor-core rate, HBM3
# rate and capacity (the rate chip_smoke.py's bounds use), and one NVLink 4
# link (900 GB/s over 18 links), which stands where the JAX package's
# per-link ICI rate stands
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # bytes/s
HBM_BYTES = 80e9                  # bytes
LINK_BW = 50e9                    # bytes/s per link

