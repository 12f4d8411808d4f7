"""Meshes of the port (port of ``repro/launch/mesh.py``), and the H100's
peaks that the roofline reads.

Production: a shape-only mesh (axis names and sizes, no devices):
    single pod  (16, 16)     axes ("data", "model")
    multi-pod   (2, 16, 16)  axes ("pod", "data", "model")
The sharding rules (``launch.sharding``) and the roofline read it; one
card cannot build a 256-rank mesh, and none is faked.

Real: ``make_host_mesh()`` and ``make_sim_mesh(n)`` return a
``torch.distributed.device_mesh.DeviceMesh`` over the current process
group, in rank order.  With no process group, the ranks of a launcher
(``torchrun --nproc-per-node=<n>``) join at its address, and a process
started alone starts a 1-rank group in-process (gloo for the CPU, NCCL
for the card, on a ``HashStore``); ``torch.multiprocessing.spawn`` with
``init_process_group`` gives ranks too.

Every reader takes a mesh through :func:`axes_of`: a shape-only mesh, a
``DeviceMesh``, or any object with ``axis_names`` and a ``shape``
mapping (the reference tests' fakes).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

# NVIDIA H100 SXM, data sheet peaks (dense, 700 W); a card set below 700 W
# runs slower under load
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, CUDA cores (no TF32)
HBM_BW = 3.35e12                  # bytes/s
NVLINK_BW = 450e9                 # bytes/s a direction (900 GB/s both)

# what ``torchrun`` sets in each rank's environment
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh of axis names and sizes only: what the sharding rules and
    the roofline read of the production layouts."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axes_of(mesh) -> Dict[str, int]:
    """{axis name: size} of any mesh the port reads."""
    if isinstance(mesh, dist.device_mesh.DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    return ShapeMesh(("data", "model"), (16, 16))


def _launched() -> bool:
    """A launcher (``torchrun``) started this process as one of its ranks."""
    return all(k in os.environ for k in _LAUNCHER_ENV)


def ensure_process_group(device=None) -> bool:
    """Start the process group when none exists (gloo for the CPU, NCCL
    for the card); True when this call started it.  Under a launcher the
    rank joins its ranks at the launcher's address (on the card, the
    device of its ``LOCAL_RANK``); otherwise a 1-rank group starts
    in-process on a ``HashStore``.  A failed NCCL start raises: there is
    no gloo fallback for the card."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    launched = _launched()
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              if launched else dev.index or 0)
    if launched:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_host_mesh(device=None):
    """("data", "model") = (world, 1) over every rank of the process
    group (a 1-rank group on this host when there is none)."""
    ensure_process_group(device)
    n = dist.get_world_size()
    return dist.device_mesh.DeviceMesh(
        _device_type(), torch.arange(n).reshape(n, 1),
        mesh_dim_names=("data", "model"))


def make_sim_mesh(n: int, device=None):
    """n-way "data" mesh over ranks 0 … n − 1, in rank order.

    The process group must have exactly ``n`` ranks; with none, a
    launcher's ranks join theirs and n = 1 starts a 1-rank group
    in-process.  Ranks are processes, so a mesh of more than one needs a
    launcher: the error names it.
    """
    if n < 1:
        raise ValueError(f"make_sim_mesh: need n >= 1 shards, got {n}")
    if not dist.is_initialized() and (n == 1 or _launched()):
        ensure_process_group(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        # the copy-pasteable launch, as ONE unbroken token
        hint = f"torchrun --nproc-per-node={n}"
        raise ValueError(
            f"make_sim_mesh({n}): this process group has {world} rank(s). "
            f"Launch {n} ranks with {hint} (or torch.multiprocessing.spawn "
            f"and init_process_group(world_size={n})) — each rank is one "
            "process, so the count is fixed when the group starts; "
            "tests/test_torch_mesh_lane.py spawns gloo ranks on the CPU.")
    return dist.device_mesh.DeviceMesh(_device_type(), torch.arange(n),
                                       mesh_dim_names=("data",))


def data_axes(mesh) -> tuple:
    """The batch-sharding axes: ("pod", "data") on multi-pod else
    ("data",)."""
    return tuple(a for a in axes_of(mesh) if a in ("pod", "data"))


def axis_size(mesh, name: str) -> int:
    return axes_of(mesh).get(name, 1)


def mesh_size(mesh) -> int:
    n = 1
    for s in axes_of(mesh).values():
        n *= s
    return n
