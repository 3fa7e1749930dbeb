"""Mesh shapes and device meshes (counterpart of `repro.launch.mesh`).

The sharding rules read a mesh's axis names and sizes and nothing else, so
they take a `MeshShape`: plain Python, at any size, with no devices (the
dry run's 16 x 16 and 2 x 16 x 16 production meshes are shapes only).
`make_mesh` and `make_local_mesh` build a `torch.distributed` DeviceMesh
over the ranks of the process group.  Importing this module touches no
device and no process group.
"""
from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch import resolve_device


@dataclass(frozen=True)
class MeshShape:
    """Axis names, major to minor, and their sizes."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")
        if any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes must be positive, not {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        """The dry run's name of the mesh: "16x16", "2x16x16"."""
        return "x".join(str(n) for n in self.sizes)

    @classmethod
    def of(cls, device_mesh) -> "MeshShape":
        return cls(tuple(device_mesh.mesh_dim_names), tuple(device_mesh.shape))


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh: 16 x 16 ("data", "model"), or 2 x 16
    x 16 ("pod", "data", "model") across two pods."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


LOCAL_MESH_SHAPE = MeshShape(("data", "model"), (1, 1))


def make_mesh(shape: MeshShape, device="cuda"):
    """A DeviceMesh of `shape` over every rank of the initialised process
    group (rank r at the r-th position of the mesh in row-major order).
    Raises if no group is initialised or its size is not the mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or torchrun)")
    world = dist.get_world_size()
    if world != shape.size:
        raise ValueError(f"a {shape.name} mesh needs {shape.size} ranks; the process "
                         f"group has {world}")
    return init_device_mesh(dev.type, shape.sizes, mesh_dim_names=shape.axis_names)


def make_local_mesh(device="cuda"):
    """A 1 x 1 mesh with the production axis names.  With no process group
    initialised, it starts a world of one (NCCL on a card, gloo on the CPU)
    through a file store in a new temporary directory: no TCP port."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{store}", world_size=1, rank=0)
    return make_mesh(LOCAL_MESH_SHAPE, dev)
