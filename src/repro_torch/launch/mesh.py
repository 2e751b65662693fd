"""Meshes (port of ``repro.launch.mesh``).

``make_local_mesh`` builds a torch ``DeviceMesh`` of axes (data, model) over
the default process group, one rank a device; with no process group it
returns ``None``, the world of one process that every model runs in without
DTensors, as ``make_shard_fn(None, ...)`` is the identity.

``make_production_mesh`` returns a mesh *description*: the production
slice's axis names and sizes, (16, 16) as (data, model) or (2, 16, 16) as
(pod, data, model), with no devices behind it.  The sharding rules read only
names and sizes, so they place the full-size configurations on it where no
process group of 256 or 512 ranks can be built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch.distributed as dist


@dataclass(frozen=True)
class MeshDesc:
    """Axis names and sizes of a mesh, as ``jax.sharding.Mesh`` names them:
    ``axis_names`` in order, ``shape`` a mapping of name to size."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshDesc:
    if multi_pod:
        return MeshDesc(("pod", "data", "model"), (2, 16, 16))
    return MeshDesc(("data", "model"), (16, 16))


def make_local_mesh(model_axis: int = 1, device_type: Optional[str] = None):
    """The default process group's ranks as (world // model_axis,
    model_axis) — ``None`` when there is no process group.  ``device_type``
    defaults to "cuda" under NCCL and "cpu" otherwise."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    assert world % model_axis == 0, (world, model_axis)
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
