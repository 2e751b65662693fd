"""Meshes (port of ``repro.launch.mesh``).

``make_local_mesh`` builds a torch ``DeviceMesh`` of axes (data, model) over
the default process group, one rank a device; with no process group it
returns ``None``, the world of one process that every model runs in without
DTensors, as ``make_shard_fn(None, ...)`` is the identity.

``make_production_mesh`` returns a mesh *description*: the production
slice's axis names and sizes, (16, 16) as (data, model) or (2, 16, 16) as
(pod, data, model), with no devices behind it.  The sharding rules read only
names and sizes, so they place the full-size configurations on it where no
process group of 256 or 512 ranks can be built by real processes.

``make_fake_mesh`` builds that slice as a real ``DeviceMesh`` over torch's
"fake" process-group backend: one process stands as rank 0 of 256 or 512,
and every collective returns at once without moving data.  The dry run
(``launch/dryrun.py``) traces a step on it with fake tensors.  Its device
type is "cpu": on a torch built for the CPU only, ``bmm``, ``contiguous``
of a view and ``distribute_tensor`` on fake "cuda" tensors raise.

``H100`` holds the card's figures the dry run's roofline uses.
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


# NVIDIA H100 SXM5 data sheet (dense rates, no sparsity, at 700 W), and a
# node of 8 cards: NVLink 4 at 900 GB/s both ways a card (450e9 one way),
# one ConnectX-7 400 Gb/s InfiniBand port a card (50e9 B/s) across nodes.
H100 = {
    "peak_flops": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12},
    "hbm_bw": 3.35e12,          # bytes/s, HBM3
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,         # bytes/s a card, one direction
    "ib_bw": 50e9,              # bytes/s a card
    "node_size": 8,             # cards joined by NVLink
    "sm_count": 132,
}


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


def make_fake_mesh(multi_pod: bool = False):
    """The production slice as a ``DeviceMesh`` of device type "cpu" over a
    fake process group of 256 or 512 ranks, this process rank 0: (16, 16) as
    (data, model), or (2, 16, 16) as (pod, data, model).  It initialises the
    group, so one process holds one such mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    desc = make_production_mesh(multi_pod=multi_pod)
    world = 1
    for n in desc.sizes:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return init_device_mesh("cpu", desc.sizes, mesh_dim_names=desc.axis_names)
