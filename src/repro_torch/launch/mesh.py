"""Meshes (port of ``repro.launch.mesh``).

``make_local_mesh`` builds a torch ``DeviceMesh`` of axes (data, model) over
the default process group, one rank a device; with no process group it
returns ``None``, the world of one process that every model runs in without
DTensors, as ``make_shard_fn(None, ...)`` is the identity.

A departure from JAX: JAX's ``make_local_mesh`` takes every local device
into one process.  The port runs one process a card, started by
``torchrun`` (``python -m torch.distributed.run --standalone
--nproc-per-node N -m repro_torch.launch.train|serve``).  Under it
``init_from_env`` starts the process group from torchrun's ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` (NCCL for the card, gloo for the CPU) and
names the rank's card, ``cuda:LOCAL_RANK``; the entry points then build
their mesh over that group.  Without torchrun's variables nothing changes:
one process, one card, no mesh.  ``rank_device`` gives the device an entry
point runs on, the rank's own card under a process group.

``make_production_mesh`` returns a mesh *description*: the production
slice's axis names and sizes, (16, 16) as (data, model) or (2, 16, 16) as
(pod, data, model), with no devices behind it.  The sharding rules read only
names and sizes, so they place the full-size configurations on it where no
process group of 256 or 512 ranks can be built by real processes.

``make_fake_mesh`` builds that slice, or a (data, model) mesh of any shape,
as a real ``DeviceMesh`` over torch's "fake" process-group backend: one
process stands as rank 0 of them all, and every collective returns at once
without moving data.  The dry run
(``launch/dryrun.py``) traces a step on it with fake tensors.  Its device
type is "cpu": on a torch built for the CPU only, ``bmm``, ``contiguous``
of a view and ``distribute_tensor`` on fake "cuda" tensors raise.

``H100`` holds the card's figures the dry run's roofline uses.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
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


def make_fake_mesh(multi_pod: bool = False,
                   shape: Optional[Tuple[int, ...]] = None,
                   device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``device_type`` over a fake process group, this
    process rank 0: the production slice, (16, 16) as (data, model) or
    (2, 16, 16) as (pod, data, model); or, given ``shape``, a (data, model)
    mesh of that shape (a host's cards, for instance (2, 2)).  It
    initialises the group, so one process holds one such mesh.  A "cuda"
    mesh needs a CUDA build of torch (its fake tensors are "cuda" ones) and
    dispatches DTensor's collectives as on the cards; the counter counts
    the same on both (``op_analysis``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if shape is None:
        desc = make_production_mesh(multi_pod=multi_pod)
    else:
        desc = MeshDesc(("data", "model"), tuple(shape))
    world = 1
    for n in desc.sizes:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return init_device_mesh(device_type, desc.sizes,
                            mesh_dim_names=desc.axis_names)


def torchrun_env() -> Optional[Tuple[int, int, int, int]]:
    """(rank, world size, local rank, local world size) from the variables
    torchrun sets, or ``None`` where they are not set."""
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        return None
    world = int(os.environ["WORLD_SIZE"])
    return (int(os.environ["RANK"]), world, int(os.environ["LOCAL_RANK"]),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def _check_cards(local_world: int) -> None:
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise RuntimeError(f"{local_world} ranks on this host, one a card, "
                           f"and {cards} CUDA devices visible")


def init_from_env(device: Optional[str] = None) -> Optional[str]:
    """Under torchrun: the default process group started from its
    variables, NCCL where ``device`` is the card (``None`` or "cuda"), gloo
    where it is "cpu"; on the card ``torch.cuda.set_device(LOCAL_RANK)``.
    Returns the device this rank runs on: "cuda:LOCAL_RANK", or "cpu".
    Without torchrun's variables, or with a group already started, it does
    nothing and returns ``device``.  It raises where the host has fewer
    cards than ranks; it never falls back to gloo or the CPU."""
    env = torchrun_env()
    if env is None or dist.is_initialized():
        return device
    _, _, local, local_world = env
    kind = torch.device(device or "cuda").type
    if kind == "cuda":
        _check_cards(local_world)
        card = torch.device("cuda", local)
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", device_id=card)
        return str(card)
    if kind != "cpu":
        raise ValueError(f"no process group for device {device!r}")
    dist.init_process_group("gloo")
    return "cpu"


def rank_device(device: Optional[str] = None) -> torch.device:
    """The device an entry point runs on: ``device``, the card where it is
    ``None``.  Under a process group a bare "cuda" is this rank's own card
    (``LOCAL_RANK``, else the current device), and a host with fewer cards
    than ranks raises."""
    dev = torch.device(device or "cuda")
    if dev.type != "cuda" or dev.index is not None or \
            not dist.is_initialized():
        return dev
    env = torchrun_env()
    _check_cards(env[3] if env else dist.get_world_size())
    return torch.device("cuda", env[2] if env
                        else torch.cuda.current_device())


def destroy() -> None:
    """The default process group destroyed, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
