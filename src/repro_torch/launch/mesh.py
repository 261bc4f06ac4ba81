"""Device meshes for the dry-run and for one card.

``make_production_mesh`` is a FUNCTION (not module-level state), so
importing this module starts no process group: the dry-run's own process
sets up a fake one of 256 or 512 ranks (the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=512``), and nothing else
ever sees it.

The fake process group comes from ``torch.testing._internal``, a private
module of PyTorch; this is the one place that imports it, and the dry-run
records the torch version it ran against.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["HostMesh", "make_fake_mesh", "make_host_mesh", "make_production_mesh",
           "release_process_group"]


def _fake_process_group(world_size: int) -> None:
    """A ``torch.distributed`` group of ``world_size`` ranks in this one
    process (rank 0): collectives return without moving data, so a DTensor
    program runs as rank 0's share of it.  An existing group of that size is
    kept."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks "
                               f"exists; the mesh needs {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def release_process_group() -> None:
    """Destroy the process group, if one is set up."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def make_fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the fake process
    group of that many ranks, set up when none exists."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    _fake_process_group(n)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16×16 = 256 cards (data, model).  Multi-pod: 2×16×16 =
    512 cards (pod, data, model); the pod axis is the slow inter-pod network."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


@dataclass(frozen=True)
class HostMesh:
    """One card as a 1×1 (data, model) mesh: the ``shape`` and axis names the
    sharding rules read, no devices and no process group.  On it every
    placement is whole, so a step is counted on plain tensors."""
    shape: tuple[int, ...] = (1, 1)
    mesh_dim_names: tuple[str, ...] = ("data", "model")

    def size(self) -> int:
        return 1


def make_host_mesh() -> HostMesh:
    """One card as a 1×1 (data, model) mesh, for counting a step as one card
    runs it; it needs no process group."""
    return HostMesh()
