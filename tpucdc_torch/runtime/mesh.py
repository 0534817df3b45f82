"""The ``(data, model)`` mesh over ``torch.distributed``, mirroring
tpucdc/runtime/mesh.py.

JAX's mesh is a grid of devices that one program drives. The port runs one
process per card (SPMD over processes), so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of ranks: each rank has its
coordinates and a process group per axis. Every entry point that takes a
mesh is called by every rank of it, each rank issues the same collectives in
the same order, and each returns the same result; only rank 0 writes logs,
checkpoints and CLI output.

Training and the batched decode shard the batch over the ``data`` axis; the
``model`` axis (size 1 by default) carries the ``"tensor"`` state sharding
of ``parallel.tp_rules``.

The JAX package's ``data_sharding`` and ``replicated_sharding`` build
``NamedSharding`` objects that tell XLA where an array lives; a tensor of
the port lives on its rank's card, so they have no counterpart:
``shard_batch`` takes the rank's slice itself and ``replicate`` broadcasts.
"""

from __future__ import annotations

import os

import torch

from tpucdc_torch.runtime.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def local_device_count() -> int:
    """The cards on this host; the port runs one process on each."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_mesh(n_data: int | None = None, n_model: int = 1, device="cuda"):
    """A ``(data, model)`` DeviceMesh over the first ``n_data·n_model``
    ranks, on ``device``'s type (the card unless the caller passes "cpu").

    ``n_data`` defaults to the world size over ``n_model``. Where no process
    group exists and the environment names no world of several processes,
    this process forms a world of 1 on an in-memory store (NCCL on the
    card, gloo on the CPU), so ``fit(mesh=make_mesh())`` runs alone as the
    JAX package's does on one device. Where the environment names several
    (``WORLD_SIZE`` or ``TPUCDC_NUM_PROCESSES`` above 1) but this process
    has not joined them (``runtime.maybe_init_distributed``), it raises
    RuntimeError rather than run alone. Raises ValueError when the mesh
    wants more ranks than the world has.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    if not dist.is_initialized():
        named = max(int(os.environ.get(key) or 1) for key in
                    ("WORLD_SIZE", "TPUCDC_NUM_PROCESSES"))
        if named > 1:
            raise RuntimeError(
                f"the environment names a world of {named} processes that "
                f"this one has not joined: call "
                f"runtime.maybe_init_distributed first")
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    n = n_data * n_model
    if n > world:
        raise ValueError(
            f"mesh wants {n} ranks ({n_data}x{n_model}) but only {world} "
            f"available")
    return DeviceMesh(device.type, torch.arange(n).reshape(n_data, n_model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def is_rank0() -> bool:
    """Whether this process writes: rank 0 of the world, or the only
    process when there is no process group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``; raises for a rank outside the
    mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return int(coord[mesh.mesh_dim_names.index(axis)])


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh):
    """This rank's slice of the leading dim of every array in ``batch`` (a
    tensor, an array, or a dict/list/tuple of them) over the data axis.
    Raises ValueError unless the batch divides by the data axis."""
    n = axis_size(mesh, DATA_AXIS)
    i = axis_index(mesh, DATA_AXIS)

    def take(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by data axis {n}")
        return x[i * (b // n):(i + 1) * (b // n)]
    return _map(take, batch)


@torch.no_grad()
def replicate(tree, mesh):
    """Every tensor of ``tree`` (a tensor, a module's parameters and
    buffers, or a dict/list/tuple of tensors) set to rank 0's value, in
    place, by a broadcast over the world, whose first ranks ``mesh`` holds;
    returns ``tree``. Every rank calls it."""
    import torch.distributed as dist

    leaves = []
    if isinstance(tree, torch.nn.Module):
        leaves = list(tree.state_dict().values())
    else:
        _map(leaves.append, tree)
    for t in leaves:
        dist.broadcast(t, src=0)
    return tree
