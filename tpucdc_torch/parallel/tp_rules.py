"""The ``"tensor"`` state sharding over the ``model`` mesh axis, mirroring
tpucdc/parallel/tp_rules.py.

The rule is the JAX package's, leaf by leaf: a leaf whose LAST flax axis
divides by the model axis's size into slices of at least ``min_factor``
elements is sharded on that axis, so conv kernels and dense weights split by
output channel. It applies alike to the parameters, their EMA and both
optimizers' moments (same shapes); step counts stay replicated. With
``n_model == 1`` every leaf is replicated.

The port's tensors are not laid out as flax's: the flax axis lives on the
dim that ``utils.weights.jax_last_axis`` names (dim 0 of a conv or dense
weight, dim 1 of a transposed conv's, the last dim of every other leaf).

Where XLA partitions the compute of a sharded state too, the port keeps the
compute whole on every rank: each rank holds its slice of every sharded
leaf of the EMA and the moments, and the parameters' authoritative slice;
before the forward the full weights are gathered over the model group
(``ShardPlan.gather``), and after the gradient mean each rank keeps its
slice of every gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpucdc_torch.runtime.mesh import (MODEL_AXIS, axis_group, axis_index,
                                       axis_size)
from tpucdc_torch.utils.weights import jax_last_axis


def leaf_spec(shape, n_model: int, min_factor: int = 2) -> tuple:
    """The JAX package's PartitionSpec of a flax-layout ``shape``, as a
    tuple: the last axis on ``"model"`` when it splits evenly into slices of
    at least ``min_factor`` elements, else () (replicated)."""
    if (n_model > 1 and len(shape) >= 1 and shape[-1] % n_model == 0
            and shape[-1] >= min_factor * n_model):
        return (*([None] * (len(shape) - 1)), MODEL_AXIS)
    return ()


def shard_dim(name: str, shape, n_model: int,
              min_factor: int = 2) -> Optional[int]:
    """The dim of the port's parameter ``name`` (of ``shape``) that the
    rule shards, or None."""
    if not len(shape):
        return None
    dim = jax_last_axis(name, len(shape))
    return dim if leaf_spec((shape[dim],), n_model, min_factor) else None


def _named(model_or_state) -> dict:
    model = getattr(model_or_state, "model", model_or_state)
    if isinstance(model, torch.nn.Module):
        return dict(model.named_parameters())
    return dict(model)


def tree_shardings(model_or_state, mesh) -> dict:
    """Parameter name → the dim sharded over the model axis, or None, for a
    model, a TrainState or a name → tensor dict. ``mesh`` is a DeviceMesh,
    or the model axis's size."""
    n_model = mesh if isinstance(mesh, int) else axis_size(mesh, MODEL_AXIS)
    return {name: shard_dim(name, p.shape, n_model)
            for name, p in _named(model_or_state).items()}


class ShardPlan:
    """Which dim of each parameter this rank holds a slice of, and the
    model group that holds the rest."""

    def __init__(self, dims: dict, n_model: int, index: int, group):
        self.dims, self.n_model, self.index = dims, n_model, index
        self.group = group

    @classmethod
    def for_mesh(cls, model_or_state, mesh) -> "ShardPlan":
        return cls(tree_shardings(model_or_state, mesh),
                   axis_size(mesh, MODEL_AXIS),
                   axis_index(mesh, MODEL_AXIS), axis_group(mesh, MODEL_AXIS))

    @property
    def sharded(self) -> bool:
        return any(d is not None for d in self.dims.values())

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``full``, a view (``full`` itself where the
        leaf is replicated)."""
        dim = self.dims[name]
        if dim is None:
            return full
        size = full.shape[dim] // self.n_model
        return full.narrow(dim, self.index * size, size)

    def gather(self, names, slices) -> list:
        """The full tensors of this rank's ``slices`` (replicated leaves as
        given), by one ``all_gather`` of a flat buffer over the model group.
        Every rank of the group calls it with the same names."""
        import torch.distributed as dist

        slices = list(slices)
        parts = [(i, self.dims[n]) for i, n in enumerate(names)
                 if self.dims[n] is not None]
        if not parts:
            return slices
        flat = torch.cat([slices[i].reshape(-1) for i, _ in parts])
        out = [torch.empty_like(flat) for _ in range(self.n_model)]
        dist.all_gather(out, flat, group=self.group)
        full, offset = list(slices), 0
        for i, dim in parts:
            shape, numel = slices[i].shape, slices[i].numel()
            full[i] = torch.cat([o[offset:offset + numel].view(shape)
                                 for o in out], dim=dim)
            offset += numel
        return full


def apply_tp(state, mesh):
    """Hold ``state``'s EMA and moments as this rank's slices under the
    rule, in place (``TrainState.shard``); returns it."""
    state.shard(ShardPlan.for_mesh(state, mesh))
    return state
