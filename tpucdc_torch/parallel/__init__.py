"""Parallel decode: the batch sharded over the mesh's data axis, the tiled
high-resolution decode, and the ``"tensor"`` state sharding rules."""

from tpucdc_torch.parallel.shard_decode import sharded_sample
from tpucdc_torch.parallel.tiling import (TilePlan, blend_tiles,
                                          make_tile_plan, split_tiles)

__all__ = ["sharded_sample", "make_tile_plan", "split_tiles", "blend_tiles",
           "TilePlan"]
