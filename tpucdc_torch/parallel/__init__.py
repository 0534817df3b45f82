"""Tiling for high-resolution decode (the multi-card paths are not ported)."""

from tpucdc_torch.parallel.tiling import (TilePlan, blend_tiles,
                                          make_tile_plan, split_tiles)

__all__ = ["TilePlan", "make_tile_plan", "split_tiles", "blend_tiles"]
