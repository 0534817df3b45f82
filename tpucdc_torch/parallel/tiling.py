"""Tiled high-resolution decode (numpy copy of tpucdc/parallel/tiling.py).

A high-resolution image is split into fixed-size overlapping tiles (core +
halo); every tile is conditioned on its slice of the decoded latent ŷ and
diffusion-decoded on its own, all tiles in one batch, and the overlaps are
blended with linear ramps. Every tile has the same shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TilePlan:
    image_hw: tuple[int, int]          # padded image size
    extent: int                        # tile side (core + 2*halo), px
    halo: int
    positions: tuple[tuple[int, int], ...]   # top-left corner of each tile

    @property
    def num_tiles(self) -> int:
        return len(self.positions)


def make_tile_plan(h: int, w: int, tile: int = 256, halo: int = 32) -> TilePlan:
    """Plan fixed-extent tiles covering an (h, w) image.

    ``tile`` is the core stride; extent = tile + 2·halo. Both must be
    multiples of 16 so tile positions land on latent-grid cells. Edge tiles
    are clamped inward (positions may overlap more near borders).
    """
    extent = tile + 2 * halo
    if tile % 16 or halo % 16:
        raise ValueError("tile and halo must be multiples of 16")
    if extent > h or extent > w:
        raise ValueError(f"image {h}x{w} smaller than tile extent {extent}")

    def starts(size):
        s = list(range(0, size - extent, tile))
        s.append(size - extent)        # final tile clamped to the border
        return s

    positions = tuple((i, j) for i in starts(h) for j in starts(w))
    return TilePlan((h, w), extent, halo, positions)


def split_tiles(arr: np.ndarray, plan: TilePlan, scale: int = 1) -> np.ndarray:
    """Gather [B=1, H, W, C] (or [H, W, C]) into [N, e, e, C] tiles.

    ``scale`` divides positions and extent: pass 16 to slice the latent ŷ
    with the plan used for pixel tiles.
    """
    if arr.ndim == 4:
        arr = arr[0]
    e = plan.extent // scale
    tiles = [arr[i // scale:i // scale + e, j // scale:j // scale + e]
             for (i, j) in plan.positions]
    return np.stack(tiles)


def _ramp_window(extent: int, halo: int, clamp_lo: bool, clamp_hi: bool):
    w = np.ones(extent, np.float32)
    if halo > 0:
        ramp = (np.arange(1, halo + 1, dtype=np.float32)) / (halo + 1)
        if not clamp_lo:
            w[:halo] = ramp
        if not clamp_hi:
            w[-halo:] = ramp[::-1]
    return w


def blend_tiles(tiles: np.ndarray, plan: TilePlan) -> np.ndarray:
    """Scatter tiles back with linear halo ramps; the weights normalize
    exactly (float64 accumulation).

    Tiles touching an image border keep weight 1 there (full coverage).
    """
    h, w = plan.image_hw
    c = tiles.shape[-1]
    acc = np.zeros((h, w, c), np.float64)
    norm = np.zeros((h, w, 1), np.float64)
    e, halo = plan.extent, plan.halo
    for tile, (i, j) in zip(tiles, plan.positions):
        wy = _ramp_window(e, halo, i == 0, i + e == h)
        wx = _ramp_window(e, halo, j == 0, j + e == w)
        win = (wy[:, None] * wx[None, :])[..., None]
        acc[i:i + e, j:j + e] += tile.astype(np.float64) * win
        norm[i:i + e, j:j + e] += win
    return (acc / np.maximum(norm, 1e-12)).astype(tiles.dtype)
