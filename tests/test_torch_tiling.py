"""tpucdc_torch's tiling against the JAX package's: both are numpy, so plans,
tiles and blends are equal exactly, on seeded arrays."""

import numpy as np
import pytest

from tpucdc.parallel import tiling as jax_tiling

from tpucdc_torch.parallel import (TilePlan, blend_tiles, make_tile_plan,
                                   split_tiles)

# (h, w, tile, halo): an exact fit, clamped edge tiles both ways, one tile,
# no halo, and the two sizes the card's smoke run tiles.
PLANS = [(128, 192, 32, 16), (144, 208, 64, 16), (96, 96, 64, 16),
         (128, 128, 64, 0), (512, 768, 256, 32), (1536, 2048, 256, 32)]


@pytest.mark.parametrize("h,w,tile,halo", PLANS)
def test_make_tile_plan_equals_jax(h, w, tile, halo):
    got = make_tile_plan(h, w, tile=tile, halo=halo)
    want = jax_tiling.make_tile_plan(h, w, tile=tile, halo=halo)
    assert isinstance(got, TilePlan)
    assert (got.image_hw, got.extent, got.halo, got.positions,
            got.num_tiles) == (want.image_hw, want.extent, want.halo,
                               want.positions, want.num_tiles)


def test_the_smoke_run_plans_have_6_and_48_tiles():
    assert make_tile_plan(512, 768).num_tiles == 6
    assert make_tile_plan(1536, 2048).num_tiles == 48
    assert make_tile_plan(512, 768).extent == 320


@pytest.mark.parametrize("args,match", [
    ((128, 128, 40, 16), "multiples of 16"),
    ((128, 128, 64, 8), "multiples of 16"),
    ((64, 256, 64, 16), "smaller than tile extent"),
    ((256, 64, 64, 16), "smaller than tile extent"),
])
def test_make_tile_plan_errors_as_jax(args, match):
    h, w, tile, halo = args
    with pytest.raises(ValueError, match=match):
        make_tile_plan(h, w, tile=tile, halo=halo)
    with pytest.raises(ValueError, match=match):
        jax_tiling.make_tile_plan(h, w, tile=tile, halo=halo)


@pytest.mark.parametrize("h,w,tile,halo", PLANS[:4])
@pytest.mark.parametrize("scale,batched", [(1, True), (1, False), (16, True)])
def test_split_tiles_equals_jax(h, w, tile, halo, scale, batched):
    plan = make_tile_plan(h, w, tile=tile, halo=halo)
    jplan = jax_tiling.make_tile_plan(h, w, tile=tile, halo=halo)
    rng = np.random.default_rng(h + w + scale)
    arr = rng.standard_normal((h // scale, w // scale, 5)).astype(np.float32)
    if batched:
        arr = arr[None]
    got = split_tiles(arr, plan, scale=scale)
    want = jax_tiling.split_tiles(arr, jplan, scale=scale)
    assert got.shape == (plan.num_tiles, plan.extent // scale,
                         plan.extent // scale, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,tile,halo", PLANS[:4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blend_tiles_equals_jax(h, w, tile, halo, dtype):
    plan = make_tile_plan(h, w, tile=tile, halo=halo)
    jplan = jax_tiling.make_tile_plan(h, w, tile=tile, halo=halo)
    rng = np.random.default_rng(h * w)
    tiles = (255 * rng.random((plan.num_tiles, plan.extent, plan.extent, 3))
             ).astype(dtype)
    got = blend_tiles(tiles, plan)
    assert got.shape == (h, w, 3) and got.dtype == dtype
    np.testing.assert_array_equal(got, jax_tiling.blend_tiles(tiles, jplan))


@pytest.mark.parametrize("h,w,tile,halo", PLANS[:4])
def test_blend_of_split_is_the_image(h, w, tile, halo):
    """The weights normalize: tiles cut from one image blend back to it."""
    plan = make_tile_plan(h, w, tile=tile, halo=halo)
    img = np.random.default_rng(1).random((h, w, 3)).astype(np.float32)
    back = blend_tiles(split_tiles(img, plan), plan)
    np.testing.assert_allclose(back, img, atol=1e-6)
