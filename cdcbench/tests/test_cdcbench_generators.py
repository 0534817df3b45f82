"""The seeded generators repeat for one seed and differ across seeds."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cdcbench import core, serving

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG, -3])
def test_seed_words_repeat_and_differ(seed):
    assert core.seed_words(seed, 1, 2) == core.seed_words(seed, 1, 2)
    assert core.seed_words(seed, 1, 2) != core.seed_words(seed, 1, 3)
    assert core.seed_words(seed, 1) != core.seed_words(seed + 1, 1)
    assert 0 <= core.seed_words(seed, 5) < 2 ** 63


def test_seeded_image_repeats_and_differs():
    a = core.seeded_image(96, 128, 11)
    assert a.dtype == np.uint8 and a.shape == (96, 128, 3)
    assert np.array_equal(a, core.seeded_image(96, 128, 11))
    assert not np.array_equal(a, core.seeded_image(96, 128, 12))


def _run(seed, **traffic):
    t = {"height": 128, "width": 192, "pool": 3, **traffic}
    config = {"config": {"model": {"codec": {"num_qualities": 3}}}}
    return core.Run(workload="w", seed=seed, seconds=1, trace=False, chips=1,
                    config=config, traffic=t, limits={},
                    device=torch.device("cpu"))


def test_pool_images_noise_and_qualities_repeat_and_differ():
    a, b, c = _run(BIG), _run(BIG), _run(BIG + 1)
    for x, y in zip(serving.images(a), serving.images(b)):
        assert np.array_equal(x, y)
    assert not np.array_equal(serving.images(a)[0], serving.images(c)[0])
    ims = serving.images(a)
    assert not np.array_equal(ims[0], ims[1])
    shape = serving.padded_shape(a)
    assert shape == (1, 128, 192, 3)
    assert torch.equal(serving.noise(a, 4, shape), serving.noise(b, 4, shape))
    assert not torch.equal(serving.noise(a, 4, shape),
                           serving.noise(a, 5, shape))
    assert not torch.equal(serving.noise(a, 4, shape),
                           serving.noise(c, 4, shape))
    q = serving.qualities(_run(BIG, continuous_quality=True))
    assert q == serving.qualities(_run(BIG, continuous_quality=True))
    assert q != serving.qualities(_run(BIG + 1, continuous_quality=True))
    assert all(0.0 <= x <= 2.0 for x in q)
    assert serving.qualities(a) == [None] * 3
