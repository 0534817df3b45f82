"""tpucdc_torch's batch entry points: what the one-by-one calls give.

``compress_many`` writes the bytes of ``compress`` on each image, and its
symbols are those of JAX's ``compress_many`` (within the two-encoder bound of
tests/test_torch_encode.py: at most 0.5 % of symbols differ, none by more
than 1). ``decompress_many`` gives the pixels of ``decompress`` bit for bit,
given the same per-image ε, for the hyperprior and for the context
models (one loop for all of them), with images of different sizes, qualities and header dials in one batch; against JAX's
``decompress_many`` fed JAX's per-image ε (``fold_in(rng, i)``) it is within
1 LSB, the bound of the single decode.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tpucdc.entropy as jax_entropy
from tpucdc.data import synthetic_images
from tpucdc.pipelines.codec_runtime import CodecRuntime as JaxRuntime
from tpucdc.sampling.ddim import _normal, _rng_streams

from tests._torch_jax_helpers import (one_torch_thread,  # noqa: F401
                                      assert_encoders_agree, init_jax,
                                      symbols, tiny_config, to_torch_config,
                                      torch_model, with_gain_ladder)
from tpucdc_torch import CodecRuntime, F32_POLICY
from tpucdc_torch.pipelines.codec_runtime import pad_image

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_eps_of_image(i, shape):
    """The ε JAX's ``decompress_many(rng=key(0))`` draws for image ``i``."""
    key = jax.random.fold_in(jax.random.key(0), i)
    return torch.from_numpy(np.array(_normal(_rng_streams(key)[1], shape)))


def _images():
    """Three images of two padded sizes (64×64, 64×128)."""
    big = synthetic_images(1, 128, 128, seed=6)[0]
    return [synthetic_images(1, 64, 64, seed=3)[0][:60, :52],
            big[:64, :120], synthetic_images(1, 64, 64, seed=4)[0]]


def _eps_list(imgs):
    return [_jax_eps_of_image(i, (1, *pad_image(im)[0].shape[:2], 3))
            for i, im in enumerate(imgs)]


@pytest.fixture(scope="module", params=["hyperprior", "space-channel"])
def pair(request):
    """Variable-rate (three gain rows) so that one batch can mix qualities."""
    cfg = tiny_config(steps=2, context=request.param, num_qualities=3)
    jmodel, params = init_jax(cfg)
    params = with_gain_ladder(params, cfg.model.codec.latent_channels)
    jrt = JaxRuntime(cfg, jmodel, params)
    trt = CodecRuntime(to_torch_config(cfg), torch_model(cfg, params),
                       device="cpu", policy=F32_POLICY)
    return jrt, trt


@pytest.mark.parametrize("quality", [None, 1.5])
def test_compress_many_gives_compress_bytes_and_jax_symbols(pair, quality):
    jrt, trt = pair
    imgs = _images()
    kwargs = {"quality_id": 2} if quality is None else {"quality": quality}
    blobs = trt.compress_many(imgs, **kwargs)
    assert blobs == [trt.compress(im, **kwargs) for im in imgs]
    for mine, theirs in zip(blobs, jrt.compress_many(imgs, **kwargs)):
        assert_encoders_agree(symbols(trt, mine), symbols(trt, theirs))
        assert mine[4] == theirs[4]      # the same container version


def test_decompress_many_equals_decompress_and_jax(pair):
    """Mixed sizes, mixed qualities (a ladder row, a v4 fractional one), a
    scalar γ in one header and a v5 γ grid in another."""
    jrt, trt = pair
    imgs = _images()
    blobs = [jrt.compress(imgs[0], quality=2),
             jrt.compress(imgs[1], quality=0.5),
             jrt.compress(imgs[2], quality_id=0)]
    blobs[0] = jax_entropy.with_header_gamma(blobs[0], 0.75)
    blobs[2] = jax_entropy.with_header_gamma_grid(
        blobs[2], np.array([[0, 255], [128, 64]], np.uint8), 0.25)
    assert [b[4] for b in blobs] == [3, 4, 5]
    eps = _eps_list(imgs)
    got = trt.decompress_many(blobs, noise=eps)
    assert [g.shape for g in got] == [im.shape for im in imgs]
    for g, blob, e in zip(got, blobs, eps):
        np.testing.assert_array_equal(g, trt.decompress(blob, noise=e))
    for g, w in zip(got, jrt.decompress_many(blobs, rng=jax.random.key(0))):
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1, f"max |diff| {diff.max()}"
    # steps= overrides every header; 0 is the mean decode.
    for g, blob in zip(trt.decompress_many(blobs, steps=0), blobs):
        np.testing.assert_array_equal(g, trt.decompress(blob, steps=0))


def test_decompress_many_draws_from_one_generator_in_image_order(pair):
    """With no ε given, image i gets the i-th draw of the generator (seed 0
    by default): image 0 decodes as a default ``decompress`` does."""
    _, trt = pair
    imgs = _images()[:2]
    blobs = trt.compress_many(imgs)
    gen = torch.Generator().manual_seed(0)
    eps = [torch.randn((1, *pad_image(im)[0].shape[:2], 3), generator=gen)
           for im in imgs]
    got = trt.decompress_many(blobs)
    for g, want in zip(got, trt.decompress_many(blobs, noise=eps)):
        np.testing.assert_array_equal(g, want)
    np.testing.assert_array_equal(got[0], trt.decompress(blobs[0]))
    again = trt.decompress_many(
        blobs, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again[1], got[1])


def test_empty_lists_and_guards(pair):
    _, trt = pair
    assert trt.compress_many([]) == []
    assert trt.decompress_many([]) == []
    blob = trt.compress(_images()[0])
    with pytest.raises(ValueError, match="noise tensors"):
        trt.decompress_many([blob, blob], noise=[torch.zeros(1, 64, 64, 3)])


def test_steps_0_guard_without_synthesis():
    """The guard ``decompress`` has: a model without g_s has no mean decode."""
    cfg = tiny_config(steps=2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, prediction="eps",
        codec=dataclasses.replace(cfg.model.codec, synthesis=False)),
        sample=dataclasses.replace(cfg.sample, truncate_frac=0.0))
    jmodel, params = init_jax(cfg)
    trt = CodecRuntime(to_torch_config(cfg), torch_model(cfg, params),
                       device="cpu", policy=F32_POLICY)
    img = _images()[0]
    blob = trt.compress(img)
    for call in (lambda: trt.decompress_many([blob], steps=0),
                 lambda: trt.decompress(blob, steps=0),
                 lambda: trt.decompress_tiled(blob, steps=0)):
        with pytest.raises(ValueError, match="needs codec.synthesis"):
            call()
    # And it does decode with steps: noise in, an image of the right size out.
    out = trt.decompress_many([blob], steps=2)
    assert out[0].shape == img.shape and out[0].dtype == np.uint8
