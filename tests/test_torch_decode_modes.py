"""tpucdc_torch's other ways to decode against the JAX package's, end to end.

JAX encodes; both packages decode the same bitstream under F32_POLICY on the
same weights with JAX's ε (and, for DDPM, JAX's per-step z), and the uint8
images agree to 1 LSB, the bound tests/test_torch_decompress.py holds the
served decode to (the f32 sums run in other orders; a pixel near a .5
boundary can round the other way). Modes: classifier-free guidance,
block-cached DDIM, the DDPM sampler, the tiled decode (single-rate and
variable-rate with a fractional quality), and one denoiser call of the large
``flagship()`` preset at full width (head widths 48 and 64). The trained
flagship at full width is held to the JAX arrays that
scripts/make_torch_fixtures.py stored in fixtures/flagship_modes.npz, with
the bound of the served decode's fixture test: max 2 LSB, 99.9 % within 1.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucdc.presets as jax_presets
from tpucdc.data import synthetic_images
from tpucdc.model import CDCModel as JaxCDCModel
from tpucdc.pipelines.codec_runtime import CodecRuntime as JaxRuntime
from tpucdc.sampling.ddim import _normal, _rng_streams, _split_keys

from tests._torch_jax_helpers import (one_torch_thread,  # noqa: F401
                                      FIXTURES, FLAGSHIP_NPZ, init_jax,
                                      maxdiff, t, tiny_config,
                                      to_torch_config, torch_model,
                                      with_gain_ladder)
from tpucdc_torch import CDCModel, CodecRuntime, F32_POLICY, presets
from tpucdc_torch.entropy import read_bitstream, write_bitstream
from tpucdc_torch.utils import load_params_npz

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_eps(shape, key=None):
    key = jax.random.key(0) if key is None else key
    return torch.from_numpy(np.array(_normal(_rng_streams(key)[1], shape)))


def _jax_step_noise(shape, steps):
    """The per-step z JAX's samplers draw from key(0)."""
    noise_rng = _rng_streams(jax.random.key(0))[0]
    zs = []
    for _ in range(steps):
        noise_rng, sub = _split_keys(noise_rng)
        zs.append(torch.from_numpy(np.array(_normal(sub, shape))))
    return zs


def _runtimes(cfg, params, jmodel):
    return (JaxRuntime(cfg, jmodel, params),
            CodecRuntime(to_torch_config(cfg), torch_model(cfg, params),
                         device="cpu", policy=F32_POLICY))


def _lsb(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    return int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())


@pytest.fixture(scope="module")
def served():
    """The tiny model in the flagship's serving shape (residual refiner,
    truncated chain, γ 0.5), its weights, an image and JAX's bitstream."""
    cfg = tiny_config(steps=4)
    jmodel, params = init_jax(cfg)
    img = synthetic_images(1, 64, 64, seed=3)[0]
    return cfg, jmodel, params, JaxRuntime(cfg, jmodel, params).compress(img)


def test_guidance_matches_jax(served):
    cfg, jmodel, params, blob = served
    jrt, trt = _runtimes(cfg, params, jmodel)
    eps = _jax_eps((1, 64, 64, 3))
    want = jrt.decompress(blob, rng=jax.random.key(0), guidance=2.5)
    got = trt.decompress(blob, noise=eps, guidance=2.5)
    assert _lsb(got, want) <= 1
    # Guidance did something, and 1.0 is the unguided decode.
    plain = trt.decompress(blob, noise=eps)
    assert not np.array_equal(got, plain)
    np.testing.assert_array_equal(
        trt.decompress(blob, noise=eps, guidance=1.0), plain)
    # Resolution order: the argument, the header, the sample config.
    sample = dataclasses.replace(trt.config.sample, guidance=2.5)
    trt2 = CodecRuntime(dataclasses.replace(trt.config, sample=sample),
                        trt.model, device="cpu", policy=F32_POLICY)
    np.testing.assert_array_equal(trt2.decompress(blob, noise=eps), plain)
    hdr, streams = read_bitstream(blob)
    hdr.guidance = 0.0          # "not set": falls through to the config
    unset = write_bitstream(hdr, streams)
    np.testing.assert_array_equal(trt2.decompress(unset, noise=eps), got)
    np.testing.assert_array_equal(
        trt2.decompress(unset, noise=eps, guidance=1.0), plain)


def test_block_cached_decode_matches_jax(served):
    cfg, jmodel, params, blob = served
    cfg2 = dataclasses.replace(cfg, sample=dataclasses.replace(
        cfg.sample, cache_period=2))
    jrt, trt = _runtimes(cfg2, params, jmodel)
    eps = _jax_eps((1, 64, 64, 3))
    got = trt.decompress(blob, noise=eps)
    assert _lsb(got, jrt.decompress(blob, rng=jax.random.key(0))) <= 1
    # Steps 1 and 3 ran on a cache: not the plain chain's pixels.
    _, plain_rt = _runtimes(cfg, params, jmodel)
    assert not np.array_equal(got, plain_rt.decompress(blob, noise=eps))
    # With guidance the cache is not used (as in the JAX package).
    np.testing.assert_array_equal(
        trt.decompress(blob, noise=eps, guidance=2.0),
        plain_rt.decompress(blob, noise=eps, guidance=2.0))


def test_cache_period_is_ignored_with_a_warning_at_a_fractional_quality():
    cfg = tiny_config(steps=2, num_qualities=3)
    cfg = dataclasses.replace(cfg, sample=dataclasses.replace(
        cfg.sample, cache_period=2))
    jmodel, params = init_jax(cfg)
    params = with_gain_ladder(params, cfg.model.codec.latent_channels)
    jrt, trt = _runtimes(cfg, params, jmodel)
    img = synthetic_images(1, 64, 64, seed=3)[0]
    blob = jrt.compress(img, quality=0.5)
    eps = _jax_eps((1, 64, 64, 3))
    with pytest.warns(UserWarning, match="cache_period is ignored"):
        got = trt.decompress(blob, noise=eps)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jrt.decompress(blob, rng=jax.random.key(0))
    assert _lsb(got, want) <= 1
    # An integer quality takes the cached path, silently.
    blob1 = jrt.compress(img, quality=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got1 = trt.decompress(blob1, noise=eps)
    assert _lsb(got1, jrt.decompress(blob1, rng=jax.random.key(0))) <= 1


def test_ddpm_decode_matches_jax_and_needs_eps_prediction(served):
    """The ε-predicting tiny preset on a 24-step schedule, all 24 steps."""
    base = jax_presets.tiny()
    cfg = dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, schedule=dataclasses.replace(
            base.model.schedule, num_steps=24)),
        sample=dataclasses.replace(base.sample, sampler="ddpm", steps=8))
    assert cfg.model.prediction == "eps"
    jmodel, params = init_jax(cfg)
    jrt, trt = _runtimes(cfg, params, jmodel)
    img = synthetic_images(1, 64, 64, seed=3)[0]
    blob = jrt.compress(img)
    shape = (1, 64, 64, 3)
    got = trt.decompress(blob, noise=_jax_eps(shape),
                         step_noise=_jax_step_noise(shape, 24))
    assert _lsb(got, jrt.decompress(blob, rng=jax.random.key(0))) <= 1
    # The default draws come from one seeded generator: repeatable.
    np.testing.assert_array_equal(trt.decompress(blob), trt.decompress(blob))

    rcfg, rmodel, rparams, rblob = served
    rcfg = dataclasses.replace(rcfg, sample=dataclasses.replace(
        rcfg.sample, sampler="ddpm"))
    _, rtrt = _runtimes(rcfg, rparams, rmodel)
    with pytest.raises(ValueError, match="eps-prediction only"):
        rtrt.decompress(rblob)


@pytest.fixture(scope="module", params=["single-rate", "quality_f"])
def tiled_pair(request):
    """A 128×128 image, so tile 64 + halo 16 gives 2×2 clamped tiles of 96."""
    vr = request.param == "quality_f"
    cfg = tiny_config(steps=2, num_qualities=3 if vr else 1)
    jmodel, params = init_jax(cfg)
    if vr:
        params = with_gain_ladder(params, cfg.model.codec.latent_channels)
    jrt, trt = _runtimes(cfg, params, jmodel)
    img = synthetic_images(1, 128, 128, seed=5)[0][:120, :128]
    blob = jrt.compress(img, quality=0.5) if vr else jrt.compress(img)
    return jrt, trt, blob


@pytest.mark.parametrize("steps", [0, 2])
def test_tiled_decode_matches_jax(tiled_pair, steps):
    jrt, trt, blob = tiled_pair
    want = jrt.decompress_tiled(blob, rng=jax.random.key(0), tile=64,
                                halo=16, steps=steps)
    eps = _jax_eps((4, 96, 96, 3))
    got = trt.decompress_tiled(blob, noise=eps, tile=64, halo=16, steps=steps)
    assert got.shape == (120, 128, 3)
    assert _lsb(got, want) <= 1
    if steps:
        # The default ε is one seeded draw for all tiles: repeatable.
        a = trt.decompress_tiled(blob, tile=64, halo=16, steps=steps)
        gen = torch.Generator().manual_seed(0)
        b = trt.decompress_tiled(blob, generator=gen, tile=64, halo=16,
                                 steps=steps)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, got)


def test_tiled_decode_errors(tiled_pair):
    _, trt, blob = tiled_pair
    with pytest.raises(ValueError, match="divisible by 4"):
        trt.decompress_tiled(blob, tile=50, halo=16)
    with pytest.raises(ValueError, match="multiples of 16"):
        trt.decompress_tiled(blob, tile=72, halo=16)
    with pytest.raises(ValueError, match="smaller than tile extent"):
        trt.decompress_tiled(blob, tile=128, halo=16)


def test_large_flagship_denoiser_at_full_width():
    """``presets.flagship()`` (base 64, mult 1·2·3·4, attention at levels 2
    and 3: 192 and 256 channels in 4 heads, d = 48 and 64) on one 64×64
    input, JAX-initialised weights with the zero output head perturbed:
    conditioning, x̄ and the denoiser's ε within 1e-4·max|reference|, the f32
    module bound; and ε, cache and cached ε through the split."""
    jcfg = jax_presets.flagship()
    tcfg = presets.flagship()
    assert to_torch_config(jcfg).model == tcfg.model
    assert to_torch_config(jcfg).sample == tcfg.sample
    jmodel, params = init_jax(jcfg, perturb=0.01)
    tmodel = torch_model(jcfg, params)
    rng = np.random.default_rng(11)
    y_hat = rng.standard_normal((1, 4, 4, 192)).astype(np.float32)
    x_t = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    tt = np.array([417], np.int32)

    jf, jt = jmodel.apply(params, jnp.asarray(y_hat),
                          method=JaxCDCModel.cond_signal)
    jbar = jmodel.apply(params, jnp.asarray(y_hat),
                        method=JaxCDCModel.synthesize)
    jeps, jcache = jmodel.apply(params, jnp.asarray(x_t), jnp.asarray(tt), jf,
                                jt, x_bar=jbar,
                                method=JaxCDCModel.denoise_fresh)
    jcached = jmodel.apply(params, jnp.asarray(x_t), jnp.asarray(tt), jf, jt,
                           jcache, x_bar=jbar,
                           method=JaxCDCModel.denoise_cached)
    with torch.no_grad():
        tf, ttok = tmodel.cond_signal(t(y_hat))
        tbar = tmodel.synthesize(t(y_hat))
        # JAX's conditioning in, so that the comparison is of the UNet.
        feed = (t(x_t), t(tt), t(jf), t(jt))
        teps = tmodel.denoise(*feed, t(jbar))
        teps2, tcache = tmodel.denoise_fresh(*feed, t(jbar))
        tcached = tmodel.denoise_cached(*feed, t(jcache), t(jbar))
    rel = lambda got, want: maxdiff(got, want) / float(np.abs(want).max())
    assert rel(tf, jf) <= 1e-4 and rel(ttok, jt) <= 1e-4
    assert rel(tbar, jbar) <= 1e-4
    assert torch.equal(teps, teps2)
    assert tuple(tcache.shape) == tcfg.model.unet.cache_shape(1, 64, 64) \
        == (1, 8, 8, 192)
    assert float(np.abs(jeps).max()) > 1e-3       # the head is not zero
    assert rel(teps, jeps) <= 1e-4
    assert rel(tcache, jcache) <= 1e-4
    assert rel(tcached, jcached) <= 1e-4


@pytest.mark.parametrize("mode", ["guide2_u8", "cache2_u8", "tiled_mean_u8"])
def test_trained_flagship_modes_match_the_jax_fixtures(mode):
    cfg = presets.flagship_serving()
    if mode == "cache2_u8":
        cfg = dataclasses.replace(cfg, sample=dataclasses.replace(
            cfg.sample, cache_period=2))
    model = CDCModel(cfg.model)
    model.load_state_dict(load_params_npz(FLAGSHIP_NPZ)[0], strict=True)
    rt = CodecRuntime(cfg, model, device="cpu", policy=F32_POLICY)
    want = np.load(FIXTURES / "flagship_modes.npz")[mode]
    if mode == "tiled_mean_u8":
        blob = (FIXTURES / "flagship_768x512.tpucdc").read_bytes()
        assert _lsb(rt.decompress_tiled(blob, tile=256, halo=32, steps=0),
                    want) <= 1
        return
    fx = np.load(FIXTURES / "flagship_384x512.npz")
    got = rt.decompress(fx["blob"].tobytes(), noise=torch.from_numpy(fx["eps"]),
                        guidance=2.0 if mode == "guide2_u8" else None)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 2 and np.mean(diff <= 1) >= 0.999
    assert not np.array_equal(want, fx["serve_u8"])
