"""tpucdc_torch's serving decode against the JAX package's, end to end.

JAX encodes (compress), both packages decode the same bitstream under
F32_POLICY with the same initial ε, and the uint8 images agree to 1 LSB
(the f32 sums run in other orders; a pixel near a .5 boundary can round
the other way). The committed flagship fixture (made by
scripts/make_torch_fixtures.py) pins the symbol decode exactly.
"""

import jax
import numpy as np
import pytest
import torch

import tpucdc.entropy as jax_entropy
from tpucdc.data import synthetic_images
from tpucdc.pipelines.codec_runtime import CodecRuntime as JaxRuntime
from tpucdc.sampling.ddim import _normal, _rng_streams

from tests._torch_jax_helpers import (FIXTURES, FLAGSHIP_NPZ, init_jax,
                                      tiny_config, to_torch_config,
                                      torch_model)
from tpucdc_torch import CDCModel, CodecRuntime, F32_POLICY, flagship_serving
from tpucdc_torch.utils import load_params_npz


def _jax_eps(shape):
    return np.array(_normal(_rng_streams(jax.random.key(0))[1], shape))


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = tiny_config(steps=4)
    jmodel, params = init_jax(cfg)
    jrt = JaxRuntime(cfg, jmodel, params)
    trt = CodecRuntime(to_torch_config(cfg), torch_model(cfg, params),
                       device="cpu", policy=F32_POLICY)
    img = synthetic_images(1, 64, 64, seed=3)[0]
    return jrt, trt, jrt.compress(img)


@pytest.mark.parametrize("steps,gamma", [(0, None), (4, 0.5), (4, "grid"),
                                         (4, "header")])
def test_tiny_decompress_matches_jax(tiny_pair, steps, gamma):
    jrt, trt, blob = tiny_pair
    kwargs = {}
    if gamma == "grid":
        grid = np.array([[0, 255], [128, 64]], np.uint8)
        blob = jax_entropy.with_header_gamma_grid(blob, grid, 0.25)
        assert blob[4] == 5
    elif gamma == "header":
        blob = jax_entropy.with_header_gamma(blob, 0.75)
    elif gamma is not None:
        kwargs["gamma"] = gamma
    want = jrt.decompress(blob, rng=jax.random.key(0), steps=steps, **kwargs)
    eps = torch.from_numpy(_jax_eps((1, 64, 64, 3)))
    got = trt.decompress(blob, noise=eps, steps=steps, **kwargs)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max |diff| {diff.max()}"


def test_unported_modes_raise(tiny_pair):
    """Nothing of these raises any more: the analytic rate estimate gives
    JAX's, and a header that asks for guidance decodes, to JAX's pixels.
    (The tiled decode over a mesh: tests/test_torch_shard_decode.py.)"""
    jrt, trt, blob = tiny_pair
    flat = np.zeros((64, 64, 3), np.uint8)
    assert trt.estimate_bpp(flat) == pytest.approx(jrt.estimate_bpp(flat),
                                                   rel=1e-5)
    hdr, streams = jax_entropy.read_bitstream(blob)
    hdr.guidance = 2.0
    guided = jax_entropy.write_bitstream(hdr, streams)
    want = jrt.decompress(guided, rng=jax.random.key(0))
    got = trt.decompress(guided, noise=torch.from_numpy(_jax_eps((1, 64, 64, 3))))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max |diff| {diff.max()}"
    assert not np.array_equal(got, trt.decompress(
        blob, noise=torch.from_numpy(_jax_eps((1, 64, 64, 3)))))


@pytest.fixture(scope="module")
def fixture_runtime():
    model = CDCModel(flagship_serving().model)
    state, unused = load_params_npz(FLAGSHIP_NPZ)
    model.load_state_dict(state, strict=True)
    fx = dict(np.load(FIXTURES / "flagship_384x512.npz"))
    return CodecRuntime(flagship_serving(), model, device="cpu",
                        policy=F32_POLICY), fx


def test_flagship_fixture_symbols_and_mean_decode(fixture_runtime):
    rt, fx = fixture_runtime
    blob = fx["blob"].tobytes()
    hdr, z_sym, _, _ = rt._host_z_stage(blob)
    np.testing.assert_array_equal(z_sym, fx["z_sym"])
    _, indexes = rt._hyper_stage(z_sym)
    np.testing.assert_array_equal(indexes, fx["indexes"])
    _, y_sym, _, _ = rt._decode_symbols(blob)
    np.testing.assert_array_equal(y_sym.numpy(), fx["y_sym"])
    got = rt.decompress(blob, steps=0)
    diff = np.abs(got.astype(np.int32) - fx["mean_u8"].astype(np.int32))
    assert diff.max() <= 1, f"max |diff| {diff.max()}"


def test_flagship_fixture_serving_decode(fixture_runtime):
    """The served decode (5 steps, v5 γ grid) at full width, fed JAX's ε:
    max |diff| 2 and 99.9 % of pixels within 1 LSB of JAX's."""
    rt, fx = fixture_runtime
    got = rt.decompress(fx["blob"].tobytes(), noise=torch.from_numpy(fx["eps"]))
    diff = np.abs(got.astype(np.int32) - fx["serve_u8"].astype(np.int32))
    assert diff.max() <= 2 and np.mean(diff <= 1) >= 0.999
