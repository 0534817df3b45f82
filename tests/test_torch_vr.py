"""Variable rate in tpucdc_torch against the JAX package's: the gain ladder,
continuous quality, the v4 header, and rate control.

A tiny model of each entropy model with three gain rows; both packages
under F32_POLICY on the same weights and the same image. The same four
properties as tests/test_torch_encode.py hold at an integer quality (a
ladder row, v3 header) and at a fractional one (log-domain interpolation,
v4 header), with the same bounds: JAX's symbols exactly from JAX's
bitstream, the port's own round trip exact, mean decodes within 1 LSB,
at most 0.5 % of the two encoders' symbols differing and none by more
than 1.
"""

import dataclasses

import numpy as np
import pytest

from tpucdc.data import synthetic_images
from tpucdc.pipelines.codec_runtime import CodecRuntime as JaxRuntime

from tests._torch_jax_helpers import (one_torch_thread,  # noqa: F401
                                      CONTEXTS, N_STREAMS, ROOT,
                                      assert_encoders_agree,
                                      assert_round_trip_exact, init_jax,
                                      symbols, tiny_config, to_torch_config,
                                      torch_model, with_gain_ladder)
from tpucdc_torch import CDCModel, CodecRuntime, F32_POLICY
from tpucdc_torch.config import CodecConfig
from tpucdc_torch.entropy import read_bitstream, write_bitstream
from tpucdc_torch.presets import flagship_serving, vr_wide_serving
from tpucdc_torch.utils import load_params_npz

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", params=CONTEXTS)
def pair(request):
    cfg = tiny_config(steps=2, context=request.param, num_qualities=3)
    jmodel, params = init_jax(cfg)
    params = with_gain_ladder(params, cfg.model.codec.latent_channels)
    jrt = JaxRuntime(cfg, jmodel, params)
    trt = CodecRuntime(to_torch_config(cfg), torch_model(cfg, params),
                       device="cpu", policy=F32_POLICY)
    img = synthetic_images(1, 64, 64, seed=3)[0][:60, :52]
    return request.param, jrt, trt, img


@pytest.mark.parametrize("q", [0, 0.25, 1, 1.5, 2, 7.0])
def test_quality_gains_match_jax(pair, q):
    """Bitwise at the integers (the ladder's rows); within 1 ulp between."""
    _, jrt, trt, _ = pair
    for got, want in zip(trt.quality_gains(q), jrt.quality_gains(q)):
        assert got.dtype == np.float32 and got.shape == want.shape
        if float(q) == int(q):
            np.testing.assert_array_equal(got, want)
        else:
            assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
    if float(q) == int(q):
        gains, inv = trt._gain_tables_np
        row = int(min(q, 2))
        np.testing.assert_array_equal(trt.quality_gains(q)[0], gains[row])
        np.testing.assert_array_equal(trt.quality_gains(q)[1], inv[row])


@pytest.mark.parametrize("q", [2, 0.5])
def test_both_directions_at_a_quality(pair, q):
    context, jrt, trt, img = pair
    jblob = jrt.compress(img, quality=q)
    fractional = float(q) != int(q)
    assert jblob[4] == (4 if fractional else 3)
    # JAX's bitstream → JAX's symbols, exactly.
    _, want_y, _, _ = jrt._decode_symbols(jblob)
    jz, jy = symbols(trt, jblob)
    np.testing.assert_array_equal(jy, np.asarray(want_y))
    # The port's own round trip, exactly.
    blob = trt.compress(img, quality=q)
    hdr, streams = read_bitstream(blob)
    assert len(streams) == N_STREAMS[context]
    assert blob[4] == jblob[4] and hdr.quality_id == int(np.floor(q + 0.5))
    assert (hdr.quality_f_or_none == q) if fractional else (
        hdr.quality_f_or_none is None)
    assert_round_trip_exact(trt, img, blob, q)
    assert_encoders_agree(symbols(trt, blob), (jz, jy))
    # Each side decodes the other's bitstream: mean decodes within 1 LSB,
    # which also holds the inverse gain the header selects.
    for b in (blob, jblob):
        got = trt.decompress(b, steps=0)
        want = jrt.decompress(b, steps=0)
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, f"max |diff| {diff.max()}"


def test_header_quality_selects_the_inverse_gain(pair):
    """A header that names another row gives another image: the inverse
    gain is read from the header and not fixed."""
    _, _, trt, img = pair
    blob = trt.compress(img, quality_id=2)
    hdr, streams = read_bitstream(blob)
    assert hdr.quality_id == 2
    other = write_bitstream(dataclasses.replace(hdr, quality_id=0), streams)
    a, b = trt.decompress(blob, steps=0), trt.decompress(other, steps=0)
    assert np.abs(a.astype(int) - b.astype(int)).max() > 1
    # quality= at an integer is quality_id=.
    assert trt.compress(img, quality=2.0) == blob


def test_rate_rises_with_quality(pair):
    _, _, trt, img = pair
    sizes = [len(trt.compress(img, quality=q)) for q in (0, 0.5, 1, 2)]
    assert sizes == sorted(sizes) and sizes[0] < sizes[-1]


def test_compress_to_bpp_follows_jax(pair):
    """Rate control by bisection with full encodes: the quality the port
    settles on is JAX's within one bisection step (the two encoders can
    differ by a symbol, so a probe can fall on the other side of the
    target), and the bitstream round-trips."""
    _, jrt, trt, img = pair
    npix = img.shape[0] * img.shape[1]
    lo = len(trt.compress(img, quality=0)) * 8 / npix
    hi = len(trt.compress(img, quality=2)) * 8 / npix
    target = 0.5 * (lo + hi)
    iters = 4
    jblob, jq, jbpp = jrt.compress_to_bpp(img, target, max_iters=iters,
                                          tol=0.0)
    blob, q, bpp = trt.compress_to_bpp(img, target, max_iters=iters, tol=0.0)
    assert abs(q - jq) <= 2.0 / 2 ** iters, (q, jq)
    assert bpp == len(blob) * 8 / npix
    assert abs(bpp - target) <= abs(lo - target)
    assert_round_trip_exact(trt, img, blob, q)
    # Out of reach on either side clamps to the endpoint.
    assert trt.compress_to_bpp(img, 1e-3)[1] == 0.0
    assert trt.compress_to_bpp(img, 1e3)[1] == 2.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trt.compress_to_bpp(img, target, probe="estimate")
    with pytest.raises(ValueError, match="probe"):
        trt.compress_to_bpp(img, target, probe="guess")


# ---- configuration and the trained checkpoint ----

def test_vr_wide_preset_is_the_flagship_with_gains_and_space_channel():
    vr, flag = vr_wide_serving(), flagship_serving()
    assert vr.model.codec == dataclasses.replace(
        flag.model.codec, context="space-channel", context_groups=4,
        num_qualities=3)
    assert dataclasses.replace(vr.model, codec=flag.model.codec) == flag.model
    assert vr.sample == flag.sample
    assert (vr.sample.steps, vr.sample.truncate_frac,
            vr.sample.blend_gamma) == (5, 0.15, 0.5)


@pytest.mark.parametrize("bad", [
    dict(context="pixelcnn"), dict(num_qualities=0),
    dict(context="channel-ar", context_groups=5),
    dict(context="space-channel", context_groups=0)])
def test_codec_config_is_validated(bad):
    with pytest.raises(ValueError):
        CodecConfig(**bad).validated()
    # A group count that does not divide is fine where no context uses it.
    assert CodecConfig(context_groups=5).validated().context_groups == 5


def test_vr_wide_checkpoint_loads_strictly():
    model = CDCModel(vr_wide_serving().model)
    state, unused = load_params_npz(ROOT / "artifacts" / "vr_wide_params.npz")
    assert unused == [] and len(state) == 438
    model.load_state_dict(state, strict=True)
    assert tuple(model.gains.shape) == (3, 192)
    assert "h_s.proj.weight" not in state
