"""tpucdc_torch's encode side against the JAX package's, end to end.

Both packages carry the same weights (F32_POLICY) and compress the same
image, for each of the four entropy models at a single rate. What must hold:

  * a JAX-written bitstream gives the port JAX's z and y symbols exactly;
  * the port's own round trip is exact: the symbols it decodes are the
    symbols its encoder coded;
  * JAX decodes the port's bitstream: the two mean decodes (``steps=0``)
    agree within 1 LSB (the f32 sums of g_s run in other orders, and a
    pixel near a .5 boundary can round the other way);
  * the two encoders may disagree on a symbol whose y − μ lies within
    float noise of a half-integer: at most 0.5 % of the symbols, none by
    more than 1. (At this size that allows two; in practice none differs.)

The in-band γ search is held to JAX's with JAX's ε injected; the closed-form
grid fit, being numpy on both sides, to equality. The full-width case runs
the flagship's weights on a 128×128 crop against symbols JAX stored in the
fixture.
"""

import jax
import numpy as np
import pytest
import torch

import tpucdc.entropy as jax_entropy
from tpucdc.data import synthetic_images
from tpucdc.pipelines.codec_runtime import CodecRuntime as JaxRuntime
from tpucdc.pipelines.codec_runtime import pad_image as jax_pad_image
from tpucdc.pipelines.codec_runtime import to_model_range as jax_to_range
from tpucdc.sampling.ddim import _normal, _rng_streams

from tests._torch_jax_helpers import (one_torch_thread,  # noqa: F401
                                      CONTEXTS, FIXTURES, FLAGSHIP_NPZ,
                                      N_STREAMS, assert_encoders_agree,
                                      assert_round_trip_exact, init_jax,
                                      symbols, tiny_config, to_torch_config,
                                      torch_model)
from tpucdc_torch import CDCModel, CodecRuntime, F32_POLICY, flagship_serving
from tpucdc_torch.entropy import read_bitstream
from tpucdc_torch.pipelines.codec_runtime import pad_image, to_model_range
from tpucdc_torch.runtime import pin_numerics
from tpucdc_torch.utils import load_params_npz

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_eps(shape):
    return np.array(_normal(_rng_streams(jax.random.key(0))[1], shape))


@pytest.fixture(scope="module", params=CONTEXTS)
def pair(request):
    """(context, JAX runtime, port runtime, a 60×52 image, JAX's bitstream);
    the image pads to 64×64, so the padding and the crop are on the path."""
    cfg = tiny_config(steps=2, context=request.param)
    jmodel, params = init_jax(cfg)
    jrt = JaxRuntime(cfg, jmodel, params)
    trt = CodecRuntime(to_torch_config(cfg), torch_model(cfg, params),
                       device="cpu", policy=F32_POLICY)
    img = synthetic_images(1, 64, 64, seed=3)[0][:60, :52]
    return request.param, jrt, trt, img, jrt.compress(img)


def test_pin_numerics_pins_tf32_and_cudnn_algorithm_choice():
    """What the shared row indexes rely on is set in one place: TF32 off,
    no autotuned cuDNN algorithm, deterministic cuDNN algorithms."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
             cudnn.deterministic)
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = cudnn.benchmark = True
        cudnn.deterministic = False
        pin_numerics()
        assert (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
                cudnn.deterministic) == (False, False, False, True)
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
         cudnn.deterministic) = saved


def test_pad_and_range_match_jax():
    img = synthetic_images(1, 64, 64, seed=4)[0][:37, :50]
    got, hw = pad_image(img)
    want, want_hw = jax_pad_image(img)
    assert hw == want_hw == (37, 50) and got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(to_model_range(got), jax_to_range(want))


def test_jax_bitstream_gives_the_port_jax_symbols(pair):
    context, jrt, trt, img, jblob = pair
    assert len(read_bitstream(jblob)[1]) == N_STREAMS[context]
    x = jax_to_range(jax_pad_image(img)[0])[None]
    _, want_z = jrt._analysis(jax.numpy.asarray(x))
    _, want_y, want_mu, _ = jrt._decode_symbols(jblob)
    got_z, got_y = symbols(trt, jblob)
    np.testing.assert_array_equal(got_z, np.asarray(want_z))
    np.testing.assert_array_equal(got_y, np.asarray(want_y))
    # μ itself is only close: 1e-4·max|μ|, the f32 module bound.
    _, _, got_mu, _ = trt._decode_symbols(jblob)
    want_mu = np.asarray(want_mu)
    assert np.abs(got_mu.numpy() - want_mu).max() <= 1e-4 * np.abs(want_mu).max()


def test_port_round_trip_is_exact(pair):
    context, _, trt, img, _ = pair
    blob = trt.compress(img)
    hdr, streams = read_bitstream(blob)
    assert (hdr.height, hdr.width) == (60, 52)
    assert len(streams) == N_STREAMS[context]
    assert_round_trip_exact(trt, img, blob)
    x = torch.from_numpy(to_model_range(pad_image(img)[0]))[None]
    y, _ = trt._analysis(x)
    y_hat, hdr2 = trt.decode_latent(blob)
    assert y_hat.shape == y.shape and hdr2.height == 60
    # ŷ is y to within the quantization step.
    assert float((y_hat - y).abs().max()) <= 0.5 + 1e-4


def test_jax_decodes_the_port_bitstream_and_encoders_agree(pair):
    _, jrt, trt, img, jblob = pair
    blob = trt.compress(img)
    got = trt.decompress(blob, steps=0)
    want = jrt.decompress(blob, steps=0)
    assert got.shape == want.shape == (60, 52, 3)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max |diff| {diff.max()}"
    assert_encoders_agree(symbols(trt, blob), symbols(trt, jblob))


def test_wrong_stream_count_is_refused(pair):
    context, _, trt, _, jblob = pair
    hdr, streams = read_bitstream(jblob)
    with pytest.raises(ValueError, match="streams"):
        trt.decompress(jax_entropy.write_bitstream(hdr, streams + [b""]))


# ---- the in-band γ search (one context is enough: it is decode + numpy) ----

@pytest.fixture(scope="module")
def gamma_pair():
    cfg = tiny_config(steps=2)
    jmodel, params = init_jax(cfg)
    jrt = JaxRuntime(cfg, jmodel, params)
    trt = CodecRuntime(to_torch_config(cfg), torch_model(cfg, params),
                       device="cpu", policy=F32_POLICY)
    # 140×100 pads to 192×128: a 1×2 γ grid whose second tile is half
    # padding.
    img = synthetic_images(1, 256, 256, seed=5)[0][:100, :140]
    eps = torch.from_numpy(_jax_eps((1, 128, 192, 3)))
    return jrt, trt, img, eps


def test_fit_gamma_grid_equals_jax(gamma_pair):
    jrt, trt, img, _ = gamma_pair
    rng = np.random.default_rng(0)
    mean = rng.integers(0, 256, img.shape, dtype=np.uint8)
    refined = rng.integers(0, 256, img.shape, dtype=np.uint8)
    ref = img.astype(np.float64)
    got = trt._fit_gamma_grid(ref, mean, refined)
    assert got.shape == (1, 2) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jrt._fit_gamma_grid(ref, mean, refined))


@pytest.mark.parametrize("candidates", [True, (0.1, 0.6), "spatial"])
def test_optimize_gamma_matches_jax_given_jax_noise(gamma_pair, candidates):
    """The same scalar γ, the same choice between grid and scalar, and the
    v5 grid within 2 of 255 at every node (a node's γ* is a ratio of sums
    over uint8 decodes that differ by at most 1 LSB here and there)."""
    jrt, trt, img, eps = gamma_pair
    want = read_bitstream(jrt.compress(img, optimize_gamma=candidates))[0]
    blob = trt.compress(img, optimize_gamma=candidates, noise=eps)
    got = read_bitstream(blob)[0]
    assert got.gamma == want.gamma
    assert (got.gamma_grid is None) == (want.gamma_grid is None)
    if want.gamma_grid is not None:
        assert got.gamma_grid.shape == want.gamma_grid.shape
        gap = np.abs(got.gamma_grid.astype(int) - want.gamma_grid.astype(int))
        assert gap.max() <= 2, f"γ grid differs by {gap.max()}"
    # The header's dial is what a plain decompress now serves.
    served = trt.decompress(blob, noise=eps)
    explicit = trt.decompress(
        blob, noise=eps,
        gamma=got.gamma if got.gamma_grid is None else got.gamma_grid_f)
    np.testing.assert_array_equal(served, explicit)


def test_optimize_gamma_default_noise_is_decompress_default(gamma_pair):
    """With no ε given, the search scores what ``decompress`` serves by
    default: a seed-0 generator on the runtime's device."""
    _, trt, img, _ = gamma_pair
    blob = trt.compress(img)
    ph, pw = pad_image(img)[0].shape[:2]
    eps = torch.randn((1, ph, pw, 3), generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(trt.decompress(blob),
                                  trt.decompress(blob, noise=eps))
    a = trt._optimize_gamma(blob, img, True)
    b = trt._optimize_gamma(blob, img, True, noise=eps)
    assert a == b
    with pytest.raises(ValueError, match="empty"):
        trt._optimize_gamma(blob, img, ())


def test_unported_encode_entry_points_raise(gamma_pair):
    """The encode entry points that used to raise no longer do: the
    analytic rate estimate gives JAX's, and the batch entry points give what the one-by-one calls give
    (tests/test_torch_batch.py holds them against JAX's)."""
    jrt, trt, img, eps = gamma_pair
    est = trt.estimate_bpp(img)
    assert est == pytest.approx(jrt.estimate_bpp(img), rel=1e-5)
    blob = trt.compress(img)
    assert trt.compress_many([img]) == [blob]
    np.testing.assert_array_equal(
        trt.decompress_many([blob], noise=[eps])[0],
        trt.decompress(blob, noise=eps))
    with pytest.raises(ValueError, match="variable-rate"):
        trt.compress(img, quality=0.5)
    with pytest.raises(ValueError, match="variable-rate"):
        trt.compress_many([img], quality=0.5)
    with pytest.raises(ValueError, match="variable-rate"):
        trt.compress_to_bpp(img, 0.5)


# ---- full width: the flagship's weights, a 128×128 crop ----

def test_flagship_encode_at_full_width():
    """Port compress on the CPU against the symbols JAX coded for the same
    128×128 crop (stored by scripts/make_torch_fixtures.py)."""
    fx = np.load(FIXTURES / "flagship_384x512.npz")
    model = CDCModel(flagship_serving().model)
    state, unused = load_params_npz(FLAGSHIP_NPZ)
    assert not unused
    model.load_state_dict(state, strict=True)
    trt = CodecRuntime(flagship_serving(), model, device="cpu",
                       policy=F32_POLICY)
    crop = fx["crop_u8"][:128, :128]
    jz, jy = symbols(trt, fx["crop128_blob"].tobytes())
    np.testing.assert_array_equal(jz, fx["crop128_z_sym"])
    np.testing.assert_array_equal(jy, fx["crop128_y_sym"])
    blob = trt.compress(crop)
    assert_round_trip_exact(trt, crop, blob)
    assert_encoders_agree(symbols(trt, blob), (jz, jy))
    assert abs(len(blob) - fx["crop128_blob"].size) <= 0.005 * len(blob) + 1
