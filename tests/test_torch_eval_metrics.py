"""tpucdc_torch's eval metrics and data against the JAX package's, on the CPU.

The same seeded uint8 (or float) images go through ``tpucdc.eval`` and
``tpucdc_torch.eval``. Bounds: MSE 1e-4 relative and PSNR 1e-4 dB, MS-SSIM
and GMSD 1e-5 absolute (f32 sums in other orders), LPIPS and its features
1e-4 relative, FID 1e-3 relative. The LPIPS proxy's random weights and the
synthetic datasets are drawn with numpy on both sides and must be
bit-equal.
"""

import numpy as np
import pytest
import torch

import tpucdc.data.datasets as jax_data
import tpucdc.eval.fid as jax_fid
import tpucdc.eval.lpips as jax_lpips
import tpucdc.eval.metrics as jax_metrics

from tests._torch_jax_helpers import (  # noqa: F401
    one_blas_thread_per_module, one_torch_thread_per_module)
import tpucdc_torch.data.datasets as port_data
import tpucdc_torch.eval.fid as port_fid
import tpucdc_torch.eval.lpips as port_lpips
import tpucdc_torch.eval.metrics as port_metrics


def _pair(shape, seed, noise=20):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-noise, noise + 1, shape),
                0, 255).astype(np.uint8)
    return a, b


# (shape, MS-SSIM levels): 16 px → 1 level, 50 → 3, 177 → 5 with odd sides.
SHAPES = [((16, 20, 3), 1), ((2, 50, 47, 3), 3), ((177, 190, 3), 5)]


def _levels(shape):
    side = min(shape[-3], shape[-2])
    levels = 1
    while levels < 5 and side // (2 ** levels) >= 11:
        levels += 1
    return levels


@pytest.mark.parametrize("shape,levels", SHAPES, ids=lambda s: str(s))
@pytest.mark.parametrize("kind", ["uint8", "float", "tensor"])
def test_metrics_match_jax(shape, levels, kind):
    assert _levels(shape) == levels
    a, b = _pair(shape, seed=len(shape) + shape[-2])
    want = {f: getattr(jax_metrics, f)(a, b)
            for f in ("mse", "psnr", "ms_ssim", "gmsd")}
    if kind == "float":
        a, b = a.astype(np.float32), b.astype(np.float32)
    elif kind == "tensor":
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    got = {f: getattr(port_metrics, f)(a, b, device="cpu") for f in want}
    assert got["mse"] == pytest.approx(want["mse"], rel=1e-4)
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4
    assert abs(got["ms_ssim"] - want["ms_ssim"]) <= 1e-5
    assert abs(got["gmsd"] - want["gmsd"]) <= 1e-5
    assert 0.0 < got["ms_ssim"] <= 1.0


def test_metrics_of_identical_images():
    a, _ = _pair((40, 36, 3), seed=3)
    cpu = {"device": "cpu"}
    assert port_metrics.mse(a, a, **cpu) == 0.0
    assert port_metrics.psnr(a, a, **cpu) == pytest.approx(
        jax_metrics.psnr(a, a)) == pytest.approx(10 * np.log10(255.0 ** 2
                                                              / 1e-12))
    assert abs(port_metrics.ms_ssim(a, a, **cpu) - 1.0) <= 1e-5
    assert abs(port_metrics.ms_ssim(a, a, **cpu)
               - jax_metrics.ms_ssim(a, a)) <= 1e-5
    assert abs(port_metrics.gmsd(a, a, **cpu)) <= 1e-5


def test_metrics_of_numpy_default_to_the_card():
    """A numpy pair goes to the card unless the caller asks for the CPU;
    a tensor stays where it is, and a numpy partner follows it."""
    a, b = _pair((24, 24, 3), seed=6)
    for fn in (port_metrics.mse, port_metrics.psnr, port_metrics.ms_ssim,
               port_metrics.gmsd):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(a, b)
        assert fn(torch.from_numpy(a), b) == fn(a, b, device="cpu")


def test_metrics_leave_tf32_flags_as_they_were():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    a, b = _pair((24, 24, 3), seed=4)
    port_metrics.ms_ssim(a, b, device="cpu")
    port_metrics.gmsd(a, b, device="cpu")
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


@pytest.mark.parametrize("seed", [0, 3])
def test_random_params_bit_equal(seed):
    want = jax_lpips._random_params(seed)
    got = port_lpips._random_params(seed)
    assert len(got) == len(want) == 5
    for (gk, gb, gw), (wk, wb, ww) in zip(got, want):
        for g, w in ((gk, wk), (gb, wb), (gw, ww)):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.fixture(scope="module")
def lpips_pair():
    return _pair((48, 40, 3), seed=5, noise=60)


def test_lpips_proxy_matches_jax(lpips_pair):
    a, b = lpips_pair
    jm = jax_lpips.PerceptualMetric()
    pm = port_lpips.PerceptualMetric(device="cpu")
    assert pm.kind == jm.kind == "lpips-random-proxy"
    want, got = jm(a, b), pm(a, b)
    assert got == pytest.approx(want, rel=1e-4)
    assert pm(a, a) == 0.0


def test_lpips_distance_is_differentiable(lpips_pair):
    a, b = lpips_pair
    pm = port_lpips.PerceptualMetric(device="cpu")
    x = (torch.from_numpy(b).float()[None] / 127.5 - 1.0).requires_grad_()
    ref = torch.from_numpy(a).float()[None] / 127.5 - 1.0
    d = pm.distance(x, ref)
    d.backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert float(x.grad.abs().sum()) > 0


def test_lpips_npz_layout_matches_jax(lpips_pair, tmp_path, monkeypatch):
    """Weights in the documented layout (HWIO kernels, biases, channel
    weights; any widths), read through TPUCDC_LPIPS_WEIGHTS."""
    rng = np.random.default_rng(9)
    arrays, cin = {}, 3
    for i, cout in enumerate((8, 8, 12, 12, 16)):
        arrays[f"conv{i}_kernel"] = rng.normal(
            size=(3, 3, cin, cout)).astype(np.float32) / (3 * cin)
        arrays[f"conv{i}_bias"] = rng.normal(size=cout).astype(np.float32)
        arrays[f"lin{i}"] = rng.random(cout).astype(np.float32)
        cin = cout
    path = tmp_path / "lpips.npz"
    np.savez(path, **arrays)
    monkeypatch.setenv("TPUCDC_LPIPS_WEIGHTS", str(path))
    a, b = lpips_pair
    jm = jax_lpips.PerceptualMetric()
    pm = port_lpips.PerceptualMetric(device="cpu")
    assert pm.kind == jm.kind == "lpips"
    assert pm(a, b) == pytest.approx(jm(a, b), rel=1e-4)
    fx = port_fid._FeatureExtractor(device="cpu")
    assert fx.kind == "vgg-lpips"
    assert fx(a).shape == (1, 16)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(10)
    x, y = rng.normal(size=(40, 8)), rng.normal(1.0, 2.0, size=(30, 8))
    args = (x.mean(0), np.cov(x, rowvar=False), y.mean(0),
            np.cov(y, rowvar=False))
    assert port_fid.frechet_distance(*args) == pytest.approx(
        jax_fid.frechet_distance(*args), rel=1e-3)


def test_fid_accumulator_matches_jax():
    """3 + 3 images, added one by one on the real side and as one batch on
    the fake side."""
    real = [_pair((32, 32, 3), seed=20 + i)[0] for i in range(3)]
    fake = np.stack([_pair((32, 32, 3), seed=20 + i, noise=40)[1]
                     for i in range(3)])
    jacc = jax_fid.FIDAccumulator()
    pacc = port_fid.FIDAccumulator(device="cpu")
    for acc in (jacc, pacc):
        for r in real:
            acc.add("real", r[None])
        acc.add("fake", fake)
    assert pacc._stats["real"].n == pacc._stats["fake"].n == 3
    assert pacc.extractor.kind == jacc.extractor.kind == "random-conv"
    # The features: the last LPIPS tap, mean-pooled to 512.
    want_f, got_f = jacc.extractor(fake), pacc.extractor(fake)
    assert got_f.shape == want_f.shape == (3, 512)
    assert got_f.dtype == np.float32
    assert np.max(np.abs(got_f - want_f)) <= 1e-4 * np.max(np.abs(want_f))
    want, got = jacc.compute(), pacc.compute()
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("fn,args", [
    ("synthetic_images", (2, 64, 96)),
    ("synthetic_images_rich", (2, 64, 128)),
], ids=["synthetic_images", "synthetic_images_rich"])
def test_synthetic_sets_bit_equal(fn, args):
    for seed in (0, 11):
        want = getattr(jax_data, fn)(*args, seed=seed)
        got = getattr(port_data, fn)(*args, seed=seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["kodak", "clic2020", "tecnick"])
def test_eval_dataset_specs_and_seeds(name, monkeypatch, tmp_path):
    """Without a data directory every set falls back to JAX's synthetic
    set: the same count, size and seed."""
    env = port_data._SPECS[name][0]
    assert env == jax_data._SPECS[name][0]
    assert port_data._SPECS[name][2:] == jax_data._SPECS[name][2:]
    assert port_data._stable_seed(name) == jax_data._stable_seed(name)
    monkeypatch.setenv(env, str(tmp_path / "absent"))
    monkeypatch.setattr(port_data, "_SPECS", {
        name: (env, [], *port_data._SPECS[name][2:])})
    # A small stand-in for the synthetic fallback keeps this cheap; the
    # full-size Kodak fallback is compared below.
    calls = []
    monkeypatch.setattr(port_data, "synthetic_images",
                        lambda n, h, w, seed: calls.append((n, h, w, seed))
                        or [np.zeros((1, 1, 3), np.uint8)])
    ds = port_data.eval_dataset(name)
    assert ds.synthetic and ds.name == name
    n, (h, w) = jax_data._SPECS[name][2:]
    assert calls == [(n, h, w, jax_data._stable_seed(name))]


def test_kodak_fallback_bit_equal(monkeypatch, tmp_path):
    """The 24 synthetic 512×768 images of a Kodak eval without a data
    directory start with JAX's: one generator draws them in order, so JAX's
    first image of a one-image set is the set's first image."""
    monkeypatch.setenv("TPUCDC_KODAK_DIR", str(tmp_path / "absent"))
    ds = port_data.kodak()
    assert ds.synthetic and len(ds) == 24
    assert {im.shape for im in ds} == {(512, 768, 3)}
    want = jax_data.synthetic_images(1, 512, 768,
                                     seed=jax_data._stable_seed("kodak"))
    np.testing.assert_array_equal(ds.images[0], want[0])


def test_local_directory_is_read(monkeypatch, tmp_path):
    from PIL import Image
    imgs = port_data.synthetic_images(2, 32, 64, seed=1)
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(tmp_path / f"{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    monkeypatch.setenv("TPUCDC_TECNICK_DIR", str(tmp_path))
    ds = port_data.tecnick()
    assert not ds.synthetic and len(ds) == 2
    for got, want in zip(ds, imgs):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("as_uint8", [False, True])
def test_train_crop_iterator_bit_equal(as_uint8):
    imgs = jax_data.synthetic_images(3, 64, 96, seed=2)
    want = jax_data.train_crop_iterator(imgs, 4, 32, seed=5,
                                        as_uint8=as_uint8)
    got = port_data.train_crop_iterator(imgs, 4, 32, seed=5,
                                        as_uint8=as_uint8)
    for _ in range(2):
        g, w = next(got), next(want)
        assert g.dtype == w.dtype and g.shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(g, w)


def test_train_crop_iterator_rejects_small_images():
    with pytest.raises(ValueError, match="at least"):
        next(port_data.train_crop_iterator(
            [np.zeros((8, 8, 3), np.uint8)], 1, 16))


def test_local_image_corpus_matches_jax():
    """The bundled real images: the same files in the same order (however
    many of the packages that carry them are installed)."""
    want = jax_data.local_image_corpus("holdout")
    got = port_data.local_image_corpus("holdout")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
