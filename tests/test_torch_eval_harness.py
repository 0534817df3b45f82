"""tpucdc_torch's eval harness against the JAX package's, on the CPU.

Both packages carry JAX's tiny weights (``params_from_jax``) under
F32_POLICY and evaluate the same two synthetic 64×64 images with the mean
decode (``steps=0``), which draws no noise: the rows have the same keys,
the bitstreams are within 0.5 % in length, PSNR within 0.05 dB (the uint8
reconstructions differ by at most 1 LSB), MS-SSIM and GMSD within 1e-3 and
LPIPS within 1e-2 relative. The R-D and step/guidance sweeps are held to
JAX's on the mean decode with the same bounds and FID within 1e-3 relative;
the latency timer's keys and output shape are JAX's.
"""

import numpy as np
import pytest

from tpucdc.data.datasets import EvalDataset as JaxEvalDataset
from tpucdc.data.datasets import synthetic_images
from tpucdc.eval import harness as jax_harness
from tpucdc.pipelines.codec_runtime import CodecRuntime as JaxRuntime

from tests._torch_jax_helpers import (  # noqa: F401
    init_jax, one_blas_thread_per_module, one_torch_thread_per_module,
    tiny_config, to_torch_config, torch_model)
from tpucdc_torch import CodecRuntime, F32_POLICY
from tpucdc_torch.data import EvalDataset
from tpucdc_torch.pipelines import evaluate as port_eval
from tpucdc_torch.utils import MetricLogger, code_sha


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    """JAX's runtime reads the port's coder tables from the sidecar file
    (``save_cdf_tables`` → ``load_cdf_tables``) in place of its own build:
    the harness is under test here, and JAX's table build costs more than
    the rest of this file. The two builds are held to each other in
    test_torch_api_cli.py and the encode tests."""
    cfg = tiny_config(steps=2)
    jmodel, params = init_jax(cfg)
    trt = CodecRuntime(to_torch_config(cfg), torch_model(cfg, params),
                       device="cpu", policy=F32_POLICY)
    sidecar = tmp_path_factory.mktemp("tables") / "tables.npz"
    trt.save_cdf_tables(sidecar)
    jrt = JaxRuntime(cfg, jmodel, params,
                     cdf_tables=JaxRuntime.load_cdf_tables(sidecar))
    return jrt, trt


@pytest.fixture(scope="module")
def images():
    return synthetic_images(2, 64, 64, seed=5)


@pytest.fixture(scope="module")
def rows(runtimes, images):
    """JAX's and the port's evaluate_dataset at steps=0, with LPIPS."""
    jrt, trt = runtimes
    jres = jax_harness.evaluate_dataset(
        jrt, JaxEvalDataset("synthetic", images, True),
        jax_harness.EvalOptions(steps=0))
    seen, recons = [], []
    tres = port_eval.evaluate_dataset(
        trt, EvalDataset("synthetic", images, True),
        port_eval.EvalOptions(steps=0), on_row=seen.append,
        on_recon=lambda i, img, rec: recons.append((i, img, rec)))
    return jres, tres, seen, recons


def test_evaluate_dataset_rows_match_jax(rows):
    jres, tres, seen, recons = rows
    assert len(tres["rows"]) == len(jres["rows"]) == 2
    assert seen == tres["rows"]
    assert [i for i, _, _ in recons] == [0, 1]
    for want, got in zip(jres["rows"], tres["rows"]):
        assert set(got) == set(want)
        assert abs(got["bytes"] - want["bytes"]) <= 0.005 * want["bytes"]
        assert abs(got["psnr"] - want["psnr"]) <= 0.05
        assert abs(got["ms_ssim"] - want["ms_ssim"]) <= 1e-3
        assert abs(got["gmsd"] - want["gmsd"]) <= 1e-3
        assert got["lpips"] == pytest.approx(want["lpips"], rel=1e-2)
        for k in ("steps", "height", "width", "dataset", "synthetic",
                  "image", "lpips_kind"):
            assert got[k] == want[k], k


def test_evaluate_dataset_aggregate_is_the_mean(rows):
    jres, tres, _, _ = rows
    agg = tres["aggregate"]
    assert set(agg) == set(jres["aggregate"])
    assert agg["num_images"] == 2 and agg["synthetic"] is True
    for k in ("bpp", "psnr", "ms_ssim", "gmsd", "lpips", "decode_s",
              "steps_per_sec"):
        assert agg[k] == pytest.approx(np.mean([r[k] for r in tres["rows"]]))


def test_evaluate_image_reconstruction(runtimes, images, rows):
    _, trt = runtimes
    _, _, _, recons = rows
    for i, img, rec in recons:
        assert rec.shape == img.shape and rec.dtype == np.uint8
        np.testing.assert_array_equal(rec, trt.decompress(
            trt.compress(img), steps=0))


def _assert_points_match_jax(got, want):
    """Aggregate rows of the mean decode: the same keys, bpp within 0.5 %,
    PSNR within 0.05 dB, MS-SSIM and GMSD within 1e-3, FID 1e-3 relative."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert abs(g["bpp"] - w["bpp"]) <= 0.005 * w["bpp"]
        assert abs(g["psnr"] - w["psnr"]) <= 0.05
        assert abs(g["ms_ssim"] - w["ms_ssim"]) <= 1e-3
        assert abs(g["gmsd"] - w["gmsd"]) <= 1e-3
        for k in ("num_images", "synthetic", "dataset", "steps", "guidance",
                  "rd_lambda", "fid_features"):
            assert g.get(k) == w.get(k), k
        if "fid" in w:
            assert np.isfinite(g["fid"])
            assert g["fid"] == pytest.approx(w["fid"], rel=1e-3)


def test_step_guidance_sweep(runtimes, images):
    """Steps (0, 2) × guidance (1.0, 2.0) on one image: an aggregate row per
    point with FID. The mean decode's rows match JAX's sweep of steps (0,);
    guidance changes the refined decode."""
    jrt, trt = runtimes
    ds = EvalDataset("synthetic", images[:1], True)
    opts = dict(compute_lpips=False)
    seen = []
    out = port_eval.step_guidance_sweep(
        trt, ds, (0, 2), (1.0, 2.0), port_eval.EvalOptions(**opts),
        on_row=seen.append)
    want = jax_harness.step_guidance_sweep(
        jrt, JaxEvalDataset("synthetic", images[:1], True), (0,), (1.0, 2.0),
        jax_harness.EvalOptions(**opts))
    assert [(r["steps"], r["guidance"]) for r in out] == [
        (0, 1.0), (0, 2.0), (2, 1.0), (2, 2.0)]
    assert len(seen) == 4
    for r in out:
        assert r["num_images"] == 1 and np.isfinite(r["fid"])
        assert r["fid_features"] == "random-conv" and "lpips" not in r
    _assert_points_match_jax(out[:2], want)
    assert out[2]["psnr"] != out[3]["psnr"]


def test_rd_sweep(runtimes, images):
    """One runtime per λ, one aggregate row each, as JAX's sweep."""
    jrt, trt = runtimes
    made = []

    def make_runtime(lam):
        made.append(lam)
        return trt

    opts = dict(steps=0, compute_lpips=False)
    points = port_eval.rd_sweep(make_runtime, (4.0, 8.0),
                                EvalDataset("synthetic", images[:1], True),
                                port_eval.EvalOptions(**opts))
    want = jax_harness.rd_sweep(lambda lam: jrt, (4.0, 8.0),
                                JaxEvalDataset("synthetic", images[:1], True),
                                jax_harness.EvalOptions(**opts))
    assert made == [4.0, 8.0]
    assert [p["rd_lambda"] for p in points] == [4.0, 8.0]
    assert points[0]["bpp"] == points[1]["bpp"] > 0
    _assert_points_match_jax(points, want)


def test_time_decode(runtimes, images):
    """The port's timer on the refined decode; its keys and output shape
    are JAX's timer's on the mean decode."""
    jrt, trt = runtimes
    blob = trt.compress(images[0])
    t = port_eval.time_decode(trt, blob, steps=2, warmup=1, iters=2)
    want = jax_harness.time_decode(jrt, jrt.compress(images[0]), steps=0,
                                   warmup=1, iters=2)
    assert set(t) == set(want) == {"decode_s_median", "decode_s_best",
                                   "steps_per_sec", "out_shape"}
    assert t["out_shape"] == want["out_shape"] == [64, 64, 3]
    assert 0 < t["decode_s_best"] <= t["decode_s_median"]
    assert t["steps_per_sec"] == pytest.approx(2 / t["decode_s_median"])


def test_metric_logger(tmp_path, capsys):
    log = MetricLogger(tmp_path / "logs")
    log(3, {"loss": 0.5, "note": "skipped"})
    log.write_row({"psnr": np.float32(30.5)})
    log.write_row({"code_sha": "abc"})
    log.close()
    import json
    lines = [json.loads(ln) for ln in
             (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["step"] == 3 and lines[0]["loss"] == 0.5
    assert "note" not in lines[0]
    assert lines[0]["code_sha"] == lines[1]["code_sha"] == code_sha()
    assert lines[1]["psnr"] == 30.5
    assert lines[2]["code_sha"] == "abc"
    assert "[step 3] loss=0.5" in capsys.readouterr().err


def test_from_model_range_matches_jax():
    from tpucdc.pipelines.codec_runtime import from_model_range as jax_fmr
    from tpucdc_torch.pipelines.codec_runtime import from_model_range
    x = np.random.default_rng(3).uniform(-1.2, 1.2, (8, 9, 3)).astype(
        np.float32)
    got = from_model_range(x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_fmr(x))
