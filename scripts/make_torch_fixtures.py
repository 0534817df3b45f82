"""Make the PyTorch port's fixtures with the JAX package on the CPU.

The port (tpucdc_torch/) cannot import JAX, so its parity checks on the card
read reference outputs that the JAX package made here. This script builds
the served flagship (``artifacts/flagship.json``: the
``build_eval_config(wide=True, unet="medium", prediction="residual")`` model
on ``artifacts/flagship_params.npz``, serving dial 5 steps / truncate 0.15 /
γ 0.5) under F32_POLICY, so that every σ → row-index decision is f32, and
writes into ``tpucdc_torch/fixtures/``:

  flagship_384x512.npz — one 384×512 holdout crop (the first crop of
      ``scripts/train_rd_sweep.py::split_eval_images("holdout")``):
        blob            the ``compress(optimize_gamma="spatial")`` bitstream
                        (the flagship's encode default; a v5 container);
        z_* / y_*       the JAX runtime's ``export_cdf_tables()``;
        z_sym, indexes, y_sym   what ``_decode_symbols`` decodes;
        eps             the initial ε JAX's ``decompress(rng=key(0))`` draws;
        mean_u8         JAX ``decompress(steps=0)`` (the mean decode x̄);
        serve_u8        JAX ``decompress()`` (the served decode);
        crop_u8         the uint8 crop that was encoded, so that the port
                        can encode it too;
        crop128_blob, crop128_z_sym, crop128_y_sym   a plain ``compress`` of
                        the crop's top-left 128×128 and its symbols, for
                        the full-width encode test on the CPU.
  flagship_modes.npz — the other ways to decode, for the same crop and ε:
        guide2_u8       JAX ``decompress(guidance=2.0)`` of ``blob``;
        cache2_u8       JAX ``decompress()`` of ``blob`` under
                        ``sample.cache_period=2`` (block-cached DDIM);
        tiled_mean_u8   JAX ``decompress_tiled(tile=256, halo=32, steps=0)``
                        of flagship_768x512.tpucdc (6 tiles of 320×320).
  flagship_768x512.tpucdc — a plain ``compress`` of bench.py's image
      (``synthetic_images(1, 512, 768, seed=7)[0]``), for timing.
  image_768x512.npz — that image itself (``image_u8``), for timing encodes.
  vr_wide_384x512.npz — the variable-rate model of ``artifacts/vr.json``
      (``vr_sc_config(wide=True, prediction="residual")`` on
      ``artifacts/vr_wide_params.npz``; space-channel context, 3 gain rows)
      on the same crop, at qualities 0, 1, 2 and 0.5 (tags q0, q1, q2,
      q0p5):
        qualities       the four qualities, in tag order;
        blob_<tag>      the ``compress(quality=q)`` bitstream (q0p5 is v4);
        z_sym_<tag>, y_sym_<tag>   the symbols it decodes to (int8 where
                        they fit, else int16);
        indexes_<tag>   the Gaussian row indexes of the 8 passes, in pass
                        order (group 0 anchors, group 0 non-anchors, ...),
                        each in stream order, uint8 [8, positions, 48];
        mean_u8_<tag>   JAX ``decompress(steps=0)``.
  flagship_train_step.npz — one training step's loss and gradients of the
      flagship recipe (scripts/r4d_queue.sh: the served flagship's model
      with the t-low bias 0.35/0.5; λ 128, distortion "both", LPIPS 15) on
      the trained weights, under F32_POLICY, at batch 2 and crop 192: the
      two 192×192 crops of the holdout crop's top row, uint8 (batch_u8);
      the draws of ``CDCModel.__call__`` under ``jax.random.key(0)`` in the
      port's layout (draw_u_z, draw_u_y, draw_keep, draw_t, draw_eps);
      metric_<name> for every metric of ``loss_fn``; grad_names and
      grad_norms, every parameter's gradient 2-norm under the port's names;
      grad__<name>, the full gradient of each parameter that feeds a kernel
      and is small enough to store: every GN+SiLU scale and bias, every
      attention block's q/k/v biases, and the mid block's q/k/v weights.
  eval_384x512.npz — JAX's eval metrics of the flagship fixture's decodes
      against its crop, for the pairs (crop_u8, serve_u8) and (crop_u8,
      mean_u8) of flagship_384x512.npz (tags serve, mean):
        psnr_<tag>, ms_ssim_<tag>, gmsd_<tag>   ``tpucdc.eval.metrics``;
        lpips_<tag>     ``PerceptualMetric()`` (the random-conv proxy);
        features        ``fid._FeatureExtractor()`` of crop_u8, serve_u8
                        and mean_u8, in that order, float32 [3, 512].

Usage (from the repo root; a few minutes on a CPU host):
    python scripts/make_torch_fixtures.py
One fixture alone, e.g. the training step's:
    python -c "import sys; sys.path.insert(0, 'scripts'); import \
make_torch_fixtures as m; from train_rd_sweep import split_eval_images; \
m.write_train_step_fixture(split_eval_images('holdout')[0])"
"""

import dataclasses
import json
import pathlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from train_rd_sweep import build_eval_config, split_eval_images  # noqa: E402

from tpucdc.data import synthetic_images  # noqa: E402
from tpucdc.eval import PerceptualMetric, gmsd, ms_ssim, psnr  # noqa: E402
from tpucdc.eval.fid import _FeatureExtractor  # noqa: E402
from tpucdc.entropy import read_bitstream  # noqa: E402
from tpucdc.model import CDCModel  # noqa: E402
from tpucdc.ops import make_schedule  # noqa: E402
from tpucdc.pipelines.codec_runtime import CodecRuntime  # noqa: E402
from tpucdc.runtime import F32_POLICY  # noqa: E402
from tpucdc.sampling.ddim import _normal, _rng_streams  # noqa: E402
from tpucdc.utils.checkpoint import load_params_npz  # noqa: E402

# The imported scripts point JAX's persistent compile cache outside the
# checkout; this script writes nothing there.
jax.config.update("jax_enable_compilation_cache", False)

OUT = ROOT / "tpucdc_torch" / "fixtures"


def flagship_runtime(cache_period: int = 1):
    spec = json.loads((ROOT / "artifacts" / "flagship.json").read_text())
    serving = spec["serving"]
    cfg = build_eval_config(bool(spec["wide"]), spec["unet"],
                            spec["prediction"])
    cfg = dataclasses.replace(cfg, sample=dataclasses.replace(
        cfg.sample, steps=int(serving["steps"]),
        truncate_frac=float(serving["truncate_frac"]),
        blend_gamma=float(serving["gamma"]), cache_period=cache_period))
    return _runtime(cfg, ROOT / spec["params_npz"])


def _runtime(cfg, params_npz):
    """An F32_POLICY JAX runtime of ``cfg`` on the weights of ``params_npz``."""
    model = CDCModel(cfg.model.validated(), policy=F32_POLICY)
    sched = make_schedule(cfg.model.schedule.kind,
                          cfg.model.schedule.num_steps)
    tables = {"sqrt_ab": sched.sqrt_alpha_bars,
              "sqrt_1mab": sched.sqrt_one_minus_alpha_bars}
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    abstract = jax.eval_shape(
        lambda: model.init(jax.random.key(0), x, jax.random.key(0), tables))
    return CodecRuntime(cfg, model, load_params_npz(params_npz, abstract))


def vr_wide_runtime():
    from train_vr_sweep import vr_sc_config
    spec = json.loads((ROOT / "artifacts" / "vr.json").read_text())
    serving = spec["serving"]
    cfg = vr_sc_config(50000, 16, context=spec["context"], wide=True,
                       prediction=spec["prediction"])
    cfg = dataclasses.replace(cfg, sample=dataclasses.replace(
        cfg.sample, steps=int(serving["steps"]),
        truncate_frac=float(serving["truncate_frac"]),
        blend_gamma=float(serving["gamma"])))
    return _runtime(cfg, ROOT / spec["params_npz"])


def _small_int(a) -> np.ndarray:
    a = np.asarray(a)
    dtype = np.int8 if np.abs(a).max() <= 127 else np.int16
    return a.astype(dtype)


def _quality_tag(q: float) -> str:
    return "q" + f"{q:g}".replace(".", "p")


VR_QUALITIES = (0.0, 1.0, 2.0, 0.5)


def write_eval_fixture(crop, serve_u8, mean_u8):
    """JAX's metrics, LPIPS proxy and FID features of the two decodes."""
    lpips = PerceptualMetric()
    arrays = {"features": np.asarray(
        _FeatureExtractor()(np.stack([crop, serve_u8, mean_u8])), np.float32)}
    for tag, rec in (("serve", serve_u8), ("mean", mean_u8)):
        arrays[f"psnr_{tag}"] = np.float64(psnr(crop, rec))
        arrays[f"ms_ssim_{tag}"] = np.float64(ms_ssim(crop, rec))
        arrays[f"gmsd_{tag}"] = np.float64(gmsd(crop, rec))
        arrays[f"lpips_{tag}"] = np.float64(lpips(crop, rec))
    np.savez_compressed(OUT / "eval_384x512.npz", **arrays)
    print("eval_384x512.npz: " + ", ".join(
        f"{k} {float(v):.6f}" for k, v in arrays.items() if v.ndim == 0))


TRAIN_LAMBDA, TRAIN_LPIPS, TRAIN_CROP = 128.0, 15.0, 192


def write_train_step_fixture(crop):
    """flagship_train_step.npz (see the module docstring)."""
    from tpucdc.pipelines.train import loss_fn, schedule_tables
    from tests._torch_jax_helpers import jax_forward_draws_np
    from tpucdc_torch.utils import params_from_jax

    t0 = time.time()
    rt = flagship_runtime()
    cfg = dataclasses.replace(rt.config, model=dataclasses.replace(
        rt.config.model, t_low_frac=0.35, t_low_prob=0.5))
    model = CDCModel(cfg.model.validated(), policy=F32_POLICY)
    c = TRAIN_CROP
    batch_u8 = np.stack([crop[:c, :c], crop[:c, c:2 * c]])
    batch = jnp.asarray(batch_u8.astype(np.float32) * (1.0 / 127.5) - 1.0)
    tables = schedule_tables(cfg)
    rng = jax.random.key(0)
    lpips = PerceptualMetric()
    grads, metrics = jax.jit(jax.grad(
        lambda p: loss_fn(model, p, batch, rng, tables, TRAIN_LAMBDA,
                          distortion="both", lpips_weight=TRAIN_LPIPS,
                          lpips_fn=lpips.distance),
        has_aux=True))(rt.params)
    draws = jax_forward_draws_np(cfg.model, rng, batch.shape,
                                 cfg.model.schedule.num_steps)
    leaves = jax.tree_util.tree_flatten_with_path(grads)[0]
    flat = {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in leaves}
    named, _ = params_from_jax(flat)
    names = sorted(named)
    arrays = {"batch_u8": batch_u8,
              "grad_names": np.asarray(names),
              "grad_norms": np.asarray([np.linalg.norm(
                  named[n].numpy().astype(np.float64)) for n in names])}
    arrays.update({f"draw_{k}": v for k, v in draws.items()})
    arrays.update({f"metric_{k}": np.asarray(v, np.float64)
                   for k, v in metrics.items()})
    for n in names:
        leaf = n.rsplit(".", 2)
        gn = n.endswith((".scale", ".bias")) and (
            "norm1" in n or "norm_out" in n or "_norm." in n)
        attn = ("attn" in n and leaf[-2] in ("q", "k", "v")
                and (leaf[-1] == "bias" or ".mid_" in n))
        if gn or attn:
            arrays[f"grad__{n}"] = named[n].numpy()
    np.savez_compressed(OUT / "flagship_train_step.npz", **arrays)
    kept = sum(k.startswith("grad__") for k in arrays)
    print(f"flagship_train_step.npz: loss {float(metrics['loss']):.6f}, "
          f"{len(names)} gradient norms, {kept} full gradients, "
          f"{time.time() - t0:.1f} s")


def main():
    t0 = time.time()
    OUT.mkdir(parents=True, exist_ok=True)
    rt = flagship_runtime()

    crop = split_eval_images("holdout")[0]
    blob = rt.compress(crop, optimize_gamma="spatial")
    hdr, z_sym, _, (ph, pw) = rt._host_z_stage(blob)
    _, indexes = rt._hyper_means_indexes(jnp.asarray(z_sym))
    _, y_sym, _, _ = rt._decode_symbols(blob)
    _, init_rng = _rng_streams(jax.random.key(0))
    eps = _normal(init_rng, (1, ph, pw, 3))
    mean_u8 = rt.decompress(blob, steps=0)
    serve_u8 = rt.decompress(blob, rng=jax.random.key(0))
    blob128 = rt.compress(crop[:128, :128])
    _, z128, _, _ = rt._host_z_stage(blob128)
    _, y128, _, _ = rt._decode_symbols(blob128)
    np.savez_compressed(
        OUT / "flagship_384x512.npz",
        blob=np.frombuffer(blob, np.uint8),
        z_sym=np.asarray(z_sym, np.int32),
        indexes=np.asarray(indexes, np.uint8),
        y_sym=np.asarray(y_sym, np.int32),
        eps=np.asarray(eps, np.float32),
        mean_u8=mean_u8, serve_u8=serve_u8, crop_u8=crop,
        crop128_blob=np.frombuffer(blob128, np.uint8),
        crop128_z_sym=np.asarray(z128, np.int32),
        crop128_y_sym=np.asarray(y128, np.int32),
        **rt.export_cdf_tables())
    print(f"flagship_384x512.npz: {len(blob)} B blob, header v5 grid "
          f"{None if hdr.gamma_grid is None else hdr.gamma_grid.shape}, "
          f"{time.time() - t0:.1f} s")
    write_eval_fixture(crop, serve_u8, mean_u8)
    write_train_step_fixture(crop)

    img = synthetic_images(1, 512, 768, seed=7)[0]
    blob768 = rt.compress(img)
    (OUT / "flagship_768x512.tpucdc").write_bytes(blob768)
    np.savez_compressed(OUT / "image_768x512.npz", image_u8=img)

    np.savez_compressed(
        OUT / "flagship_modes.npz",
        guide2_u8=rt.decompress(blob, rng=jax.random.key(0), guidance=2.0),
        cache2_u8=flagship_runtime(cache_period=2).decompress(
            blob, rng=jax.random.key(0)),
        tiled_mean_u8=rt.decompress_tiled(blob768, tile=256, halo=32,
                                          steps=0))
    print(f"flagship_modes.npz: {time.time() - t0:.1f} s")

    vr = vr_wide_runtime()
    arrays = {"qualities": np.asarray(VR_QUALITIES, np.float32)}
    for q in VR_QUALITIES:
        tag = _quality_tag(q)
        blob = vr.compress(crop, quality=q)
        hdr, streams = read_bitstream(blob)
        z_rows = np.broadcast_to(
            np.arange(vr._hyper_c, dtype=np.int32),
            (1, crop.shape[0] // 64, crop.shape[1] // 64, vr._hyper_c))
        z_sym = vr.z_codec.decode(streams[0], z_rows)
        pass_indexes = []
        real_decode = vr.y_codec.decode

        def recording_decode(data, indexes):
            pass_indexes.append(np.asarray(indexes, np.uint8)[0])
            return real_decode(data, indexes)

        vr.y_codec.decode = recording_decode
        try:
            _, y_sym, _, _ = vr._decode_symbols(blob)
        finally:
            del vr.y_codec.decode
        arrays[f"indexes_{tag}"] = np.stack(pass_indexes)
        arrays[f"blob_{tag}"] = np.frombuffer(blob, np.uint8)
        arrays[f"z_sym_{tag}"] = _small_int(z_sym)
        arrays[f"y_sym_{tag}"] = _small_int(y_sym)
        arrays[f"mean_u8_{tag}"] = vr.decompress(blob, steps=0)
        print(f"vr_wide {tag}: {len(blob)} B, container v{blob[4]}, "
              f"{len(streams)} streams, {time.time() - t0:.1f} s")
    np.savez_compressed(OUT / "vr_wide_384x512.npz", **arrays)
    print(f"done in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
