"""Eval harness: R-D sweeps, step/guidance sweeps and decode latency,
mirroring tpucdc/eval/harness.py.

bpp counts real bitstream bytes, never a likelihood. Decode times are wall
times of ``decompress``, which returns the uint8 image on the host, so the
card's work is inside them. Every row is a plain dict with the JAX
package's keys, so the CLI can stream JSONL.

Where JAX passes one PRNG key, the port passes a ``torch.Generator`` on the
runtime's device seeded with ``EvalOptions.seed``, a fresh one per image as
JAX reuses its key per image; ``time_decode`` seeds iteration i with i.
The metrics and LPIPS run on the runtime's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from tpucdc_torch.data.datasets import EvalDataset
from tpucdc_torch.eval.fid import FIDAccumulator
from tpucdc_torch.eval.lpips import PerceptualMetric
from tpucdc_torch.eval.metrics import gmsd, ms_ssim, psnr
from tpucdc_torch.pipelines.codec_runtime import CodecRuntime


@dataclasses.dataclass
class EvalOptions:
    steps: int = 100
    guidance: float = 1.0
    eta: float = 0.0
    tiled: bool = False
    tile: int = 256
    halo: int = 32
    # A DeviceMesh (runtime.make_mesh): the tiled decode's tiles sharded
    # over its data axis; every rank runs the eval.
    mesh: Any = None
    seed: int = 0
    compute_lpips: bool = True


def _generator(runtime: CodecRuntime, seed: int) -> torch.Generator:
    return torch.Generator(runtime.device).manual_seed(seed)


def evaluate_image(runtime: CodecRuntime, img: np.ndarray,
                   opts: EvalOptions, perceptual: Optional[PerceptualMetric]
                   ) -> tuple[dict, np.ndarray]:
    """Compress and decompress one HWC uint8 image; (metrics row, recon)."""
    h, w = img.shape[:2]
    n_pixels = h * w

    t0 = time.perf_counter()
    blob = runtime.compress(img)
    t1 = time.perf_counter()
    gen = _generator(runtime, opts.seed)
    if opts.tiled:
        recon = runtime.decompress_tiled(blob, generator=gen, tile=opts.tile,
                                         halo=opts.halo, mesh=opts.mesh,
                                         steps=opts.steps)
    else:
        recon = runtime.decompress(blob, generator=gen, steps=opts.steps,
                                   eta=opts.eta, guidance=opts.guidance)
    t2 = time.perf_counter()

    dev = runtime.device
    row = {
        "bpp": len(blob) * 8 / n_pixels,
        "bytes": len(blob),
        "psnr": psnr(img, recon, device=dev),
        "ms_ssim": ms_ssim(img, recon, device=dev),
        "gmsd": gmsd(img, recon, device=dev),
        "encode_s": t1 - t0,
        "decode_s": t2 - t1,
        "steps": opts.steps,
        "steps_per_sec": opts.steps / max(t2 - t1, 1e-9),
        "height": h, "width": w,
    }
    if perceptual is not None:
        row["lpips"] = perceptual(img, recon)
        row["lpips_kind"] = perceptual.kind
    return row, recon


def evaluate_dataset(runtime: CodecRuntime, dataset: EvalDataset,
                     opts: EvalOptions,
                     on_row: Optional[Callable[[dict], None]] = None,
                     on_recon: Optional[Callable[[int, np.ndarray, np.ndarray],
                                                 None]] = None) -> dict:
    """Per-image metrics over a dataset at O(1) image memory.

    Reconstructions are not kept; a consumer that needs them (FID feature
    accumulation) streams them through ``on_recon(i, img, recon)``."""
    perceptual = (PerceptualMetric(device=runtime.device)
                  if opts.compute_lpips else None)
    rows = []
    for i, img in enumerate(dataset):
        row, recon = evaluate_image(runtime, img, opts, perceptual)
        row.update({"dataset": dataset.name, "synthetic": dataset.synthetic,
                    "image": i})
        rows.append(row)
        if on_recon:
            on_recon(i, img, recon)
        if on_row:
            on_row(row)
    agg = aggregate(rows)
    agg.update({"dataset": dataset.name, "synthetic": dataset.synthetic,
                "num_images": len(rows)})
    return {"rows": rows, "aggregate": agg}


def aggregate(rows: list[dict]) -> dict:
    keys = ("bpp", "psnr", "ms_ssim", "gmsd", "lpips", "decode_s",
            "steps_per_sec")
    out = {}
    for k in keys:
        vals = [r[k] for r in rows if k in r]
        if vals:
            out[k] = float(np.mean(vals))
    return out


def rd_sweep(make_runtime: Callable[[float], CodecRuntime],
             lambdas: Iterable[float], dataset: EvalDataset,
             opts: EvalOptions,
             on_row: Optional[Callable[[dict], None]] = None) -> list[dict]:
    """R-D curve over a λ grid: one runtime per λ, one aggregate row each."""
    points = []
    for lam in lambdas:
        runtime = make_runtime(lam)
        res = evaluate_dataset(runtime, dataset, opts, on_row)
        point = dict(res["aggregate"])
        point["rd_lambda"] = lam
        points.append(point)
    return points


def step_guidance_sweep(runtime: CodecRuntime, dataset: EvalDataset,
                        steps_grid: Iterable[int],
                        guidance_grid: Iterable[float],
                        base_opts: EvalOptions,
                        on_row: Optional[Callable[[dict], None]] = None
                        ) -> list[dict]:
    """Perceptual sweep: LPIPS and FID over a step-count × guidance grid,
    one aggregate row per point."""
    results = []
    for steps in steps_grid:
        for guidance in guidance_grid:
            opts = dataclasses.replace(base_opts, steps=steps,
                                       guidance=guidance)
            fid = FIDAccumulator(device=runtime.device)

            def feed_fid(_i, img, recon):
                # FID features accumulate image by image; no image is kept.
                fid.add("real", img[None])
                fid.add("fake", recon[None])

            res = evaluate_dataset(runtime, dataset, opts, on_row,
                                   on_recon=feed_fid)
            row = dict(res["aggregate"])
            row.update({"steps": steps, "guidance": guidance,
                        "fid": fid.compute(),
                        "fid_features": fid.extractor.kind})
            results.append(row)
    return results


def time_decode(runtime: CodecRuntime, blob: bytes, steps: int,
                warmup: int = 1, iters: int = 3) -> dict:
    """Decode latency: median wall time of the whole bitstream → image path
    after ``warmup`` decodes; iteration i draws its noise from seed i."""
    for _ in range(warmup):
        runtime.decompress(blob, steps=steps)
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        out = runtime.decompress(blob, generator=_generator(runtime, i),
                                 steps=steps)
        times.append(time.perf_counter() - t0)
    return {"decode_s_median": float(np.median(times)),
            "decode_s_best": float(np.min(times)),
            "steps_per_sec": steps / float(np.median(times)),
            "out_shape": list(out.shape)}
