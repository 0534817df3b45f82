"""``python -m tpucdc_torch <verb>``, mirroring tpucdc/cli/main.py.

Verbs:
  compress    — image file(s) → .tpucdc bitstream(s).
  decompress  — .tpucdc bitstream(s) → PNG.
  eval        — dataset eval: R-D rows / latency / the perceptual sweep →
                JSONL.
  rd-sweep    — the R-D curve over the λ grid.
  train       — R-D training with checkpoints, in <workdir>/lambda{λ}/.

Config: ``--preset tiny|flagship`` plus ``--set a.b.c=value`` dot-overrides;
the trained flagship is ``--preset flagship`` with the ``--set`` list of
``presets.SERVING_OVERRIDES`` and ``--checkpoint
artifacts/flagship_params.npz``. ``--checkpoint`` reads a
``save_params_npz`` file (EMA weights) or a run directory of ``train`` (its
latest EMA weights); without one the weights are drawn from seed 0
(``api.load_model``). ``--device`` picks the card (``cuda``, the
default) or ``cpu``. ``--profile DIR`` writes a torch.profiler trace of the
decode or of the training run (``trace.json``) and the port's spans of its
requests (``spans.jsonl``). ``--seed`` seeds the decode's generator.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys

import numpy as np


def _read_image(path) -> np.ndarray:
    """An image file as HWC uint8 RGB."""
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def _write_image(path, img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(img).save(path)


def _build_config(args):
    from tpucdc_torch import api
    overrides = dict(kv.split("=", 1) for kv in (args.set or []))
    return api.build_config(args.preset, overrides)


def _load_runtime(args):
    from tpucdc_torch import api
    from tpucdc_torch.pipelines.codec_runtime import CodecRuntime

    cfg = _build_config(args)
    model = api.load_model(cfg, args.checkpoint)
    # --cdf-tables sidecar: loaded if present, so that the decode does not
    # rest on the float table build; else built and saved there.
    tables_path = args.cdf_tables
    tables = None
    if tables_path and pathlib.Path(tables_path).exists():
        tables = CodecRuntime.load_cdf_tables(tables_path)
    runtime = CodecRuntime(cfg, model, device=args.device, cdf_tables=tables)
    if tables_path and tables is None:
        runtime.save_cdf_tables(tables_path)
    return cfg, runtime


def _generator(runtime, seed: int):
    import torch
    return torch.Generator(runtime.device).manual_seed(seed)


def cmd_train(args):
    from tpucdc_torch import api
    from tpucdc_torch.utils import profile_trace

    overrides = dict(kv.split("=", 1) for kv in (args.set or []))
    with profile_trace(args.profile):
        api.train(args.preset, steps=args.steps, workdir=args.workdir,
                  overrides=overrides, device=args.device)


def _is_dir_output(inputs, output) -> bool:
    """Directory-output (batch) mode: several inputs, a trailing slash, or
    an existing directory, so that ``decompress blobs/*.tpucdc outs/`` works
    when the glob matches exactly one file."""
    return (len(inputs) > 1 or str(output).endswith(os.sep)
            or pathlib.Path(output).is_dir())


def _batch_outputs(inputs, output, suffix):
    """Per-input paths inside the ``output`` directory. Same-stem inputs
    from different directories become stem, stem_2, stem_3… instead of
    overwriting each other."""
    outdir = pathlib.Path(output)
    outdir.mkdir(parents=True, exist_ok=True)
    paths, used = [], {}
    for p in inputs:
        stem = pathlib.Path(p).stem
        used[stem] = used.get(stem, 0) + 1
        name = stem if used[stem] == 1 else f"{stem}_{used[stem]}"
        paths.append(outdir / (name + suffix))
    return paths


def cmd_compress(args):
    if args.target_bpp is not None and args.quality is not None:
        raise SystemExit("--target-bpp and --quality are exclusive")
    if args.optimize_gamma not in (False, True, "spatial"):
        raise SystemExit("--optimize-gamma takes no value or 'spatial'")
    _, runtime = _load_runtime(args)
    imgs = [_read_image(p) for p in args.input]
    batch = _is_dir_output(args.input, args.output)
    # Every per-file row echoes the quality used: an explicit --quality or
    # the one rate control chose.
    qualities = [args.quality] * len(imgs)
    if not batch:
        paths = [pathlib.Path(args.output)]
    else:
        paths = _batch_outputs(args.input, args.output, ".tpucdc")
    if args.target_bpp is not None:
        # Rate control: a continuous-quality bisection per image (VR model).
        blobs = []
        for i, im in enumerate(imgs):
            blob, q, _ = runtime.compress_to_bpp(
                im, args.target_bpp, optimize_gamma=args.optimize_gamma)
            blobs.append(blob)
            qualities[i] = q
    elif not batch or args.optimize_gamma:
        # The γ search is serial per image by construction.
        blobs = [runtime.compress(im, optimize_gamma=args.optimize_gamma,
                                  quality=args.quality) for im in imgs]
    else:
        blobs = runtime.compress_many(imgs, quality=args.quality)
    for path, img, blob, q in zip(paths, imgs, blobs, qualities):
        path.write_bytes(blob)
        bpp = len(blob) * 8 / (img.shape[0] * img.shape[1])
        row = {"bytes": len(blob), "bpp": bpp}
        if batch:
            row["file"] = str(path)
        if q is not None:
            row["quality"] = q
        if args.optimize_gamma:
            from tpucdc_torch.entropy import read_bitstream
            hdr = read_bitstream(blob)[0]
            row["gamma"] = hdr.gamma_or_none
            if hdr.gamma_grid is not None:
                row["gamma_grid"] = list(hdr.gamma_grid.shape)
        print(json.dumps(row))


def cmd_decompress(args):
    from tpucdc_torch.utils import profile_trace
    _, runtime = _load_runtime(args)
    blobs = [pathlib.Path(p).read_bytes() for p in args.input]
    dir_out = _is_dir_output(args.input, args.output)
    if dir_out:
        paths = _batch_outputs(args.input, args.output, ".png")
    else:
        paths = [pathlib.Path(args.output)]
    with profile_trace(args.profile):
        if args.tiled:
            # The tiled decode has no batch form: one image at a time, which
            # keeps the bounded device memory --tiled asks for.
            outs = [runtime.decompress_tiled(
                b, generator=_generator(runtime, args.seed),
                steps=args.steps) for b in blobs]
        elif len(blobs) == 1:
            outs = [runtime.decompress(
                blobs[0], generator=_generator(runtime, args.seed),
                steps=args.steps)]
        else:
            # Batch: one generator, drawn in image order.
            outs = runtime.decompress_many(
                blobs, generator=_generator(runtime, args.seed),
                steps=args.steps)
    for path, out in zip(paths, outs):
        _write_image(path, out)
        row = {"shape": list(out.shape)}
        if dir_out:
            row["file"] = str(path)
        print(json.dumps(row))


def cmd_eval(args):
    from tpucdc_torch import presets
    from tpucdc_torch.data import eval_dataset
    from tpucdc_torch.eval.harness import (EvalOptions, evaluate_dataset,
                                           step_guidance_sweep, time_decode)
    from tpucdc_torch.runtime.mesh import is_rank0
    from tpucdc_torch.utils import MetricLogger

    mesh = None
    if args.mesh:
        # Join the launcher's world (and take this rank's card) before the
        # runtime picks its device; every rank evaluates, rank 0 writes.
        import torch.distributed as dist
        from tpucdc_torch.runtime import make_mesh, maybe_init_distributed
        if not dist.is_initialized():
            maybe_init_distributed(args.device)
        mesh = make_mesh(device=args.device)
    cfg, runtime = _load_runtime(args)
    ds = eval_dataset(args.dataset)
    logger = MetricLogger(args.workdir or cfg.workdir) if is_rank0() else None
    on_row = logger.write_row if logger is not None else None
    opts = EvalOptions(steps=args.steps or cfg.sample.steps,
                       tiled=args.tiled, mesh=mesh,
                       compute_lpips=not args.no_lpips)

    if args.sweep == "perceptual":
        # LPIPS/FID over the step-count × guidance grid.
        rows = step_guidance_sweep(runtime, ds, presets.STEP_GRID,
                                   presets.GUIDANCE_GRID, opts,
                                   on_row=on_row)
        out = rows
    elif args.sweep == "latency":
        # Decode latency and steps/s on the first image.
        blob = runtime.compress(ds.images[0])
        rows = [time_decode(runtime, blob, steps=opts.steps)]
        out = rows[0]
    else:
        res = evaluate_dataset(runtime, ds, opts, on_row=on_row)
        rows = [{"aggregate": res["aggregate"]}]
        out = res["aggregate"]
    if logger is not None:
        for r in rows:
            logger.write_row(r)
        print(json.dumps(out, default=float))
        logger.close()


def cmd_rd_sweep(args):
    """The R-D curve over the λ grid. Each λ reads its latest EMA weights
    from <workdir>/lambda{λ}/ckpt (the train verb's layout); without one the
    weights are drawn from seed 0."""
    from tpucdc_torch import api, presets
    from tpucdc_torch.data import eval_dataset
    from tpucdc_torch.eval.harness import EvalOptions, rd_sweep
    from tpucdc_torch.pipelines.codec_runtime import CodecRuntime
    from tpucdc_torch.utils import MetricLogger

    cfg = _build_config(args)
    logger = MetricLogger(args.workdir or cfg.workdir)
    workdir = pathlib.Path(args.workdir or cfg.workdir)

    def make_runtime(lam: float) -> CodecRuntime:
        c = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, rd_lambda=lam))
        ckpt_dir = api.run_dir(workdir, c) / "ckpt"
        model = api.load_model(c, ckpt_dir if ckpt_dir.exists() else None)
        return CodecRuntime(c, model, device=args.device)

    ds = eval_dataset(args.dataset)
    opts = EvalOptions(steps=args.steps or cfg.sample.steps,
                       compute_lpips=not args.no_lpips)
    lambdas = ([float(x) for x in args.lambdas.split(",")]
               if args.lambdas else presets.RD_LAMBDA_GRID)
    points = rd_sweep(make_runtime, lambdas, ds, opts,
                      on_row=logger.write_row)
    for p in points:
        logger.write_row(p)
    print(json.dumps(points, default=float))
    logger.close()


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpucdc_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--preset", default="flagship",
                        choices=["tiny", "flagship"])
        sp.add_argument("--set", action="append", metavar="KEY=VAL")
        sp.add_argument("--checkpoint", default=None,
                        help="a save_params_npz file of EMA weights, or a "
                             "run directory of train")
        sp.add_argument("--workdir", default=None)
        sp.add_argument("--profile", default=None, metavar="TRACE_DIR")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--cdf-tables", default=None, metavar="NPZ",
                        help="coder-table sidecar: loaded if it exists, "
                             "else written after the build")
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")

    sp = sub.add_parser("train", help="R-D training")
    common(sp)
    sp.add_argument("--steps", type=int, default=None)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("compress")
    sp.add_argument("--optimize-gamma", nargs="?", const=True, default=False,
                    metavar="spatial",
                    help="encode-time per-image serving-dial search: decode "
                         "at gamma in {0,.25,.5,.75,1}, score PSNR against "
                         "the input, store the winner in the v3 header. "
                         "'--optimize-gamma spatial' also fits a per-tile "
                         "gamma grid in closed form and keeps it (v5 "
                         "header) when it beats the scalar pick")
    sp.add_argument("--quality", type=float, default=None,
                    help="continuous VR quality in [0, num_qualities-1]; "
                         "fractional values interpolate the trained gain "
                         "ladder (v4 header)")
    sp.add_argument("--target-bpp", type=float, default=None,
                    help="rate control: bisect the continuous quality dial "
                         "to hit this bits-per-pixel (VR model; exclusive "
                         "with --quality)")
    common(sp)
    sp.add_argument("input", nargs="+",
                    help="image file(s); with several, OUTPUT is a directory")
    sp.add_argument("output")
    sp.set_defaults(fn=cmd_compress)

    sp = sub.add_parser("decompress")
    common(sp)
    sp.add_argument("input", nargs="+",
                    help="bitstream file(s); with several, OUTPUT is a "
                         "directory and the decode is pipelined")
    sp.add_argument("output")
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--tiled", action="store_true")
    sp.set_defaults(fn=cmd_decompress)

    sp = sub.add_parser("eval")
    common(sp)
    sp.add_argument("--dataset", default="kodak",
                    choices=["kodak", "clic2020", "tecnick"])
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--tiled", action="store_true")
    sp.add_argument("--no-lpips", action="store_true")
    sp.add_argument("--mesh", action="store_true",
                    help="shard the tiled decode's tiles over the ranks "
                         "of the process group (one per card)")
    sp.add_argument("--sweep", default=None,
                    choices=["perceptual", "latency"])
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("rd-sweep", help="R-D curve over the λ grid")
    common(sp)
    sp.add_argument("--dataset", default="kodak",
                    choices=["kodak", "clic2020", "tecnick"])
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--no-lpips", action="store_true")
    sp.add_argument("--lambdas", default=None,
                    help="comma-separated λ values (default: preset grid)")
    sp.set_defaults(fn=cmd_rd_sweep)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
