#!/usr/bin/env python3
"""What tpucdc_torch's batch decode hides, and what a worker thread would
cost: wall times of four 768×512-class images under BF16_POLICY.

For the flagship (hyperprior) and for ``vr_wide`` at quality 1 (space-channel
context), in turns within each round, the order reversed every other round,
each ended by ``torch.cuda.synchronize()``:

  symbols_only   ``_decode_symbols`` of every bitstream (what there is to hide)
  one_by_one     ``decompress`` in a loop
  many           ``decompress_many``: image i+1's symbol decode inline on the
                 main thread after image i's sampler is queued
  many_threaded  the same loop with image i+1's symbol decode on a worker
                 thread under a side stream, handed to the main stream by an
                 event and ``record_stream`` (the JAX package's design for its
                 context models). Kept here, not in the package: it loses,
                 because both threads issue PyTorch operations and pass the
                 interpreter lock back and forth. Time it again once the
                 device stage is a CUDA graph.

Every variant must give the pixels of ``one_by_one``. Prints one JSON line per
model with the median of the rounds after the first and every round, and
writes ``chiprun_out/time_torch_batch.json``. Needs a CUDA device; imports
nothing of JAX or tpucdc.

Usage: python3 scripts/time_torch_batch.py [--rounds N]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tpucdc_torch" / "fixtures"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=9)
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_batch: no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    import tpucdc_torch as port
    from tpucdc_torch.pipelines.codec_runtime import pad_image

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    img = np.load(FIXTURES / "image_768x512.npz")["image_u8"]
    crop = np.load(FIXTURES / "flagship_384x512.npz")["crop_u8"]
    imgs = [img, crop, img[:, ::-1].copy(), img[::-1].copy()]
    reports = []
    for name, cfg, weights, enc in (
            ("flagship", port.flagship_serving(), "flagship_params.npz", {}),
            ("vr_wide", port.vr_wide_serving(), "vr_wide_params.npz",
             {"quality": 1})):
        model = port.CDCModel(cfg.model)
        model.load_state_dict(
            port.load_params_npz(ROOT / "artifacts" / weights)[0], strict=True)
        rt = port.CodecRuntime(cfg, model, device=dev, policy=port.BF16_POLICY)
        blobs = rt.compress_many(imgs, **enc)
        gen = torch.Generator(dev).manual_seed(5)
        noise = [torch.randn((1, *pad_image(im)[0].shape[:2], 3),
                             generator=gen, device=dev) for im in imgs]

        side = torch.cuda.Stream(dev)

        def symbols_aside(blob):
            with torch.cuda.stream(side):
                decoded = rt._decode_symbols(blob)
                ready = torch.cuda.Event()
                ready.record()
            return decoded, ready

        def many_threaded():
            out, pending = [], None
            current = rt._decode_symbols(blobs[0])
            with ThreadPoolExecutor(max_workers=1) as pool:
                for i in range(len(blobs)):
                    hdr, y_sym, means, (ph, pw) = current
                    steps = hdr.steps or cfg.sample.steps
                    fetch = rt._fetch_later(rt._serving_decode(
                        hdr, steps, y_sym, means, 1.0,
                        rt._header_gamma(hdr, steps), ph, pw, noise=noise[i]))
                    fut = (pool.submit(symbols_aside, blobs[i + 1])
                           if i + 1 < len(blobs) else None)
                    if pending is not None:
                        out.append(pending())
                    pending = (lambda fetch=fetch, hdr=hdr:
                               fetch()[0][0][:hdr.height, :hdr.width])
                    if fut is not None:
                        current, ready = fut.result()
                        # The main stream takes the tensors over.
                        main = torch.cuda.current_stream(dev)
                        main.wait_event(ready)
                        current[1].record_stream(main)
                        current[2].record_stream(main)
            out.append(pending())
            return out

        variants = {
            "symbols_only": lambda: [rt._decode_symbols(b) for b in blobs],
            "one_by_one": lambda: [rt.decompress(b, noise=e)
                                   for b, e in zip(blobs, noise)],
            "many": lambda: rt.decompress_many(blobs, noise=noise),
            "many_threaded": many_threaded}
        want = variants["one_by_one"]()
        for which in ("many", "many_threaded"):
            got = variants[which]()
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"{name}: {which} differs from one_by_one")
        runs = {k: [] for k in variants}
        for rnd in range(args.rounds):
            order = list(variants)[::-1 if rnd % 2 else 1]
            for k in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                variants[k]()
                torch.cuda.synchronize()
                runs[k].append(1e3 * (time.perf_counter() - t0))
        report = {"model": name, "card": card, "images": len(imgs),
                  "median_ms": {k: statistics.median(v[1:])
                                for k, v in runs.items()},
                  "runs_ms": runs}
        reports.append(report)
        print(json.dumps(report), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_torch_batch.json").write_text(json.dumps(reports, indent=1))


if __name__ == "__main__":
    main()
