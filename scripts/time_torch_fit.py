#!/usr/bin/env python3
"""Steps a second of tpucdc_torch's training loop at the flagship recipe,
for one checkout or for several in turns.

The recipe is ``chip_smoke.py``'s (``scripts/r4d_queue.sh``: the served
flagship's model with the t-low bias 0.35/0.5; λ 128, distortion "both",
LPIPS 15, batch 16, crop 192, K = 16), from a fresh initialisation under
BF16_POLICY on ``kodak()`` crops. For each ``--root`` (a checkout that holds
``tpucdc_torch/``; default: this one), in the order given, a child process
runs ``pipelines.train.fit`` for ``--chunks`` K-step chunks and reads the
steps a second ``fit`` logs after each chunk; the first chunk (warm-up) is
left out of the median. Give ``--root a --root . --root . --root a`` to
compare two versions on one card. Prints one JSON line per root and writes
them to chiprun_out/time_torch_fit.json. Needs a CUDA device; imports
nothing of JAX or tpucdc.

Usage: python3 scripts/time_torch_fit.py [--chunks 6] [--root DIR ...]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def measure(root: pathlib.Path, chunks: int) -> dict:
    """Runs in the child: time ``fit`` of the checkout at ``root``."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_fit: no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import RECIPE
    sys.path[0] = str(root)
    from tpucdc_torch import api
    from tpucdc_torch.data import kodak, train_crop_iterator
    from tpucdc_torch.pipelines import train
    from tpucdc_torch.presets import SERVING_OVERRIDES

    cfg = api.build_config("flagship", {**SERVING_OVERRIDES, **RECIPE,
                                        "train.log_every": "1"})
    tc = cfg.train
    rows = []
    data = train_crop_iterator(kodak().images, tc.batch_size, tc.crop_size,
                               as_uint8=True)
    train.fit(cfg, data, writer=lambda step, m: rows.append(m),
              num_steps=chunks * tc.steps_per_dispatch, device="cuda")
    sps = [m["steps_per_sec"] for m in rows[1:]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"root": str(root), "card": card, "package": train.__file__,
            "steps_per_sec_median": statistics.median(sps),
            "steps_per_sec": sps}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", type=pathlib.Path,
                        help="checkout to time (repeatable; default: this one)")
    parser.add_argument("--chunks", type=int, default=6)
    parser.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        print(json.dumps(measure(args.child.resolve(), args.chunks)))
        return
    reports = []
    for root in args.root or [ROOT]:
        # One process per root: two versions of one package cannot share one.
        done = subprocess.run([sys.executable, __file__, "--child", str(root),
                               "--chunks", str(args.chunks)],
                              capture_output=True, text=True)
        if done.returncode:
            raise SystemExit(f"timing {root} failed:\n{done.stdout}{done.stderr}")
        line = done.stdout.strip().splitlines()[-1]
        reports.append(json.loads(line))
        print(line, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_torch_fit.json").write_text(json.dumps(reports, indent=1))


if __name__ == "__main__":
    main()
