#!/usr/bin/env python3
"""Wall time of tpucdc_torch's served 768×512 flagship decode, as a
distribution, for one checkout or for two in turns.

The decode is host-bound and the host's clock is noisy, so one median says
little. For each ``--root`` (a checkout that holds ``tpucdc_torch/`` and
``artifacts/flagship_params.npz``; default: this one), in the order given, a
child process times 40 decodes after 5 warm-ups under BF16_POLICY, each ended
by ``torch.cuda.synchronize()``: the full ``CodecRuntime.decompress`` of
``tpucdc_torch/fixtures/flagship_768x512.tpucdc`` (of this checkout) and the
device stage alone, and prints min, quartiles and median. Give
``--root parent --root . --root parent --root .`` to compare two versions on
one card. Needs a CUDA device; imports nothing of JAX or tpucdc.

Usage: python3 scripts/wall_torch_decode.py [--root DIR ...]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOB = ROOT / "tpucdc_torch" / "fixtures" / "flagship_768x512.tpucdc"
WARMUPS, RUNS = 5, 40


def measure(root: pathlib.Path) -> dict:
    """Runs in the child: time the decode of the checkout at ``root``."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("wall_torch_decode: no CUDA device is available")
    sys.path.insert(0, str(root))
    import tpucdc_torch as port

    cfg = port.flagship_serving()
    model = port.CDCModel(cfg.model)
    state, _ = port.load_params_npz(root / "artifacts" / "flagship_params.npz")
    model.load_state_dict(state, strict=True)
    blob = BLOB.read_bytes()
    rt = port.CodecRuntime(cfg, model, device="cuda", policy=port.BF16_POLICY)
    hdr, z_sym, y_bytes, (ph, pw) = rt._host_z_stage(blob)
    means, idx = rt._hyper_stage(z_sym)
    y = torch.from_numpy(rt.y_codec.decode(y_bytes, idx)).to("cuda")

    def summary(fn) -> dict:
        times = []
        for _ in range(WARMUPS + RUNS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        q1, median, q3 = statistics.quantiles(times[WARMUPS:], n=4)
        return {"min_ms": min(times[WARMUPS:]), "q1_ms": q1,
                "median_ms": median, "q3_ms": q3}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"root": str(root), "card": card,
            "decompress": summary(lambda: rt.decompress(blob)),
            "device_stage": summary(lambda: rt._device_stage(
                y, means, hdr.steps, 0.0, cfg.sample.blend_gamma, ph, pw))}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", type=pathlib.Path,
                        help="checkout to time (repeatable; default: this one)")
    parser.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        print(json.dumps(measure(args.child.resolve())))
        return
    reports = []
    for root in args.root or [ROOT]:
        # One process per root: two versions of one package cannot share one.
        done = subprocess.run([sys.executable, __file__, "--child", str(root)],
                              capture_output=True, text=True)
        if done.returncode:
            raise SystemExit(f"timing {root} failed:\n{done.stdout}{done.stderr}")
        line = done.stdout.strip().splitlines()[-1]
        reports.append(json.loads(line))
        print(line, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "wall_torch_decode.json").write_text(json.dumps(reports, indent=1))


if __name__ == "__main__":
    main()
