#!/usr/bin/env python3
"""Where the time of tpucdc_torch's served 768×512 flagship decode goes, on one card.

Traces ``CodecRuntime.decompress`` of ``tpucdc_torch/fixtures/flagship_768x512.tpucdc``
with ``torch.profiler`` (CPU and CUDA activities) under BF16_POLICY (the
serving policy) and F32_POLICY, and reports per decode:

- the host wall time without the profiler (median of 5 after 2 warm-ups),
  the summed device time of all CUDA kernels in the traced decodes, and the
  device's busy and idle shares of that wall time (kernels run on one
  stream, so their sum is the busy time);
- the number of kernel launches;
- device time by group: the port's GN+SiLU kernels, its attention kernel,
  convolutions and matrix products, and everything else;
- the busiest kernels by name, and each port kernel's device time per launch.

Prints one JSON line and writes the same to chiprun_out/profile_torch_decode.json.
Needs a CUDA device; imports nothing of JAX or tpucdc.

Usage: python3 scripts/profile_torch_decode.py [--decodes 3]
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOB = ROOT / "tpucdc_torch" / "fixtures" / "flagship_768x512.tpucdc"
WEIGHTS = ROOT / "artifacts" / "flagship_params.npz"
PORT_KERNELS = {"gn_stats_kernel": "gn_silu", "gn_apply_kernel": "gn_silu",
                "attention_kernel": "attention"}
MATMUL_HINTS = ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad", "sm90_",
                "implicit", "winograd", "fft", "cudnn")


def _group(name: str) -> str:
    for kernel, group in PORT_KERNELS.items():
        if kernel in name:
            return group
    low = name.lower()
    if any(h in low for h in MATMUL_HINTS):
        return "conv_matmul"
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(runtime, blob: bytes, decodes: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    walls = []
    for _ in range(2 + 5):
        t0 = time.perf_counter()
        runtime.decompress(blob)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    # The profiler slows the host; shares are taken against the wall time of
    # the decodes before it (median of 5 after 2 warm-ups).
    wall_ms = statistics.median(walls[2:])
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(decodes):
            runtime.decompress(blob)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0) / decodes
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    groups = collections.defaultdict(float)
    launches = 0
    for e in kernels:
        groups[_group(e.key)] += _device_us(e) / 1e3 / decodes
        launches += e.count
    busy_ms = sum(groups.values())
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    per_launch = {}
    for e in kernels:
        for kernel in PORT_KERNELS:
            if kernel in e.key:
                per_launch[kernel] = {"us_per_launch": _device_us(e) / e.count,
                                      "launches_per_decode": e.count / decodes}
    return {
        "wall_ms": wall_ms,
        "traced_wall_ms": traced_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_decode": launches / decodes,
        "device_ms_by_group": dict(groups),
        "port_kernels": per_launch,
        "top_kernels": [{"name": e.key[:90], "ms_per_decode":
                         _device_us(e) / 1e3 / decodes,
                         "launches_per_decode": e.count / decodes}
                        for e in top],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--decodes", type=int, default=3)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_decode: no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    import tpucdc_torch as port

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    cfg = port.flagship_serving()
    model = port.CDCModel(cfg.model)
    state, _ = port.load_params_npz(WEIGHTS)
    model.load_state_dict(state, strict=True)
    blob = BLOB.read_bytes()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "decodes": args.decodes}
    for name, policy in (("bf16", port.BF16_POLICY), ("f32", port.F32_POLICY)):
        runtime = port.CodecRuntime(cfg, copy.deepcopy(model), device="cuda",
                                    policy=policy)
        report[name] = profile(runtime, blob, args.decodes)
        r = report[name]
        print(f"[{name}] wall {r['wall_ms']:.2f} ms/decode, device busy "
              f"{r['device_busy_ms']:.2f} ms ({100 * r['device_busy_share']:.1f} "
              f"%), {r['kernel_launches_per_decode']:.0f} kernel launches; "
              f"by group (ms): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in r["device_ms_by_group"].items()),
              flush=True)
        for kernel, row in r["port_kernels"].items():
            print(f"[{name}] {kernel}: {row['us_per_launch']:.2f} us/launch, "
                  f"{row['launches_per_decode']:.0f} launches/decode")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_torch_decode.json").write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
