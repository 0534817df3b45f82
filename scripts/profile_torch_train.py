#!/usr/bin/env python3
"""Where the time of one tpucdc_torch training step goes, on one card.

The flagship recipe (``scripts/r4d_queue.sh``: the served flagship's model
with the t-low bias 0.35/0.5; λ 128, distortion "both", LPIPS 15, batch 16,
crop 192) from a fresh initialisation under BF16_POLICY, on ``kodak()``
crops, as ``pipelines.train.fit`` runs it. Reports, per step:

- the host wall time without the profiler (median over ``--steps`` steps
  after 3 warm-ups, a synchronize after each);
- the same steps split by stage, with a synchronize after every stage (so a
  stage's time is the longer of its host work and its device work): the
  batch upload and uint8 conversion, the forward and loss (model, LPIPS,
  aux), the backward, the optimizer update, the EMA update;
- from ``torch.profiler`` over ``--traced`` steps: the device's busy time
  and busy share of the wall time above, kernel launches, device time by
  group (the port's GN+SiLU and attention kernels, convolutions and matrix
  products, everything else) and the busiest kernels;
- the LPIPS term alone (forward and backward on a batch-16 pair of 192×192
  crops): host ms with a synchronize, and device ms from the profiler;
- peak device memory of a step.

Prints one JSON line and writes it to chiprun_out/profile_torch_train.json.
Needs a CUDA device; imports nothing of JAX or tpucdc.

Usage: python3 scripts/profile_torch_train.py [--steps 8] [--traced 4]
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECIPE = {"model.t_low_frac": "0.35", "model.t_low_prob": "0.5",
          "train.rd_lambda": "128", "train.batch_size": "16",
          "train.crop_size": "192", "train.distortion": "both",
          "train.lpips_weight": "15"}
PORT_KERNELS = {"gn_silu_kernel": "gn_silu",
                "attention_mma_kernel": "attention",
                "attention_fma_kernel": "attention"}
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


def _kernels(prof, torch):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and float(e.self_device_time_total) > 0]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--traced", type=int, default=4)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tpucdc_torch import api
    from tpucdc_torch.data import kodak, train_crop_iterator
    from tpucdc_torch.eval.lpips import PerceptualMetric
    from tpucdc_torch.pipelines import train
    from tpucdc_torch.presets import SERVING_OVERRIDES
    from tpucdc_torch.runtime import pin_numerics, prng

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    pin_numerics()              # as fit does
    cfg = api.build_config("flagship", {**SERVING_OVERRIDES, **RECIPE})
    tc = cfg.train
    _, state = train.create_state(cfg, seed=0, device=dev)
    tables = train.schedule_tables(cfg, dev)
    step_fn = train.make_train_step(cfg, tables)
    data = train_crop_iterator(kodak().images, tc.batch_size, tc.crop_size,
                               as_uint8=True)
    lpips = PerceptualMetric(device=dev)

    def gen():
        return prng.generator(tc.seed + 1, state.step, device=dev)

    def step():
        batch = torch.from_numpy(next(data)).to(dev)
        step_fn(state, batch, gen())

    def split_step() -> dict:
        """One step, stage by stage, a synchronize after each."""
        times = {}
        t = time.perf_counter()

        def mark(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            times[name] = 1e3 * (now - t)
            t = now
        batch = torch.from_numpy(next(data)).to(dev)
        batch = batch.to(torch.float32) * (1.0 / 127.5) - 1.0
        mark("upload")
        state.opt.zero_grad()
        loss, _ = train.loss_fn(
            state.model, batch, tables, tc.rd_lambda,
            distortion=tc.distortion, rd_lambdas=tc.rd_lambdas,
            diff_weight=tc.diff_weight, lpips_weight=tc.lpips_weight,
            lpips_fn=lpips.distance, generator=gen())
        mark("forward")
        loss.backward()
        mark("backward")
        train.global_norm(p.grad for p in state.model.parameters()
                          if p.grad is not None)
        state.opt.step()
        mark("optimizer")
        train.ema_update(state, tc.ema_decay)
        state.step += 1
        mark("ema")
        return times

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_ms = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated(dev)
    splits = [split_step() for _ in range(args.steps)]
    split_ms = {k: statistics.median(s[k] for s in splits) for k in splits[0]}

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.traced):
            step()
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0) / args.traced
    kernels = _kernels(prof, torch)
    groups = collections.defaultdict(float)
    launches = 0
    for e in kernels:
        groups[_group(e.key)] += float(e.self_device_time_total) / 1e3 \
            / args.traced
        launches += e.count
    busy_ms = sum(groups.values())
    top = sorted(kernels, key=lambda e: float(e.self_device_time_total),
                 reverse=True)[:12]

    # The LPIPS term alone: forward and backward on a batch-16 pair.
    a = torch.rand((tc.batch_size, tc.crop_size, tc.crop_size, 3),
                   device=dev) * 2 - 1
    b = torch.rand_like(a) * 2 - 1
    a.requires_grad_(True)

    def lpips_step():
        torch.autograd.grad(lpips.distance(a, b), a)
    for _ in range(3):
        lpips_step()
    torch.cuda.synchronize()
    lp_walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        lpips_step()
        torch.cuda.synchronize()
        lp_walls.append(1e3 * (time.perf_counter() - t0))
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as lprof:
        for _ in range(args.traced):
            lpips_step()
        torch.cuda.synchronize()
    lp_dev = sum(float(e.self_device_time_total)
                 for e in _kernels(lprof, torch)) / 1e3 / args.traced
    # The proxy's FLOPs a step: five 3×3 convolutions per image and side,
    # forward and backward (≈ 3× the forward).
    flops, cin = 0, 3
    for i, cout in enumerate((64, 128, 256, 512, 512)):
        flops += 2 * 9 * cin * cout * (tc.crop_size >> i) ** 2
        cin = cout
    flops *= 2 * tc.batch_size * 3

    report = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "batch": tc.batch_size, "crop": tc.crop_size,
        "steps": args.steps, "traced": args.traced,
        "wall_ms": wall_ms, "walls_ms": walls,
        "steps_per_sec": 1e3 / wall_ms,
        "split_ms": split_ms, "traced_wall_ms": traced_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": launches / args.traced,
        "device_ms_by_group": dict(groups),
        "top_kernels": [{"name": e.key[:90], "ms_per_step":
                         float(e.self_device_time_total) / 1e3 / args.traced,
                         "launches_per_step": e.count / args.traced}
                        for e in top],
        "lpips_fwd_bwd_wall_ms": statistics.median(lp_walls),
        "lpips_fwd_bwd_device_ms": lp_dev,
        "lpips_fwd_bwd_bound_ms": 1e3 * flops / 67e12,
        "peak_bytes": peak,
    }
    print(f"[train] step {wall_ms:.1f} ms ({report['steps_per_sec']:.2f} "
          f"steps/s), device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), {launches / args.traced:.0f} "
          f"launches a step; split (ms, synchronized): " + ", ".join(
              f"{k} {v:.1f}" for k, v in split_ms.items()), flush=True)
    print("[train] device ms a step by group: " + ", ".join(
        f"{k} {v:.3f}" for k, v in groups.items()) + f"; LPIPS fwd+bwd "
        f"{report['lpips_fwd_bwd_wall_ms']:.2f} ms host, {lp_dev:.2f} ms "
        f"device (f32 bound {report['lpips_fwd_bwd_bound_ms']:.2f} ms); "
        f"peak {peak / 2 ** 30:.2f} GiB", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_torch_train.json").write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
