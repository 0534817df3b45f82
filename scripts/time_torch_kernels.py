#!/usr/bin/env python3
"""Device time of tpucdc_torch's two CUDA kernels at every shape of the served
768×512 flagship decode, and at the shapes of the other decode paths (batch 2
for guidance, 6 and 48 tiles of 320×320, the large ``flagship()`` preset's head
widths 48 and 64), for one checkout or for two side by side.

For each ``--root`` (a checkout that holds ``tpucdc_torch/``; default: this
one) a child process builds that checkout's kernels and, per shape, reads the
summed device time of the port's kernels per call from ``torch.profiler``
(20 calls after 3 warm-ups; bf16, contiguous inputs, which every version of
the wrappers takes). Roots are taken in the order given, so
``--root parent --root . --root . --root parent`` compares two versions on
one card in turns. The shapes of the other paths carry 0 calls per served
decode; each has beside it the device time of one PyTorch call that computes
the same function (``scaled_dot_product_attention``; ``F.group_norm`` +
``F.silu`` on the NCHW copy) and its bound on an H100 (the larger of bytes
over 3.35 TB/s and operations over 989 TFLOP/s in bf16 for attention, 67
TFLOP/s in f32 for GN+SiLU). Prints one JSON line per root and writes all of
them to chiprun_out/time_torch_kernels.json. Needs a CUDA device; imports
nothing of JAX or tpucdc.

Usage: python3 scripts/time_torch_kernels.py [--root DIR ...]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (shape [B, H, W, C], groups, calls per decode) under BF16_POLICY.
GN_SHAPES = [((1, 32, 48, 96), 32, 1), ((1, 64, 96, 48), 24, 1),
             ((1, 128, 192, 32), 32, 1), ((1, 128, 192, 32), 16, 15),
             ((1, 64, 96, 32), 16, 5), ((1, 64, 96, 64), 16, 5),
             ((1, 32, 48, 64), 16, 5), ((1, 32, 48, 96), 16, 15),
             ((1, 32, 48, 192), 16, 10), ((1, 32, 48, 160), 16, 5),
             ((1, 64, 96, 160), 16, 5), ((1, 64, 96, 128), 16, 5),
             ((1, 64, 96, 96), 16, 5), ((1, 128, 192, 96), 16, 5),
             ((1, 128, 192, 64), 16, 10)]
ATTN_SHAPES = [((1, 4, 1536, 24), (1, 4, 1536, 24), 60)]
# The other decode paths (0 calls in the served decode): guidance, tiles, and
# the large preset's two attention levels (self, then cross on 1536 tokens).
MODE_GN_SHAPES = [((2, 128, 192, 32), 16), ((6, 80, 80, 32), 16),
                  ((48, 80, 80, 32), 16), ((48, 20, 20, 96), 16),
                  ((1, 128, 192, 64), 32), ((1, 32, 48, 192), 32),
                  ((1, 16, 24, 256), 32), ((1, 16, 24, 512), 32)]
MODE_ATTN_SHAPES = [((2, 4, 1536, 24), (2, 4, 1536, 24)),
                    ((6, 4, 400, 24), (6, 4, 400, 24)),
                    ((48, 4, 400, 24), (48, 4, 400, 24)),
                    ((1, 4, 1536, 48), (1, 4, 1536, 48)),
                    ((2, 4, 1536, 48), (2, 4, 1536, 48)),
                    ((1, 4, 384, 64), (1, 4, 384, 64)),
                    ((1, 4, 384, 64), (1, 4, 1536, 64))]
HBM_BYTES_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
PORT_KERNELS = ("gn_stats_kernel", "gn_apply_kernel", "gn_silu_kernel",
                "attention_kernel", "attention_mma_kernel",
                "attention_fma_kernel")


def measure(root: pathlib.Path) -> dict:
    """Runs in the child: time the kernels of the checkout at ``root``."""
    import importlib

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: no CUDA device is available")
    sys.path.insert(0, str(root))
    groupnorm = importlib.import_module("tpucdc_torch.ops.groupnorm")
    attn = importlib.import_module("tpucdc_torch.ops.attention")
    importlib.import_module("tpucdc_torch.ops._kernels").build(force=True)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def device_us(fn, iters=20, names=PORT_KERNELS):
        """(device µs, kernels) per call of ``fn``: of the port's kernels, or
        with ``names=None`` of every kernel the call launches."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (names is None or any(name in e.key for name in names))]
        if not rows:
            raise RuntimeError("the profiler saw no kernel of the port")
        return (sum(float(e.self_device_time_total) for e in rows) / iters,
                sum(e.count for e in rows) / iters)

    import torch.nn.functional as F
    out = {"root": str(root), "gn_silu": [], "attention": []}
    for shape, groups, *calls in GN_SHAPES + MODE_GN_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        c = shape[-1]
        g = torch.randn(c, generator=gen, device=dev)
        b = torch.randn(c, generator=gen, device=dev)
        us, launches = device_us(
            lambda: groupnorm.gn_silu_cuda(x, g, b, groups))
        row = {"shape": list(shape), "groups": groups,
               "calls": calls[0] if calls else 0, "device_us": us,
               "launches_per_call": launches}
        if not calls:
            x_nchw = x.reshape(shape[0], -1, c).transpose(1, 2).contiguous()
            gb, bb = g.to(x.dtype), b.to(x.dtype)
            row["library_device_us"] = device_us(lambda: F.silu(F.group_norm(
                x_nchw, groups, gb, bb, 1e-5)), names=None)[0]
            row["bound_us"] = 1e6 * max(
                (2 * x.numel() * 2 + 2 * c * 4) / HBM_BYTES_S,
                10 * x.numel() / F32_FLOPS)
        out["gn_silu"].append(row)
    for qs, ks, *calls in ATTN_SHAPES + MODE_ATTN_SHAPES:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                   for s in (qs, ks, ks))
        us, launches = device_us(
            lambda: attn.attention_cuda(q, k, v, qs[-1] ** -0.5))
        row = {"q": list(qs), "k": list(ks),
               "calls": calls[0] if calls else 0, "device_us": us,
               "launches_per_call": launches}
        if not calls:
            row["library_device_us"] = device_us(
                lambda: F.scaled_dot_product_attention(q, k, v),
                names=None)[0]
            row["bound_us"] = 1e6 * max(
                2 * (2 * q.numel() + 2 * k.numel()) / HBM_BYTES_S,
                4 * qs[0] * qs[1] * qs[2] * ks[2] * qs[3] / BF16_FLOPS)
        out["attention"].append(row)
    for name in ("gn_silu", "attention"):
        out[f"{name}_device_ms_per_decode"] = sum(
            r["calls"] * r["device_us"] for r in out[name]) / 1e3
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return out


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
    (out / "time_torch_kernels.json").write_text(json.dumps(reports, indent=1))


if __name__ == "__main__":
    main()
