#!/usr/bin/env python3
"""Drive the PyTorch port's served flagship decode on one CUDA card and check it.

Runs the port (tpucdc_torch) only; imports nothing of JAX or tpucdc. Phases,
in order; any failure raises, exits non-zero and prints no result line:

  1. device   — a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build    — builds the CUDA kernels (nvcc, sm_90a) and the rANS host
                coder from the sources in the checkout; prints seconds and
                ptxas' register/spill lines.
  3. kernels  — every kernel against its plain PyTorch version on the card,
                at every shape the 768×512 serving decode gives it (found by
                one decode first; attention on the strided head views the
                attention block hands it, and on contiguous copies), in bf16
                and f32, plus adversarial shapes: GN with C·itemsize off 16
                bytes, batch 3, one row, an unaligned pointer, |mean| ≫ σ;
                attention with one query, one key, 65 keys, d in
                {8, 24, 40, 64, 128}, strides off 16 bytes, scores × 50.
                Tolerances: f32 atol 1e-5 (attention 2e-5), GN+SiLU bf16
                5e-2, as the JAX package's Pallas parity tests; attention
                bf16 2e-2·max|reference|, since its outputs are too small
                for a fixed 5e-2 to fail a kernel that skipped a key tile.
  4. parity   — the JAX-made fixture tpucdc_torch/fixtures/flagship_384x512
                under F32_POLICY with TF32 off: the runtime's coder tables
                equal the JAX export stored in it; exact z/index/y symbols, mean
                decode within 1 LSB of JAX's, served decode (fed JAX's ε)
                max |diff| <= 2 with >= 99.9 % within 1; the BF16_POLICY
                device stage from the f32 ŷ, μ at PSNR >= 35 dB against JAX's
                f32 output; the bf16 hyper stage's index flips (a finding).
  5. timing   — 768×512 (fixtures/flagship_768x512.tpucdc): the full
                decompress under F32_POLICY, the device stage under
                BF16_POLICY, a stage split, and each kernel's time, device
                time, bound, plain time and library time at every shape of
                the main path.
  6. main path — the launch counts of one serving decode
                (``CodecRuntime.decompress`` under BF16_POLICY, the JAX
                package's serving policy), counts reset just before: 93
                GN+SiLU launches and 60 attention launches, no more.

The last three lines are the card's name and power limit, the ``kernels``
JSON line, and ``{"ok": true, "device": {...}}``. Details also go to
chiprun_out/chip_smoke.json.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import copy
import importlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
FIXTURES = ROOT / "tpucdc_torch" / "fixtures"
WEIGHTS = ROOT / "artifacts" / "flagship_params.npz"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and FLOP/s for the
# type each kernel computes in (bf16 on tensor cores, f32 on CUDA cores).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
TOL = {"gn_silu": {"f32": 1e-5, "bf16": 5e-2},
       "attention": {"f32": 2e-5}}
ATTN_BF16_REL = 2e-2   # attention bf16 bound, times max|reference|
REPLACES = {"gn_silu": "tpucdc/ops/pallas/gn_silu.py:82",
            "attention": "tpucdc/ops/pallas/flash_attention.py:45"}
SOURCES = {"gn_silu": "tpucdc_torch/csrc/gn_silu.cu",
           "attention": "tpucdc_torch/csrc/attention.cu"}
REPORT: dict = {}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    import tpucdc_torch as port
    from tpucdc_torch.entropy import _build as rans_build
    from tpucdc_torch.ops import _kernels
    # The wrapper modules (the package namespace re-exports their functions).
    attn_mod = importlib.import_module("tpucdc_torch.ops.attention")
    groupnorm = importlib.import_module("tpucdc_torch.ops.groupnorm")
    from tpucdc_torch.runtime import set_policy

    dev = torch.device("cuda")
    card = card_line()
    say("device", f"{card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    REPORT["card"] = card

    # ---- 2. build ----
    t0 = time.perf_counter()
    _kernels.build(force=True)
    check(rans_build.build_library(force=True) is not None,
          "rANS coder build failed")
    build_s = time.perf_counter() - t0
    say("build", f"kernels + rANS coder built in {build_s:.1f} s")
    for line in _kernels.PTXAS_LOG.read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say("build", line.strip())
    REPORT["build_s"] = build_s
    # The bf16 attention kernel must hold tensor-core instructions.
    cuobjdump = pathlib.Path(_kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_kernels.BUILD_DIR / "attention.o")],
        capture_output=True, text=True, check=True).stdout
    hmma = sum("HMMA" in line for line in sass.splitlines())
    say("build", f"attention.o: {hmma} HMMA (tensor-core) instructions")
    check(hmma > 0, "no HMMA instruction in the attention kernel")
    REPORT["attention_hmma_instructions"] = hmma

    # ---- model and runtimes ----
    cfg = port.flagship_serving()
    model = port.CDCModel(cfg.model)
    state, unused = port.load_params_npz(WEIGHTS)
    model.load_state_dict(state, strict=True)
    fx = dict(np.load(FIXTURES / "flagship_384x512.npz"))
    rt32 = port.CodecRuntime(cfg, copy.deepcopy(model), device=dev,
                             policy=port.F32_POLICY)
    rt16 = port.CodecRuntime(cfg, copy.deepcopy(model), device=dev,
                             policy=port.BF16_POLICY)
    table_gap = {p: sum(int(np.sum(getattr(codec, k) != fx[f"{p}_{k}"]))
                        for k in ("cdfs", "cdf_lengths", "offsets"))
                 for p, codec in (("z", rt32.z_codec), ("y", rt32.y_codec))}
    say("parity", f"coder tables built by the port vs JAX's export: "
        f"differing entries {table_gap}")
    check(not any(table_gap.values()), f"coder tables differ {table_gap}")
    blob768 = (FIXTURES / "flagship_768x512.tpucdc").read_bytes()

    # Shape discovery: the shapes the main path gives each kernel.
    seen = {"gn_silu": collections.Counter(),
            "attention": collections.Counter()}
    orig_gn, orig_attn = groupnorm.gn_silu_cuda, attn_mod.attention_cuda

    def rec_gn(x, gamma, beta, num_groups, eps=1e-5):
        seen["gn_silu"][(tuple(x.shape), num_groups)] += 1
        return orig_gn(x, gamma, beta, num_groups, eps)

    def rec_attn(q, k, v, scale):
        # The layout too: the attention block passes head views of its
        # [B, N, H·d] projections, not contiguous [B, H, N, d] tensors.
        views = not (q.is_contiguous() or k.is_contiguous()
                     or v.is_contiguous())
        seen["attention"][(tuple(q.shape), tuple(k.shape), views)] += 1
        return orig_attn(q, k, v, scale)

    groupnorm.gn_silu_cuda, attn_mod.attention_cuda = rec_gn, rec_attn
    try:
        rt16.decompress(blob768)
    finally:
        groupnorm.gn_silu_cuda, attn_mod.attention_cuda = orig_gn, orig_attn
    say("kernels", f"main-path shapes: {len(seen['gn_silu'])} GN+SiLU, "
        f"{len(seen['attention'])} attention")

    # ---- 3. kernels vs plain ----
    gen = torch.Generator(dev).manual_seed(0)

    def gn_inputs(shape, groups, dtype):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        c = shape[-1]
        return (x, torch.randn(c, generator=gen, device=dev),
                torch.randn(c, generator=gen, device=dev), groups)

    def attn_inputs(qs, ks, dtype, views=False):
        """q, k, v; with ``views`` as the attention block makes them: the
        [B, H, N, d] views of [B, N, H·d] projections."""
        if not views:
            return tuple(torch.randn(s, generator=gen, device=dev).to(dtype)
                         for s in (qs, ks, ks))
        return tuple(
            torch.randn((b, n, h * d), generator=gen, device=dev).to(dtype)
            .reshape(b, n, h, d).transpose(1, 2)
            for (b, h, n, d) in (qs, ks, ks))

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    errs = {"gn_silu": 0.0, "attention": 0.0}
    # Adversarial: C·itemsize off 16 bytes (the scalar path), batch 3, one
    # row, more images than resident blocks, the widest C (channel passes).
    gn_cases = list(seen["gn_silu"]) + [
        ((3, 7, 5, 16), 4), ((2, 9, 5, 20), 4), ((3, 16, 24, 64), 16),
        ((1, 1, 1, 32), 16), ((2, 1, 1, 20), 4), ((600, 2, 2, 16), 4),
        ((1, 3, 5, 3072), 32), ((1, 6, 5, 32), 16, "unaligned")]
    for (shape, groups, *how) in gn_cases:
        for dn, dt in dtypes.items():
            x, g, b, G = gn_inputs(shape, groups, dt)
            if how:   # the same slab one element into its buffer
                x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(shape)
                check(x.data_ptr() % 16 != 0, "slab is not unaligned")
            got = groupnorm.gn_silu_cuda(x, g, b, G)
            want = groupnorm.gn_reference(x, g, b, G, 1e-5, fuse_silu=True)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            bound = TOL["gn_silu"][dn]
            say("kernels", f"gn_silu {shape}/{groups} {dn}: max|err| "
                f"{err:.3g} (bound {bound:g})")
            check(err <= bound, f"gn_silu {shape}/{groups} {dn} err {err}")
            if dn == "bf16" and (shape, groups) in seen["gn_silu"]:
                errs["gn_silu"] = max(errs["gn_silu"], err)
    # |mean| ≫ σ (f32): E[x²] − mean² would lose the variance. Against the
    # plain version in f64; the normalised output to 1e-3.
    for shape, groups in (((1, 64, 96, 64), 16), ((2, 9, 5, 20), 4)):
        x = 1000.0 + torch.randn(shape, generator=gen, device=dev)
        one, zero = x.new_ones(shape[-1]), x.new_zeros(shape[-1])
        got = groupnorm.gn_silu_cuda(x, one, zero, groups)
        want = groupnorm.gn_reference(x.double(), one.double(), zero.double(),
                                      groups, 1e-5, fuse_silu=True)
        err = (got.double() - want).abs().max().item()
        say("kernels", f"gn_silu {shape}/{groups} f32 mean 1000, sigma 1: "
            f"max|err| {err:.3g} (bound 0.001)")
        check(err <= 1e-3, f"gn_silu large-mean {shape} err {err}")

    def attn_case(qs, ks, dn, views=False, qkv=None, score_x=1.0, note=""):
        q, k, v = qkv or attn_inputs(qs, ks, dtypes[dn], views)
        scale = score_x * qs[-1] ** -0.5
        got = attn_mod.attention_cuda(q, k, v, scale)
        want = attn_mod.attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), "attention not finite")
        check(got.transpose(1, 2).is_contiguous(),
              "attention output is not stored as [B, N, H, d]")
        err = (got.float() - want.float()).abs().max().item()
        ref_max = want.float().abs().max().item()
        # f32 scores × 50 carry 50 × their rounding into the exponent.
        bound = (ATTN_BF16_REL * ref_max if dn == "bf16"
                 else TOL["attention"][dn] * score_x)
        tag = ("views " if views else "") + note
        say("kernels", f"attention q{qs} k{ks} {dn} {tag}: max|err| "
            f"{err:.3g} (bound {bound:.3g}; max|ref| {ref_max:.3g})")
        check(err <= bound, f"attention {qs} {ks} {dn} {tag} err {err}")
        return err

    for dn in dtypes:
        for (qs, ks, views) in seen["attention"]:
            for lay in sorted({views, False}):
                err = attn_case(qs, ks, dn, views=lay)
                if dn == "bf16":
                    errs["attention"] = max(errs["attention"], err)
        # Ragged, one query, one key, 65 keys, every padded head width.
        for b, h, nq, nk, d in ((1, 4, 100, 77, 24), (1, 2, 1, 300, 24),
                                (1, 2, 50, 1, 24), (2, 3, 40, 65, 24),
                                (1, 2, 70, 130, 8), (1, 2, 70, 130, 40),
                                (1, 2, 70, 130, 64), (2, 2, 70, 130, 128),
                                (1, 1, 5, 3, 7), (1, 1, 17, 1000, 16)):
            attn_case((b, h, nq, d), (b, h, nk, d), dn, views=d % 8 == 0)
        attn_case((1, 4, 200, 24), (1, 4, 200, 24), dn, views=True,
                  score_x=50.0, note="scores x50")
        # Head slices that start off a 16-byte boundary: narrower loads.
        wide = torch.randn((3, 1, 2, 90, 27), generator=gen,
                           device=dev).to(dtypes[dn])
        attn_case((1, 2, 90, 24), (1, 2, 90, 24), dn, note="pitch 27",
                  qkv=tuple(wide[i][..., 3:27] for i in range(3)))

    # ---- 4. fixture parity (F32_POLICY, TF32 off) ----
    blob = fx["blob"].tobytes()
    hdr, z_sym, y_bytes, (ph, pw) = rt32._host_z_stage(blob)
    means, idx = rt32._hyper_stage(z_sym)
    y_sym = rt32.y_codec.decode(y_bytes, idx)
    mism = {"z_sym": int(np.sum(z_sym != fx["z_sym"])),
            "indexes": int(np.sum(idx != fx["indexes"])),
            "y_sym": int(np.sum(y_sym != fx["y_sym"]))}
    say("parity", f"symbol mismatches vs JAX: {mism}")
    check(not any(mism.values()), f"symbol mismatch {mism}")
    mean_u8 = rt32.decompress(blob, steps=0)
    d_mean = np.abs(mean_u8.astype(int) - fx["mean_u8"].astype(int))
    say("parity", f"mean decode vs JAX: max|diff| {d_mean.max()} LSB "
        f"(bound 1)")
    check(d_mean.max() <= 1, "mean decode differs from JAX by > 1 LSB")
    eps = torch.from_numpy(fx["eps"]).to(dev)
    serve_u8 = rt32.decompress(blob, noise=eps)
    d_serve = np.abs(serve_u8.astype(int) - fx["serve_u8"].astype(int))
    within1 = float(np.mean(d_serve <= 1))
    say("parity", f"served decode vs JAX: max|diff| {d_serve.max()} LSB "
        f"(bound 2), {100 * within1:.4f} % within 1 (bound 99.9 %)")
    check(d_serve.max() <= 2 and within1 >= 0.999,
          "served decode differs from JAX")
    y_t = torch.from_numpy(y_sym).to(dev)
    u8_16 = rt16._device_stage(y_t, means, hdr.steps, 0.0, hdr.gamma_grid_f,
                               ph, pw, noise=eps)
    u8_16 = u8_16.cpu().numpy()[0][:hdr.height, :hdr.width]
    mse = np.mean((u8_16.astype(np.float64) - fx["serve_u8"]) ** 2)
    psnr16 = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    say("parity", f"BF16_POLICY device stage vs JAX f32 served decode: PSNR "
        f"{psnr16:.2f} dB (bound 35)")
    check(psnr16 >= 35.0, "bf16 device stage PSNR < 35 dB")
    set_policy(rt32.model.h_s, port.BF16_POLICY)
    _, idx16 = rt32._hyper_stage(z_sym)
    set_policy(rt32.model.h_s, port.F32_POLICY)
    flips = int(np.sum(idx16 != fx["indexes"]))
    say("parity", f"bf16 hyper stage: {flips} of {idx16.size} row indexes "
        f"differ from the f32 ones (finding, not a gate)")
    REPORT["parity"] = {"symbol_mismatch": mism, "table_gap": table_gap,
                        "mean_max_diff": int(d_mean.max()),
                        "serve_max_diff": int(d_serve.max()),
                        "serve_within1": within1, "bf16_psnr_db": psnr16,
                        "bf16_index_flips": flips,
                        "indexes": int(idx16.size)}

    # ---- 5. timing at 768×512 ----
    def host_median(fn, runs=7):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return statistics.median(times)

    full32 = host_median(lambda: rt32.decompress(blob768))
    hdr7, z7, yb7, (ph7, pw7) = rt16._host_z_stage(blob768)
    m7, i7 = rt16._hyper_stage(z7)
    y7 = torch.from_numpy(rt16.y_codec.decode(yb7, i7)).to(dev)
    gamma7 = cfg.sample.blend_gamma
    dev16 = host_median(lambda: rt16._device_stage(
        y7, m7, hdr7.steps, 0.0, gamma7, ph7, pw7))
    full16 = host_median(lambda: rt16.decompress(blob768))
    split = {}
    for name, rt in (("f32", rt32), ("bf16", rt16)):
        parts = collections.defaultdict(list)
        for _ in range(6):
            t = time.perf_counter()
            h, z, yb, (a, b) = rt._host_z_stage(blob768)
            t1 = time.perf_counter()
            m, i = rt._hyper_stage(z)
            t2 = time.perf_counter()
            ys = torch.from_numpy(rt.y_codec.decode(yb, i)).to(dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            rt._device_stage(ys, m, h.steps, 0.0, gamma7, a, b).cpu()
            t4 = time.perf_counter()
            for key, v in (("parse_z_rans", t1 - t), ("hyper_index", t2 - t1),
                           ("y_rans", t3 - t2), ("device", t4 - t3)):
                parts[key].append(1e3 * v)
        split[name] = {k: statistics.median(v[1:]) for k, v in parts.items()}
    say("timing", f"768x512 decompress F32_POLICY {full32:.2f} ms, "
        f"BF16_POLICY {full16:.2f} ms; device stage BF16 {dev16:.2f} ms "
        f"(median of 7 after 1 warm-up)")
    for name, s in split.items():
        say("timing", f"stage split {name} (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in s.items()))
    REPORT["timing_ms"] = {"decompress_f32": full32, "decompress_bf16": full16,
                           "device_stage_bf16": dev16, "split": split}

    def event_ms(fn, iters=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    def device_us(fn, kernel_names, iters=20):
        """Device time per call of fn (profiler): of the named kernels, or
        with ``None`` of every kernel the call launches."""
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(float(e.self_device_time_total)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and (kernel_names is None
                         or any(name in e.key for name in kernel_names)))
        check(total > 0, f"the profiler saw no {kernel_names} kernel")
        return total / iters

    per = {"gn_silu": collections.defaultdict(float),
           "attention": collections.defaultdict(float)}
    shape_rows = []
    for (shape, groups), n in seen["gn_silu"].items():
        x, g, b, G = gn_inputs(shape, groups, torch.bfloat16)
        c = shape[-1]
        x_nchw = x.reshape(shape[0], -1, c).transpose(1, 2).contiguous()
        nbytes = 2 * x.numel() * 2 + 2 * c * 4
        flops = 10 * x.numel()
        row = {
            "ms": event_ms(lambda: groupnorm.gn_silu_cuda(x, g, b, G)),
            "plain_ms": event_ms(lambda: groupnorm.gn_reference(
                x, g, b, G, 1e-5, True)),
            "library_ms": event_ms(lambda: F.silu(F.group_norm(
                x_nchw, G, g.to(x.dtype), b.to(x.dtype), 1e-5))),
            "device_ms": 1e-3 * device_us(
                lambda: groupnorm.gn_silu_cuda(x, g, b, G), ["gn_silu_kernel"]),
            "bytes_ms": 1e3 * nbytes / HBM_BYTES_S,
            "ops_ms": 1e3 * flops / PEAK_FLOPS["f32"],
        }
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        say("timing", f"gn_silu {shape}/{groups} bf16 x{n}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()))
        shape_rows.append({"kernel": "gn_silu", "shape": list(shape),
                           "groups": groups, "calls": n, **row})
        for k, v in row.items():
            per["gn_silu"][k] += n * v
    for (qs, ks, views), n in seen["attention"].items():
        q, k, v = attn_inputs(qs, ks, torch.bfloat16, views)
        b_, h_, nq, d = qs
        nk = ks[2]
        nbytes = (2 * q.numel() + 2 * k.numel()) * 2
        flops = 4 * b_ * h_ * nq * nk * d
        row = {
            "ms": event_ms(lambda: attn_mod.attention_cuda(q, k, v, d ** -0.5)),
            "plain_ms": event_ms(lambda: attn_mod.attention_reference(q, k, v)),
            "library_ms": event_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)),
            "device_ms": 1e-3 * device_us(
                lambda: attn_mod.attention_cuda(q, k, v, d ** -0.5),
                ["attention_mma_kernel", "attention_fma_kernel"]),
            "library_device_ms": 1e-3 * device_us(
                lambda: F.scaled_dot_product_attention(q, k, v), None),
            "bytes_ms": 1e3 * nbytes / HBM_BYTES_S,
            "ops_ms": 1e3 * flops / PEAK_FLOPS["bf16"],
        }
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        say("timing", f"attention q{qs} k{ks} bf16 {'views ' if views else ''}"
            f"x{n}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
        shape_rows.append({"kernel": "attention", "q": list(qs),
                           "k": list(ks), "views": views, "calls": n, **row})
        for key, val in row.items():
            per["attention"][key] += n * val

    # ---- 6. main path: one serving decode, counts reset just before ----
    _kernels.reset_launches()
    out = rt16.decompress(blob768)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    say("main", f"serving decode 768x512 (BF16_POLICY): launches {launches}")
    check(out.shape == (hdr7.height, hdr7.width, 3) and out.dtype == np.uint8,
          f"bad output {out.shape} {out.dtype}")
    check(launches == {"gn_silu": 93, "attention": 60},
          f"main path launches {launches} != 93 GN+SiLU and 60 attention")
    expected = {k: sum(seen[k].values()) for k in seen}
    check(launches == expected, f"launches {launches} != shapes {expected}")

    kernels = []
    for name in ("gn_silu", "attention"):
        p = per[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": ("bytes" if p["bytes_ms"] >= p["ops_ms"]
                         else "operations"),
            "library_ms": p["library_ms"]})
    REPORT["kernels"] = kernels
    REPORT["device_ms"] = {name: per[name]["device_ms"] for name in per}
    REPORT["shapes"] = shape_rows
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1))

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
