#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it: decode, encode,
eval, the user-facing API and CLI, training, and the mesh paths.

Runs the port (tpucdc_torch) only; imports nothing of JAX or tpucdc. Phases,
in order; any failure raises, exits non-zero and prints no result line:

  1. device   — a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build    — builds the CUDA kernels (nvcc, sm_90a) and the rANS host
                coder from the sources in the checkout; prints seconds and
                ptxas' register/spill lines; attention.o must hold HMMA
                (mma.sync) and attention_sm90.o HGMMA (wgmma) instructions.
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
                the main path, and the same at the shapes of the DiT-XL/2
                decode (the ``dit_decode_*`` fields of the ``kernels``
                line).
  6. main path — the launch counts of one serving decode
                (``CodecRuntime.decompress`` under BF16_POLICY, the JAX
                package's serving policy), counts reset just before: 93
                GN+SiLU launches and 60 attention launches, no more. The
                same for ``dit_xl2_serving()`` (the flagship's codec and
                head, a DiT-XL/2 drawn from a seed), graphed as served: 3
                GN+SiLU launches (the head) and 140 attention launches (28
                blocks × 5 steps), no more, all 140 of them
                attention_mma_kernel_sm90 by the profiler's names.

  7. encode   — the flagship encodes the 384×512 crop of the fixture with
                ``compress(optimize_gamma="spatial")`` under F32_POLICY: the
                symbols decoded from its own bitstream are the symbols it
                coded; against JAX's symbols for the same crop at most 0.1 %
                differ, none by more than 1; the length is within 0.5 % of
                JAX's; the served PSNR against the crop is at least JAX's
                less 0.05 dB. Once more under BF16_POLICY: own round trip
                exact.
  8. vr       — ``artifacts/vr_wide_params.npz`` (space-channel context, 3
                gain rows) loads strictly. For JAX's four bitstreams of
                fixtures/vr_wide_384x512.npz (qualities 0, 1, 2 and 0.5):
                the 8 passes fed JAX's symbols give the row indexes of
                JAX's encoder (differences are counted per pass and
                printed: one makes that bitstream undecodable here, a
                finding and not a failure) and a mean decode within 1 LSB
                of JAX's; where no index differs the bitstream must decode
                to JAX's symbols exactly. The crop encodes at the four
                qualities with an exact round trip, lengths within 0.5 % of
                JAX's, rising with quality.
  9. encode timing — 768×512 (fixtures/image_768x512.npz), BF16_POLICY:
                ``compress`` plain and with the spatial γ search for the
                flagship, and for the VR model at quality 1; median of 5
                after a warm-up, and a split by stage. The launch counts of
                one ``compress(optimize_gamma="spatial")``, counts reset
                just before: six served decodes, 558 GN+SiLU and 360
                attention launches.

 10. modes    — the trained flagship on the 384×512 fixture under F32_POLICY
                with JAX's ε, against the JAX arrays of
                fixtures/flagship_modes.npz: ``decompress(guidance=2.0)`` and
                block-cached DDIM (``sample.cache_period=2``), each max
                |diff| <= 2 with >= 99.9 % within 1. Launch counts, derived
                from the UNet's config: guidance 93 GN+SiLU and 60 attention
                (batch 2, not twice the launches); block-cached 79 and 36
                (3 full steps, 2 on levels 0-1, which hold no attention).
                Then the block-cached decode's time beside the plain one's.
 11. tiled    — fixtures/flagship_768x512.tpucdc at tile 256, halo 32 (6
                tiles of 320×320): ``decompress_tiled(steps=0)`` within 1 LSB
                of JAX's; the refined tiled decode within 1 LSB of the same
                tiles decoded one by one with the same ε, in one set of 93
                and 60 launches. Then a 2048×1536 image made from a numpy
                seed, compressed on the card: 48 tiles in one batch against
                ``decompress(steps=0)``: both times, peak device memory,
                PSNR of the tiled mean decode against the untiled one.
 12. batch    — ``compress_many`` / ``decompress_many`` of 4 images (the
                flagship, two sizes) and of 3 (``vr_wide``, 8 context
                passes an image): bytes and pixels equal the one-by-one calls; both
                wall times.
 13. large    — ``presets.flagship()`` at full width, 768×512, BF16_POLICY:
                the trained codec with a UNet and a conditioning head drawn
                from a seed. One DDIM-100 decode (2303 GN+SiLU and 2200
                attention launches, derived), one DDPM decode over all 1000
                steps, and guidance 2.0 in the batch-doubled form against
                the two-call form: one net call (bf16 2e-2·max|reference|,
                f32 1e-4), a two-step decode from t_start = 0.15·(T-1) in
                both types (within twice what the net call's error gives
                through the first DDIM update, plus 2 LSB) and a 10-step
                decode (f32: PSNR >= 40 dB;
                bf16: printed, the random weights amplify its rounding); all
                repeatable under the same generator. Time per step.
 14. eval & API — (a) the port's PSNR, MS-SSIM, GMSD, LPIPS proxy and FID
                features of the 384x512 fixture's served and mean decodes
                against JAX's values (fixtures/eval_384x512.npz): PSNR
                within 1e-4 dB, MS-SSIM and GMSD 1e-5, LPIPS and features
                1e-4 relative; computed once before any runtime exists (run
                right after phase 1, while PyTorch's cuDNN TF32 default is
                on) and once here. (b) ``api.load_runtime("flagship",
                artifacts/flagship_params.npz, SERVING_OVERRIDES)`` equals
                ``flagship_serving()`` and decodes flagship_768x512.tpucdc
                bit-equal to phase 6's runtime under seed 0; a runtime on
                JAX's exported coder tables (``cdf_tables=``) decodes JAX's
                bitstream to JAX's symbols. (c) ``evaluate_dataset`` over
                ``eval_dataset("kodak")`` (24 images of 512x768, synthetic
                without a Kodak directory) at 5 steps with LPIPS: 24 x 93
                GN+SiLU and 24 x 60 attention launches, the aggregate row
                and the per-image decode time; ``step_guidance_sweep`` over
                steps (2, 5) x guidance (1, 2) on 2 images with FID;
                ``time_decode``. (d) the CLI in-process
                (``tpucdc_torch.cli.main.main``) on the trained flagship:
                ``compress --optimize-gamma spatial`` gives
                ``rt.compress``'s bytes, ``decompress --seed 0`` its pixels,
                ``eval --sweep latency`` runs, and on ``vr_wide``
                ``compress --target-bpp`` lands within 3 % of the target
                with ``compress_to_bpp``'s bytes. Where Pillow is absent the
                CLI's two image-I/O helpers read and write .npy (printed).
 15. train    — the flagship recipe (scripts/r4d_queue.sh: the served
                flagship's model, t-low 0.35/0.5, λ 128, distortion "both",
                LPIPS 15, batch 16, crop 192, K = 16). (a) Both kernels'
                gradients (autograd.Functions whose backward is PyTorch
                operations) against autograd through their plain versions,
                in bf16 and f32, at every shape a recipe step gives them
                (found by one step, on the attention block's head views and
                at batch 1): 2-norm within 1e-5 of the plain gradient's in
                f32, 2e-2 in bf16. (b) The trained flagship under
                F32_POLICY with TF32 off, at batch 2 and crop 192 with JAX's
                draws, against fixtures/flagship_train_step.npz: the loss
                and every metric within 1e-4 relative; every stored
                gradient, and every parameter's gradient norm, within
                1e-3·‖g_JAX‖ + 1e-6 (f32 sums in cuDNN's order, over 398
                parameters and a 20-layer chain, against XLA:CPU's). (c) One
                recipe train step launches 21 GN+SiLU and 12 attention
                kernels (the forward: one decode's 93 / 60 less four UNet
                calls; the backward launches none), derived and asserted.
                (d) The recipe through ``python -m tpucdc_torch train``
                in-process, from a fresh initialisation on ``kodak()``,
                warmup shortened, 6 K-chunks (RECIPE_CHUNKS): steps a second
                (the run's own log), peak device memory, the logged loss of
                the first and the last chunk (the last must be lower), and
                the loss less its aux term on one fixed batch with fixed
                draws at the run's initialisation and at its end (it must
                fall: the aux term trains the quantiles alone); a resume
                from the mid-run checkpoint (the same batches, the
                parameters within 1e-3 relative of the uninterrupted run's;
                whether they are bit-equal is printed), whose last four
                steps run under the profiler for the device's busy share;
                ``load_runtime`` on the run directory serves the EMA
                weights with an exact round trip. Each
                kernel's forward and backward device time a step beside its
                bound and autograd through ``F.group_norm``+``F.silu`` and
                through SDPA. (e) ``estimate_bpp`` against the bytes of
                ``compress`` for the flagship and for ``vr_wide`` at
                qualities 0, 1, 2 (printed; a sanity bound of 30 %: the
                estimate leaves out rANS's escape coding, and reads about
                a fifth high at quality 2 in the JAX package too),
                ``compress_to_bpp(..., probe="estimate")`` at phase 14's
                target within 15 % (the JAX package's bound), beside
                ``probe="encode"``; one estimate probe's time against one
                encode probe's.

The kernel checks of phase 3 also cover every shape these paths give the two
kernels (batch 2, 6 and 48; head widths 48 and 64; the 384×512 fixture plain
and guided; the variable-rate model), found by one step of each, and those of
the DiT-XL/2 decode at 768×512, found by one whole decode: attention at
(1, 16, 6144, 72) on head views of one qkv projection, the kernel's d ≤ 128
path. The last
three lines are the card's name and power limit, the ``kernels`` JSON line,
and ``{"ok": true, "device": {...}}``. Details also go to
chiprun_out/chip_smoke.json. Phases 14, 15 and 16 run after phase 13, each
with its counts set to 0 just before the run it reads.

 16. mesh     — the card is one, so the mesh is a world of 1 over NCCL: the
                ``TPUCDC_*`` variables (a free local port) make
                ``maybe_init_distributed("cuda")`` start NCCL and
                ``make_mesh()`` is (data 1, model 1) on cuda:0; phase 15's
                recipe from a fresh init for 2 chunks with ``mesh=None`` and
                with the mesh, in turns (N M M N): the 398 parameters and
                the EMA bit-equal, 21 / 12 launches a mesh step; the same
                with ``param_sharding="tensor"``, bit-equal to replicated;
                phase 11's 48-tile decode with and without the mesh, same
                noise, in turns: within 1 LSB, 93 / 60 launches; the
                ``train`` verb in a process of its own under ``TPUCDC_*``
                (4 steps), whose run directory ``load_runtime`` serves. The
                phase must take at most 90 s.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
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
VR_WEIGHTS = ROOT / "artifacts" / "vr_wide_params.npz"

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


def psnr_db(a, b) -> float:
    import numpy as np
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def hyper_stage(torch, rt, z_sym):
    """A hyperprior runtime's one y pass up to its coding: (μ on the device,
    the uint8 row indexes on the host)."""
    with torch.inference_mode():
        means, scales = rt.model.h_s(rt._z_hat(z_sym))
        idx = rt.gaussian.build_indexes(scales).to(torch.uint8)
    return means, idx.cpu().numpy()


class StageSplit:
    """Exclusive wall time of a runtime's coding stages, by patching them on
    the instance with timers. Each timed call ends with a synchronize, so
    device work lands in the stage that queued it; the fetch does not
    synchronize first, so it also carries the rounding queued before it.
    Inside the γ search nothing is split: it is one stage. The entropy
    parameters are the y schedule's features and passes (h_s and the
    context model) and the row indexes built from their σ."""

    def __init__(self, torch, rt):
        self.torch, self.acc, self.stack = torch, collections.Counter(), []
        self.in_search = False
        self._patched = []
        for owner, attr, name, sync_first in (
                (rt, "_analysis", "analysis", True),
                (rt.gaussian, "build_indexes", "entropy_params", True),
                (rt, "_fetch", "round_fetch", False),
                (rt.z_codec, "encode", "z_rans", True),
                (rt.y_codec, "encode", "y_rans", True),
                (rt, "_optimize_gamma", "gamma_search", True)):
            setattr(owner, attr,
                    self._wrap(getattr(owner, attr), name, sync_first))
            self._patched.append((owner, attr))
        sched = self._schedule = rt._schedule
        timed = functools.partial(self._wrap, name="entropy_params",
                                  sync_first=True)
        rt._schedule = sched._replace(
            features=timed(sched.features),
            passes=[p._replace(params=timed(p.params))
                    for p in sched.passes])
        self._rt = rt

    def _wrap(self, fn, name, sync_first):
        def timed(*args, **kwargs):
            if self.in_search:
                return fn(*args, **kwargs)
            if sync_first:
                self.torch.cuda.synchronize()
            self.in_search = name == "gamma_search"
            t0 = time.perf_counter()
            self.stack.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                self.torch.cuda.synchronize()
                self.in_search = False
                dt = 1e3 * (time.perf_counter() - t0)
                self.acc[name] += dt - self.stack.pop()
                if self.stack:
                    self.stack[-1] += dt
        return timed

    def restore(self):
        for owner, attr in self._patched:
            delattr(owner, attr)
        self._rt._schedule = self._schedule


def unet_launches(ucfg, levels=None) -> dict:
    """GN+SiLU and attention launches of one UNet forward, from its config:
    all levels and the mid block, or only ``levels`` (the shallow segment of a
    block-cached step). A ResBlock launches GN+SiLU once (norm1), the output
    norm once; an attention block launches attention once, and each has a
    cross-attention twin when the model has conditioning tokens."""
    whole = levels is None
    levels = range(len(ucfg.channel_mult)) if whole else levels
    per_level = 2 * ucfg.num_res_blocks + 1          # down blocks + up blocks
    res = per_level * len(levels) + (2 if whole else 0)
    attn = (per_level * sum(li in ucfg.attn_levels for li in levels)
            + (1 if whole else 0))
    return {"gn_silu": res + 1,
            "attention": attn * (2 if ucfg.cond_token_dim else 1)}


def decode_launches(cfg, steps: int, cache_period: int = 1) -> dict:
    """Launches of one device stage: the conditioning head's GN+SiLUs, then
    ``steps`` UNet forwards, of which a block-cached chain runs only the
    shallow levels where ``k % cache_period != 0``."""
    ucfg, cond = cfg.model.unet, cfg.model.cond
    head = 1 + (cond.latent_factor // cond.output_stride).bit_length() - 1
    full = unet_launches(ucfg)
    shallow = unet_launches(ucfg, range(ucfg.split_level))
    n_full = len(range(0, steps, cache_period))
    return {k: (head if k == "gn_silu" else 0) + n_full * full[k]
            + (steps - n_full) * shallow[k] for k in full}


def lsb_gap(got, want):
    """(largest |difference|, share of pixels within 1) of two uint8 images."""
    import numpy as np
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), float(np.mean(d <= 1))


def seeded_image(h: int, w: int, seed: int):
    """An HWC uint8 image from a numpy seed: smooth colour fields, a few hard
    edges and some grain, so that a codec has structure to code."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(12):
        fy, fx = rng.uniform(0.5, 12.0, 2) * 2 * np.pi / np.array([h, w])
        wave = np.sin(fy * yy + fx * xx + rng.uniform(0, 2 * np.pi))
        img += wave[..., None] * rng.uniform(-30, 30, 3)
    for _ in range(40):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        dy, dx = rng.integers(16, h // 4), rng.integers(16, w // 4)
        img[y0:y0 + dy, x0:x0 + dx] += rng.uniform(-60, 60, 3)
    img += 128 + rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# Phase 15: kernel gradients against autograd of the plain versions (relative
# 2-norm), and the training step against JAX's fixture (see the docstring).
GRAD_TOL = {"f32": 1e-5, "bf16": 2e-2}
TRAIN_METRIC_REL = 1e-4
TRAIN_GRAD_REL, TRAIN_GRAD_ABS = 1e-3, 1e-6
RECIPE = {"model.t_low_frac": "0.35", "model.t_low_prob": "0.5",
          "train.rd_lambda": "128", "train.batch_size": "16",
          "train.crop_size": "192", "train.distortion": "both",
          "train.lpips_weight": "15", "train.steps_per_dispatch": "16"}
RECIPE_CHUNKS = 6
PROFILED_STEPS = 4
# probe="estimate" against its target: the JAX package's own bound
# (tests/integration/test_continuous_rate.py). The analytic rate against the
# coder's bytes is a sanity bound only: the estimate is the entropy models'
# rate without rANS's escape coding and table quantisation, and at quality 2
# of vr_wide it reads about a fifth above the coder in the JAX package too
# (the CPU tests hold the port's estimate to JAX's within 1e-5).
RATE_EST_REL = 0.15
RATE_GAP_SANITY = 0.3

# Phase 14 bounds against JAX's eval fixture (fixtures/eval_384x512.npz).
EVAL_BOUNDS = {"psnr": 1e-4, "ms_ssim": 1e-5, "gmsd": 1e-5}   # absolute
EVAL_REL = 1e-4                                    # LPIPS and the features


def eval_metrics_check(torch, dev) -> dict:
    """The port's PSNR, MS-SSIM, GMSD, LPIPS proxy and FID features of the
    flagship fixture's decodes on the card, against JAX's values. Raises on
    a value out of bounds; returns the errors and the TF32 flag it ran
    under."""
    import numpy as np
    from tpucdc_torch.eval import PerceptualMetric, gmsd, ms_ssim, psnr
    from tpucdc_torch.eval.fid import _FeatureExtractor
    fx = np.load(FIXTURES / "flagship_384x512.npz")
    ev = np.load(FIXTURES / "eval_384x512.npz")
    crop = torch.from_numpy(fx["crop_u8"]).to(dev)
    lpips = PerceptualMetric(device=dev)
    out = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    for tag in ("serve", "mean"):
        rec = torch.from_numpy(fx[f"{tag}_u8"]).to(dev)
        for name, fn in (("psnr", psnr), ("ms_ssim", ms_ssim),
                         ("gmsd", gmsd)):
            got, want = fn(crop, rec), float(ev[f"{name}_{tag}"])
            out[f"{name}_{tag}"] = got
            check(abs(got - want) <= EVAL_BOUNDS[name],
                  f"{name} {tag}: {got} vs JAX {want}")
        got, want = lpips(crop, rec), float(ev[f"lpips_{tag}"])
        out[f"lpips_{tag}"] = got
        check(abs(got - want) <= EVAL_REL * abs(want),
              f"lpips {tag}: {got} vs JAX {want}")
    feats = _FeatureExtractor(device=dev)(np.stack(
        [fx["crop_u8"], fx["serve_u8"], fx["mean_u8"]]))
    want = ev["features"]
    err = float(np.max(np.abs(feats - want)) / np.max(np.abs(want)))
    out["features_rel_err"] = err
    check(err <= EVAL_REL, f"FID features differ from JAX's by {err:.3g}")
    return out


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
    from tpucdc_torch.pipelines import codec_runtime
    from tpucdc_torch.presets import dit_xl2_serving
    # The wrapper modules (the package namespace re-exports their functions).
    attn_mod = importlib.import_module("tpucdc_torch.ops.attention")
    groupnorm = importlib.import_module("tpucdc_torch.ops.groupnorm")
    from tpucdc_torch.runtime import set_policy
    from tpucdc_torch.sampling.graphed import GraphedDenoiser
    from tpucdc_torch.utils import draw_weights

    dev = torch.device("cuda")
    card = card_line()
    say("device", f"{card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    REPORT["card"] = card
    # Phase 14's metrics, first: before any runtime is built in the process
    # (a runtime turns TF32 off process-wide), so the metrics must do it.
    REPORT["eval_metrics_before_runtime"] = eval_metrics_check(torch, dev)

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
    # The bf16 attention kernels must hold tensor-core instructions: HMMA
    # (mma.sync: d <= 64, and the general d <= 128) in attention.o, HGMMA
    # (wgmma: the Hopper design for d > 64) in attention_sm90.o.
    cuobjdump = pathlib.Path(_kernels._nvcc()).with_name("cuobjdump")

    def sass_count(obj, op):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_kernels.BUILD_DIR / obj)],
            capture_output=True, text=True, check=True).stdout
        return sum(op in line for line in sass.splitlines())
    hmma = sass_count("attention.o", "HMMA")
    hgmma = sass_count("attention_sm90.o", "HGMMA")
    say("build", f"attention.o: {hmma} HMMA, attention_sm90.o: {hgmma} "
        f"HGMMA (tensor-core) instructions")
    check(hmma > 0, "no HMMA instruction in the attention kernel")
    check(hgmma > 0, "no HGMMA instruction in the attention kernel")
    REPORT["attention_hmma_instructions"] = hmma
    REPORT["attention_hgmma_instructions"] = hgmma

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
    blob = fx["blob"].tobytes()
    crop = fx["crop_u8"]
    img768 = np.load(FIXTURES / "image_768x512.npz")["image_u8"]

    # The variable-rate, space-channel checkpoint.
    vcfg = port.vr_wide_serving()
    vmodel = port.CDCModel(vcfg.model)
    vstate, vunused = port.load_params_npz(VR_WEIGHTS)
    check(len(vstate) == 438 and not vunused, "vr_wide: arrays left unused")
    vmodel.load_state_dict(vstate, strict=True)
    vfx = np.load(FIXTURES / "vr_wide_384x512.npz")
    rtv32 = port.CodecRuntime(vcfg, copy.deepcopy(vmodel), device=dev,
                              policy=port.F32_POLICY)
    rtv16 = port.CodecRuntime(vcfg, vmodel, device=dev,
                              policy=port.BF16_POLICY)

    # The large preset: the flagship's trained codec (the two presets share
    # its widths), a UNet and a conditioning head drawn from a seed.
    lcfg = port.flagship()
    lmodel = port.CDCModel(lcfg.model)
    drawn = ("unet.", "cond_head.")
    draw_weights(lmodel, seed=0, prefixes=drawn)
    missing, unexpected = lmodel.load_state_dict(
        {k: v for k, v in state.items() if not k.startswith(drawn)},
        strict=False)
    check(not unexpected and all(k.startswith(drawn) for k in missing),
          f"large preset: codec weights do not fit ({unexpected})")
    rtL = port.CodecRuntime(lcfg, lmodel, device=dev, policy=port.BF16_POLICY)

    # The DiT-XL/2 refiner (``dit_xl2_serving``) on the flagship's trained
    # codec and head, the DiT drawn from a seed (the repo has none trained).
    dcfg = dit_xl2_serving()
    dmodel = port.CDCModel(dcfg.model)
    draw_weights(dmodel, seed=0, prefixes=("dit.",))
    missing, unexpected = dmodel.load_state_dict(
        {k: v for k, v in state.items() if not k.startswith("unet.")},
        strict=False)
    check(not unexpected and all(k.startswith("dit.") for k in missing),
          f"DiT preset: codec weights do not fit ({unexpected})")
    rtD = port.CodecRuntime(dcfg, dmodel, device=dev, policy=port.BF16_POLICY)

    # Shape discovery: the shapes a path gives each kernel.
    orig_gn, orig_attn = groupnorm.gn_silu_cuda, attn_mod.attention_cuda

    def discover(run) -> dict:
        """The kernel shapes ``run`` hands the wrappers, with their counts,
        every UNet step run eagerly (a replayed CUDA graph calls no
        wrapper)."""
        into = {"gn_silu": collections.Counter(),
                "attention": collections.Counter()}

        def rec_gn(x, gamma, beta, num_groups, eps=1e-5):
            into["gn_silu"][(tuple(x.shape), num_groups)] += 1
            return orig_gn(x, gamma, beta, num_groups, eps)

        def rec_attn(q, k, v, scale):
            # The layout too: the attention block passes head views of its
            # [B, N, H·d] projections, not contiguous [B, H, N, d] tensors.
            views = not (q.is_contiguous() or k.is_contiguous()
                         or v.is_contiguous())
            into["attention"][(tuple(q.shape), tuple(k.shape), views)] += 1
            return orig_attn(q, k, v, scale)

        groupnorm.gn_silu_cuda, attn_mod.attention_cuda = rec_gn, rec_attn
        engages = GraphedDenoiser.engages
        GraphedDenoiser.engages = lambda self, x_t: False
        try:
            run()
        finally:
            groupnorm.gn_silu_cuda, attn_mod.attention_cuda = orig_gn, orig_attn
            GraphedDenoiser.engages = engages
        return into

    seen = discover(lambda: rt16.decompress(blob768))
    say("kernels", f"main-path shapes: {len(seen['gn_silu'])} GN+SiLU, "
        f"{len(seen['attention'])} attention")
    # One step of every other path: guidance (batch 2), 6 and 48 tiles, the
    # large preset plain and guided (head widths 48 and 64), the 384x512
    # fixture plain and guided, and the variable-rate checkpoint at both
    # sizes: every shape the later phases launch is held against its plain
    # version in phase 3.
    y48 = torch.zeros((48, 20, 20, cfg.model.codec.latent_channels),
                      dtype=torch.int32, device=dev)
    modes = discover(lambda: (
        rt16.decompress(blob768, steps=1, guidance=2.0),
        rt16.decompress_tiled(blob768, steps=1),
        rt16._device_stage(y48, torch.zeros((), device=dev), 1, 0.0, 0.5,
                           320, 320),
        rtL.decompress(blob768, steps=1),
        rtL.decompress(blob768, steps=1, guidance=2.0),
        rt16.decompress(blob, steps=1),
        rt32.decompress(blob, steps=1, guidance=2.0),
        rtv16.decompress(rtv16.compress(crop, quality=1), steps=1),
        rtv16.decompress(rtv16.compress(img768, quality=1), steps=1)))
    new_gn = [k for k in modes["gn_silu"] if k not in seen["gn_silu"]]
    new_attn = [k for k in modes["attention"] if k not in seen["attention"]]
    say("kernels", f"shapes of the other paths (guidance, 6 and 48 tiles, "
        f"the large preset, 384x512 plain and guided, the variable-rate "
        f"model) not on the main path: {len(new_gn)} GN+SiLU, "
        f"{len(new_attn)} attention")
    check(any(q[0] == 48 for q, _, _ in new_attn)
          and {q[3] for q, _, _ in new_attn} >= {24, 48, 64},
          f"the other paths did not reach batch 48 and d 48, 64: {new_attn}")
    check(any(q[:3] == (2, 4, 768) for q, _, _ in new_attn)
          and any(q[:3] == (1, 4, 768) for q, _, _ in new_attn),
          f"the 384x512 decodes were not discovered: {new_attn}")

    # The DiT's decode: its attention is the kernel's d ≤ 128 path, 28
    # blocks × 5 steps at (1, 16, 6144, 72) on head views of one qkv
    # projection; its GN+SiLU the conditioning head's, as the flagship's.
    dit_seen = discover(lambda: rtD.decompress(blob768))
    dit_attn = [k for k in dit_seen["attention"]
                if k not in seen["attention"] and k not in new_attn]
    say("kernels", f"DiT decode shapes: attention {dict(dit_seen['attention'])}"
        f", GN+SiLU {dict(dit_seen['gn_silu'])}")
    check(dict(dit_seen["attention"]) == {
        ((1, 16, 6144, 72), (1, 16, 6144, 72), True): 140}
        and set(dit_seen["gn_silu"]) <= set(seen["gn_silu"])
        and sum(dit_seen["gn_silu"].values()) == 3,
        f"the DiT decode's shapes are not 140 x (1, 16, 6144, 72) on head "
        f"views and 3 of the head's GN+SiLU: {dit_seen}")

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
    path_gn = set(seen["gn_silu"]) | set(new_gn)
    gn_cases = list(seen["gn_silu"]) + new_gn + [
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
            if dn == "bf16" and (shape, groups) in path_gn:
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
        for (qs, ks, views) in list(seen["attention"]) + new_attn + dit_attn:
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
    hdr, z_sym, (y_bytes,), (ph, pw) = rt32._host_z_stage(blob)
    means, idx = hyper_stage(torch, rt32, z_sym)
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
    _, idx16 = hyper_stage(torch, rt32, z_sym)
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
    hdr7, z7, (yb7,), (ph7, pw7) = rt16._host_z_stage(blob768)
    m7, i7 = hyper_stage(torch, rt16, z7)
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
            h, z, (yb,), (a, b) = rt._host_z_stage(blob768)
            t1 = time.perf_counter()
            m, i = hyper_stage(torch, rt, z)
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

    shape_rows = []

    def time_shapes(found, path) -> dict:
        """Each kernel's times and bound at every shape ``found`` (a
        ``discover`` result), into ``shape_rows``; the sums over the path's
        calls, per kernel."""
        per = {"gn_silu": collections.defaultdict(float),
               "attention": collections.defaultdict(float)}
        for (shape, groups), n in found["gn_silu"].items():
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
                    lambda: groupnorm.gn_silu_cuda(x, g, b, G),
                    ["gn_silu_kernel"]),
                "bytes_ms": 1e3 * nbytes / HBM_BYTES_S,
                "ops_ms": 1e3 * flops / PEAK_FLOPS["f32"],
            }
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            say("timing", f"[{path}] gn_silu {shape}/{groups} bf16 x{n}: "
                + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
            shape_rows.append({"kernel": "gn_silu", "path": path,
                               "shape": list(shape), "groups": groups,
                               "calls": n, **row})
            for k, v in row.items():
                per["gn_silu"][k] += n * v
        for (qs, ks, views), n in found["attention"].items():
            q, k, v = attn_inputs(qs, ks, torch.bfloat16, views)
            b_, h_, nq, d = qs
            nk = ks[2]
            nbytes = (2 * q.numel() + 2 * k.numel()) * 2
            flops = 4 * b_ * h_ * nq * nk * d
            row = {
                "ms": event_ms(
                    lambda: attn_mod.attention_cuda(q, k, v, d ** -0.5)),
                "plain_ms": event_ms(
                    lambda: attn_mod.attention_reference(q, k, v)),
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
            say("timing", f"[{path}] attention q{qs} k{ks} bf16 "
                f"{'views ' if views else ''}x{n}: "
                + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
            shape_rows.append({"kernel": "attention", "path": path,
                               "q": list(qs), "k": list(ks), "views": views,
                               "calls": n, **row})
            for key, val in row.items():
                per["attention"][key] += n * val
        return per

    per = time_shapes(seen, "main")
    per_dit = time_shapes(dit_seen, "dit")

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
    # The DiT's decode, graphed as served: 28 blocks x 5 steps of attention
    # and the conditioning head's 3 GN+SiLU.
    _kernels.reset_launches()
    out = rtD.decompress(blob768)
    torch.cuda.synchronize()
    dit_launches = dict(_kernels.LAUNCHES)
    say("main", f"DiT-XL/2 serving decode 768x512 (BF16_POLICY): launches "
        f"{dit_launches}")
    check(out.shape == (hdr7.height, hdr7.width, 3) and out.dtype == np.uint8,
          f"bad DiT output {out.shape} {out.dtype}")
    check(dit_launches == {"gn_silu": 3, "attention": 140},
          f"DiT decode launches {dit_launches} != 3 GN+SiLU and 140 "
          f"attention")
    expected = {k: sum(dit_seen[k].values()) for k in dit_seen}
    check(dit_launches == expected,
          f"DiT launches {dit_launches} != shapes {expected}")
    # Which d > 64 kernel those 140 were: the Hopper instantiation's launches
    # in one graphed DiT decode, by name from the profiler (the wrappers'
    # count does not tell the two apart).
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        rtD.decompress(blob768)
        torch.cuda.synchronize()
    dit_sm90 = sum(e.count for e in prof.key_averages()
                   if "attention_mma_kernel_sm90" in e.key)
    say("main", f"DiT-XL/2 serving decode: {dit_sm90} launches of "
        f"attention_mma_kernel_sm90 (profiler)")
    check(dit_sm90 == dit_launches["attention"],
          f"{dit_sm90} of the DiT decode's {dit_launches['attention']} "
          f"attention launches took attention_mma_kernel_sm90")
    REPORT["dit_decode_sm90_launches"] = dit_sm90
    del rtD, dmodel
    torch.cuda.empty_cache()

    # ---- 7. encode: the flagship on the fixture's crop ----
    def round_trip(rt, img, blob, quality=0):
        """Symbols decoded from ``blob`` against the ones the encoder's
        stages code; returns the decoded (z, y)."""
        x = torch.from_numpy(codec_runtime.to_model_range(
            codec_runtime.pad_image(img)[0]))[None].to(dev)
        y, z_enc = rt._analysis(x, quality)
        z_enc = z_enc.cpu().numpy()
        y_enc, _, _ = rt._y_passes(z_enc, y=y)
        _, z_dec, _, _ = rt._host_z_stage(blob)
        _, y_dec, _, _ = rt._decode_symbols(blob)
        y_dec = y_dec.cpu().numpy()
        bad = int(np.sum(z_dec != z_enc)) + int(
            np.sum(y_dec != y_enc.cpu().numpy()))
        check(bad == 0, f"own round trip: {bad} symbols differ")
        return z_dec, y_dec

    def against(mine, theirs):
        """(differing symbols, largest difference) of two (z, y) pairs."""
        n = sum(int(np.sum(a != b)) for a, b in zip(mine, theirs))
        worst = max(int(np.abs(a.astype(np.int64) - b).max())
                    for a, b in zip(mine, theirs))
        return n, worst

    t0 = time.perf_counter()
    enc = rt32.compress(crop, optimize_gamma="spatial")
    enc_s = time.perf_counter() - t0
    ehdr, _ = port.entropy.read_bitstream(enc)
    mine = round_trip(rt32, crop, enc)
    n_diff, worst = against(mine, (fx["z_sym"], fx["y_sym"]))
    n_sym = fx["z_sym"].size + fx["y_sym"].size
    jax_len = fx["blob"].size
    grid_won = ehdr.gamma_grid is not None
    jhdr, _ = port.entropy.read_bitstream(fx["blob"].tobytes())
    say("encode", f"flagship 384x512 F32_POLICY compress(optimize_gamma="
        f"'spatial') in {enc_s:.2f} s (first call): own round trip exact; "
        f"{n_diff} of {n_sym} symbols differ from JAX's (bound 0.1 %), "
        f"largest difference {worst} (bound 1); {len(enc)} B against JAX's "
        f"{jax_len} B (bound 0.5 %)")
    say("encode", f"gamma picked {ehdr.gamma} (JAX {jhdr.gamma}), grid "
        f"{'won' if grid_won else 'lost'} (JAX's "
        f"{'won' if jhdr.gamma_grid is not None else 'lost'})"
        + (f", grid {ehdr.gamma_grid.tolist()}" if grid_won else ""))
    check(n_diff <= 1e-3 * n_sym and worst <= 1, "symbols differ from JAX's")
    check(abs(len(enc) - jax_len) <= 5e-3 * jax_len, "length differs from JAX's")
    psnr_port = psnr_db(rt32.decompress(enc), crop)
    psnr_jax = psnr_db(fx["serve_u8"], crop)
    say("encode", f"served PSNR against the crop: port {psnr_port:.3f} dB, "
        f"JAX {psnr_jax:.3f} dB (bound: JAX's less 0.05)")
    check(psnr_port >= psnr_jax - 0.05, "served PSNR below JAX's")
    enc16 = rt16.compress(crop, optimize_gamma="spatial")
    mine16 = round_trip(rt16, crop, enc16)
    n16, worst16 = against(mine16, (fx["z_sym"], fx["y_sym"]))
    say("encode", f"BF16_POLICY: own round trip exact; {len(enc16)} B; "
        f"{n16} symbols differ from JAX's f32 ones, largest {worst16} "
        f"(bf16 g_a and h_a; a finding, not a gate)")
    REPORT["encode"] = {
        "symbols": n_sym, "differ_from_jax": n_diff, "largest": worst,
        "bytes": len(enc), "jax_bytes": int(jax_len), "gamma": ehdr.gamma,
        "grid_won": grid_won, "psnr_db": psnr_port, "jax_psnr_db": psnr_jax,
        "bf16_bytes": len(enc16), "bf16_differ_from_jax_f32": n16}

    # ---- 8. vr: the variable-rate, space-channel checkpoint ----
    def forced_passes(rt, z_sym, y_sym, jax_idx):
        """Run the decoder's passes with each pass's symbols taken from
        ``y_sym`` (JAX's) and not from the coder. Returns (row indexes that
        differ from JAX's, per pass; for each such index this side's σ
        beside the table scale of JAX's row; the assembled y symbols; μ)."""
        passes = rt._schedule.passes
        am = port.codec.checkerboard_mask(*y_sym.shape[1:3], True)[..., 0] > 0
        table = np.asarray(rt.gaussian.scale_table, np.float32)
        flips, near, sigmas = [], [], []
        build = rt.gaussian.build_indexes

        def recording_build(scales):
            sigmas.append(scales)
            return build(scales)

        def forced(_stream, idx_np):
            k = len(flips)
            p = passes[k]
            mask = None if p.anchors is None else am if p.anchors else ~am
            differ = idx_np[0] != jax_idx[k]
            flips.append(int(np.sum(differ)))
            if flips[-1]:
                sigma = sigmas[-1]
                if mask is not None:
                    sigma = sigma[:, torch.from_numpy(mask).to(dev)]
                for here, row in zip(sigma[0].cpu().numpy()[differ],
                                     jax_idx[k][differ]):
                    near.append({"pass": k, "sigma": float(here),
                                 "jax_row": int(row),
                                 "jax_row_scale": float(table[row])})
            part = y_sym[..., p.channels]
            return (part if mask is None else part[:, mask]).astype(np.int32)

        rt.y_codec.decode, rt.gaussian.build_indexes = forced, recording_build
        try:
            sym, means, _ = rt._y_passes(z_sym, streams=[b""] * len(jax_idx))
        finally:
            del rt.y_codec.decode, rt.gaussian.build_indexes
        return flips, near, sym, means

    vr_rows = {}
    for q in (float(v) for v in vfx["qualities"]):
        tag = "q" + f"{q:g}".replace(".", "p")
        jblob = vfx[f"blob_{tag}"].tobytes()
        theirs = (vfx[f"z_sym_{tag}"], vfx[f"y_sym_{tag}"])
        jhdr, z_dec, _, (vph, vpw) = rtv32._host_z_stage(jblob)
        check(np.array_equal(z_dec, theirs[0]), f"vr q{q:g}: z symbols differ")
        # Every pass fed JAX's symbols: which row indexes would the card
        # compute differently from the encoder that wrote this bitstream?
        flips, near, sym, means = forced_passes(rtv32, z_dec, theirs[1],
                                                vfx[f"indexes_{tag}"])
        check(np.array_equal(sym.cpu().numpy(), theirs[1]),
              "forced passes do not reassemble the symbols")
        _, inv_gain = rtv32.quality_gains(
            jhdr.quality_id if jhdr.quality_f_or_none is None
            else jhdr.quality_f)
        mean_u8 = rtv32._device_stage(sym, means, 0, 0.0, 0.0, vph, vpw,
                                      inv_gain=inv_gain).cpu().numpy()[0]
        d_mean = np.abs(mean_u8[:jhdr.height, :jhdr.width].astype(int)
                        - vfx[f"mean_u8_{tag}"].astype(int)).max()
        if any(flips):
            # A σ within float noise of a scale-table boundary lands in the
            # next row on this side: rANS cannot decode this bitstream here.
            say("vr", f"quality {q:g}: FINDING: JAX's bitstream is not "
                f"decodable on this device: row indexes that differ from "
                f"the JAX encoder's, per pass {flips} of "
                f"{vfx[f'indexes_{tag}'][0].size} each; this side's sigma "
                f"beside the scale of JAX's row: " + "; ".join(
                    f"pass {e['pass']}: {e['sigma']!r} against row "
                    f"{e['jax_row']} = {e['jax_row_scale']!r}" for e in near))
            n = None
        else:
            _, y_dec, _, _ = rtv32._decode_symbols(jblob)
            n, _ = against((z_dec, y_dec.cpu().numpy()), theirs)
            check(n == 0, f"vr q{q:g}: {n} symbols of JAX's bitstream differ")
            check(np.array_equal(rtv32.decompress(jblob, steps=0),
                                 mean_u8[:jhdr.height, :jhdr.width]),
                  "decompress(steps=0) differs from the forced passes")
        mine = rtv32.compress(crop, quality=q)
        n_enc, worst_enc = against(round_trip(rtv32, crop, mine, q), theirs)
        say("vr", f"quality {q:g}: row-index flips per pass {flips}; JAX's "
            f"bitstream decodes with {n} symbol mismatches (bound 0), mean "
            f"decode max|diff| {d_mean} LSB (bound 1); own round trip "
            f"exact, {len(mine)} B against JAX's {len(jblob)} B (bound "
            f"0.5 %), {n_enc} symbols differ from JAX's encoder, largest "
            f"{worst_enc}")
        check(d_mean <= 1, f"vr q{q:g}: mean decode differs by {d_mean}")
        check(abs(len(mine) - len(jblob)) <= 5e-3 * len(jblob),
              f"vr q{q:g}: length differs from JAX's")
        vr_rows[q] = {"bytes": len(mine), "jax_bytes": len(jblob),
                      "index_flips_per_pass": flips, "flipped": near,
                      "jax_bitstream_symbol_mismatches": n,
                      "differ_from_jax": n_enc, "largest": worst_enc,
                      "mean_max_diff": int(d_mean)}
    sizes = [vr_rows[q]["bytes"] for q in sorted(vr_rows)]
    check(sizes == sorted(sizes) and len(set(sizes)) == len(sizes),
          f"vr: length does not rise with quality {sizes}")
    vserve = rtv16.decompress(rtv16.compress(crop, quality=1,
                                             optimize_gamma=True))
    say("vr", f"BF16_POLICY quality 1 with the gamma search, served: PSNR "
        f"{psnr_db(vserve, crop):.3f} dB against the crop")
    check(vserve.shape == crop.shape and psnr_db(vserve, crop) > 20,
          "vr served decode is not an image of the crop")
    REPORT["vr"] = {f"{q:g}": r for q, r in vr_rows.items()}

    # ---- 9. encode timing at 768×512, BF16_POLICY ----
    _kernels.reset_launches()
    blob_s = rt16.compress(img768, optimize_gamma="spatial")
    torch.cuda.synchronize()
    enc_launches = dict(_kernels.LAUNCHES)
    say("main", f"compress(optimize_gamma='spatial') 768x512 (BF16_POLICY): "
        f"launches {enc_launches}; {len(blob_s)} B")
    check(enc_launches == {"gn_silu": 6 * 93, "attention": 6 * 60},
          f"compress launches {enc_launches} != six served decodes")
    check(rt16.decompress(blob_s).shape == img768.shape, "bad decode shape")

    enc_timing = {}
    for name, rt, kwargs in (
            ("flagship", rt16, {}),
            ("flagship_spatial", rt16, {"optimize_gamma": "spatial"}),
            ("vr_wide_q1", rtv16, {"quality": 1}),
            ("vr_wide_q1_spatial", rtv16, {"quality": 1,
                                           "optimize_gamma": "spatial"})):
        total = host_median(lambda: rt.compress(img768, **kwargs), runs=5)
        split = StageSplit(torch, rt)
        try:
            runs = []
            for _ in range(4):
                split.acc.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                rt.compress(img768, **kwargs)
                wall = 1e3 * (time.perf_counter() - t)
                runs.append({**split.acc, "other": wall - sum(
                    split.acc.values()), "timed_wall": wall})
        finally:
            split.restore()
        stages = {k: statistics.median(r.get(k, 0.0) for r in runs[1:])
                  for k in runs[-1]}
        enc_timing[name] = {"compress_ms": total, "split_ms": stages}
        say("timing", f"768x512 compress {name} BF16_POLICY: {total:.2f} ms "
            f"(median of 5 after 1 warm-up); split with a synchronize after "
            f"every stage (ms, median of 3): " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items()))
    REPORT["encode_timing_ms"] = enc_timing
    REPORT["compress_launches"] = enc_launches


    # ---- the other decode paths: counts set to 0 before, read after ----
    def counted(run):
        _kernels.reset_launches()
        out = run()
        torch.cuda.synchronize()
        return out, dict(_kernels.LAUNCHES)

    def timed(run):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    def with_sample(runtime, policy, **sample):
        """A runtime on the same model with other sample settings."""
        scfg = dataclasses.replace(runtime.config, sample=dataclasses.replace(
            runtime.config.sample, **sample))
        return port.CodecRuntime(scfg, runtime.model, device=dev,
                                 policy=policy)

    path_launches = {"dit_decode": dit_launches}

    # ---- 10. guidance and block cache on the trained flagship ----
    mfx = np.load(FIXTURES / "flagship_modes.npz")
    serve_steps = cfg.sample.steps
    for name, rt, kwargs, want_n in (
            ("guidance 2.0", rt32, {"guidance": 2.0},
             decode_launches(cfg, serve_steps)),
            ("block-cached, period 2",
             with_sample(rt32, port.F32_POLICY, cache_period=2), {},
             decode_launches(cfg, serve_steps, cache_period=2))):
        got, n = counted(lambda: rt.decompress(blob, noise=eps, **kwargs))
        key = "guide2_u8" if kwargs else "cache2_u8"
        worst, within1 = lsb_gap(got, mfx[key])
        say("modes", f"{name}, 384x512 F32_POLICY vs JAX: max|diff| {worst} "
            f"LSB (bound 2), {100 * within1:.4f} % within 1 (bound 99.9 %); "
            f"launches {n} (derived {want_n})")
        check(worst <= 2 and within1 >= 0.999, f"{name} differs from JAX")
        check(n == want_n, f"{name}: launches {n} != {want_n}")
        check(not np.array_equal(got, serve_u8), f"{name} changed nothing")
        path_launches["guidance" if kwargs else "block_cached"] = n
        REPORT.setdefault("modes", {})[key] = {
            "max_diff": worst, "within1": within1, "launches": n}
    check(path_launches["guidance"] == {"gn_silu": 93, "attention": 60}
          and path_launches["block_cached"] == {"gn_silu": 79,
                                                "attention": 36},
          "derived launch counts are not 93/60 and 79/36")
    stage = lambda rt, **kw: rt._device_stage(
        y7, m7, hdr7.steps, 0.0, gamma7, ph7, pw7, **kw)
    # In turns, so that the three see the same host: its speed drifts by
    # more within a run than the variants differ.
    variants = {"plain": {}, "block_cached": {"cache_period": 2},
                "guided": {"guidance": 2.0}}
    turns = {name: [] for name in variants}
    for rnd in range(8):
        for name, kw in variants.items():
            _, ms = timed(lambda: stage(rt16, **kw))
            if rnd:                      # round 0 warms up
                turns[name].append(ms)
    stage_ms = {name: statistics.median(v) for name, v in turns.items()}
    say("modes", f"768x512 device stage BF16_POLICY, in turns (median of 7 "
        f"after 1 warm-up): plain {stage_ms['plain']:.2f} ms, block-cached "
        f"period 2 {stage_ms['block_cached']:.2f} ms "
        f"({stage_ms['block_cached'] / stage_ms['plain']:.3f} of it), guidance "
        f"2.0 {stage_ms['guided']:.2f} ms "
        f"({stage_ms['guided'] / stage_ms['plain']:.3f}); all runs: "
        + "; ".join(f"{k} " + " ".join(f"{x:.1f}" for x in v)
                    for k, v in turns.items()))
    REPORT["modes"]["device_stage_ms"] = {"median": stage_ms, "runs": turns}

    # ---- 11. tiled decode ----
    from tpucdc_torch.parallel import (blend_tiles, make_tile_plan,
                                       split_tiles)
    t_mean = rt32.decompress_tiled(blob768, steps=0)
    worst, _ = lsb_gap(t_mean, mfx["tiled_mean_u8"])
    say("tiled", f"768x512, tile 256 halo 32, steps=0 F32_POLICY vs JAX: "
        f"max|diff| {worst} LSB (bound 1)")
    check(worst <= 1, "tiled mean decode differs from JAX")
    plan = make_tile_plan(ph7, pw7, tile=256, halo=32)
    e = plan.extent
    check(plan.num_tiles == 6 and e == 320, f"tile plan {plan}")
    tile_eps = torch.randn((6, e, e, 3), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    t_ref, n = counted(lambda: rt32.decompress_tiled(blob768, noise=tile_eps))
    want_n = decode_launches(cfg, serve_steps)
    y_hat7, _ = rt32.decode_latent(blob768)
    y_tiles = torch.from_numpy(split_tiles(y_hat7.cpu().numpy(), plan,
                                           scale=16)).to(dev)
    zero = torch.zeros((), device=dev)
    singly = torch.cat([rt32._device_stage(
        y_tiles[i:i + 1], zero, serve_steps, cfg.sample.eta, gamma7, e, e,
        noise=tile_eps[i:i + 1]) for i in range(6)])
    one_by_one = np.clip(blend_tiles(
        singly.cpu().numpy().astype(np.float32), plan) + 0.5, 0, 255).astype(
            np.uint8)[:hdr7.height, :hdr7.width]
    worst, within1 = lsb_gap(t_ref, one_by_one)
    say("tiled", f"refined tiled decode (6 tiles in one batch) vs the tiles "
        f"decoded one by one, same noise, F32_POLICY: max|diff| {worst} LSB "
        f"(bound 1), {100 * within1:.4f} % within 1, equal "
        f"{np.array_equal(t_ref, one_by_one)}; launches {n} "
        f"(derived {want_n})")
    check(worst <= 1, "batched tiles differ from tiles decoded alone")
    check(n == want_n == {"gn_silu": 93, "attention": 60},
          f"tiled decode launches {n}")
    path_launches["tiled_6"] = n

    big = seeded_image(1536, 2048, seed=11)
    big_blob, enc_ms = timed(lambda: rt16.compress(big))
    torch.cuda.reset_peak_memory_stats()
    whole, whole_ms = timed(lambda: rt16.decompress(big_blob, steps=0))
    whole_mem = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tmean, tmean_ms = timed(lambda: rt16.decompress_tiled(big_blob, steps=0))
    torch.cuda.reset_peak_memory_stats()
    (tiled, n), tiled_ms = timed(lambda: counted(
        lambda: rt16.decompress_tiled(big_blob)))
    tiled_mem = torch.cuda.max_memory_allocated()
    _, tiled_ms2 = timed(lambda: rt16.decompress_tiled(big_blob))
    # Where the tiled decode's time goes: the batched device stage against
    # the host's blend of the 48 fetched tiles (float64, numpy).
    big_plan = make_tile_plan(1536, 2048, tile=256, halo=32)
    big_y, big_hdr = rt16.decode_latent(big_blob)
    big_tiles = torch.from_numpy(split_tiles(big_y.cpu().numpy(), big_plan,
                                             scale=16)).to(dev)
    x48, stage48_ms = timed(lambda: rt16._device_stage(
        big_tiles, zero, serve_steps, cfg.sample.eta,
        rt16._header_gamma(big_hdr, serve_steps, grid=False), e, e))
    x48 = x48.cpu().numpy().astype(np.float32)
    t0 = time.perf_counter()
    blend_tiles(x48, big_plan)
    blend_ms = 1e3 * (time.perf_counter() - t0)
    psnr_tiles = psnr_db(tmean, whole)
    say("tiled", f"2048x1536 (seeded image, {len(big_blob)} B, compress "
        f"{enc_ms:.1f} ms) BF16_POLICY: decompress(steps=0) {whole_ms:.1f} "
        f"ms, peak {whole_mem / 2**20:.0f} MiB; decompress_tiled(steps=0) "
        f"{tmean_ms:.1f} ms, PSNR against the untiled mean decode "
        f"{psnr_tiles:.2f} dB (bound 30); decompress_tiled, 48 tiles in one "
        f"batch, {serve_steps} steps: {tiled_ms:.1f} ms then "
        f"{tiled_ms2:.1f} ms (of it the device stage of the 48 tiles "
        f"{stage48_ms:.1f} ms, the host's blend {blend_ms:.1f} ms, timed "
        f"apart), peak {tiled_mem / 2**20:.0f} MiB, launches {n}; "
        f"PSNR against the image: mean decode {psnr_db(whole, big):.2f} dB, "
        f"tiled refined {psnr_db(tiled, big):.2f} dB")
    check(tiled.shape == big.shape and tmean.shape == big.shape,
          "tiled decode has the wrong shape")
    check(psnr_tiles >= 30.0, "tiled mean decode is far from the untiled one")
    check(n == want_n, f"48-tile decode launches {n} != {want_n}")
    path_launches["tiled_48"] = n
    REPORT["tiled"] = {
        "bytes_2048x1536": len(big_blob), "compress_ms": enc_ms,
        "untiled_mean_ms": whole_ms, "untiled_mean_peak_bytes": whole_mem,
        "tiled_mean_ms": tmean_ms, "tiled_ms": [tiled_ms, tiled_ms2],
        "tiled_device_stage_ms": stage48_ms, "tiled_blend_ms": blend_ms,
        "tiled_peak_bytes": tiled_mem, "psnr_tiled_vs_untiled_mean": psnr_tiles,
        "psnr_mean_vs_image": psnr_db(whole, big),
        "psnr_tiled_vs_image": psnr_db(tiled, big)}

    # ---- 12. batch encode and decode ----
    def batch_round(name, rt, imgs, **enc):
        def draws():
            g = torch.Generator(dev).manual_seed(5)
            return [torch.randn((1, *codec_runtime.pad_image(im)[0].shape[:2],
                                 3), generator=g, device=dev) for im in imgs]
        rt.compress_many(imgs[:1], **enc)       # warm-up
        noise = draws()
        ms = collections.defaultdict(list)
        for rnd in range(4):
            # One by one and batched in turns, the order swapped each round.
            order = ("one", "many") if rnd % 2 == 0 else ("many", "one")
            for which in order:
                if which == "one":
                    singles, t = timed(lambda: [rt.compress(im, **enc)
                                                for im in imgs])
                    ms["compress"].append(t)
                    one, t = timed(lambda: [rt.decompress(b, noise=e)
                                            for b, e in zip(singles, noise)])
                    ms["decompress"].append(t)
                else:
                    many, t = timed(lambda: rt.compress_many(imgs, **enc))
                    ms["compress_many"].append(t)
                    (batch, n), t = timed(lambda: counted(
                        lambda: rt.decompress_many(many, noise=noise)))
                    ms["decompress_many"].append(t)
            check(many == singles, f"{name}: compress_many bytes differ")
            check(all(np.array_equal(a, b) for a, b in zip(batch, one)),
                  f"{name}: decompress_many pixels differ")
        med = {k: statistics.median(v[1:]) for k, v in ms.items()}
        say("batch", f"{name}, {len(imgs)} images BF16_POLICY: bytes and "
            f"pixels equal the one-by-one calls in each of 4 rounds; median "
            f"of rounds 2-4 (ms): " + ", ".join(
                f"{k} {v:.1f}" for k, v in med.items()) + "; all rounds: "
            + "; ".join(f"{k} " + " ".join(f"{x:.0f}" for x in v)
                        for k, v in ms.items()) + f"; launches {n}")
        want = {k: len(imgs) * v
                for k, v in decode_launches(rt.config, serve_steps).items()}
        check(n == want, f"{name}: decompress_many launches {n} != {want}")
        REPORT.setdefault("batch", {})[name] = {
            "images": len(imgs), "median_ms": med, "runs_ms": dict(ms)}
        return n

    path_launches["batch_4"] = batch_round(
        "flagship", rt16, [img768, img768[::-1].copy(), crop,
                           np.roll(img768, 97, axis=1)])
    path_launches["batch_3_vr"] = batch_round(
        "vr_wide", rtv16, [img768, crop, img768[:, ::-1].copy()], quality=1)

    # ---- 13. the large preset at full width ----
    from tpucdc_torch.sampling import (ddim_sample, make_batched_cfg_eps_fn,
                                       make_cfg_eps_fn)
    seeded = lambda: torch.Generator(dev).manual_seed(3)
    # The bitstream's header names the serving dial's 5 steps; the preset's
    # own step count is asked for.
    lsteps = lcfg.sample.steps
    (ddim_u8, n), ddim_ms = timed(lambda: counted(
        lambda: rtL.decompress(blob768, generator=seeded(), steps=lsteps)))
    want_n = decode_launches(lcfg, lsteps)
    ddim_again, ddim_ms2 = timed(lambda: rtL.decompress(
        blob768, generator=seeded(), steps=lsteps))
    say("large", f"presets.flagship() 768x512 BF16_POLICY, DDIM-{lsteps}: "
        f"{ddim_ms:.0f} ms then {ddim_ms2:.0f} ms "
        f"({ddim_ms2 / lsteps:.2f} ms a step); launches {n} (derived "
        f"{want_n}); repeatable {np.array_equal(ddim_u8, ddim_again)}")
    check(n == want_n == {"gn_silu": 2303, "attention": 2200},
          f"large DDIM launches {n} != {want_n}")
    check(ddim_u8.shape == img768.shape and ddim_u8.dtype == np.uint8
          and np.array_equal(ddim_u8, ddim_again), "large DDIM decode")
    check(0 < ddim_u8.std(), "large DDIM decode is constant")
    path_launches["large_ddim"] = n

    rtP = with_sample(rtL, port.BF16_POLICY, sampler="ddpm")
    T = lcfg.model.schedule.num_steps
    (ddpm_u8, n), ddpm_ms = timed(lambda: counted(
        lambda: rtP.decompress(blob768, generator=seeded())))
    want_n = decode_launches(lcfg, T)
    ddpm_again = rtP.decompress(blob768, generator=seeded())
    say("large", f"DDPM over all {T} steps: {ddpm_ms:.0f} ms "
        f"({ddpm_ms / T:.2f} ms a step); launches {n} (derived {want_n}); "
        f"repeatable {np.array_equal(ddpm_u8, ddpm_again)}")
    check(n == want_n, f"large DDPM launches {n} != {want_n}")
    check(ddpm_u8.shape == img768.shape and 0 < ddpm_u8.std()
          and np.array_equal(ddpm_u8, ddpm_again), "large DDPM decode")
    path_launches["large_ddpm"] = n

    # Guidance: the batch-doubled net call against the two-call form. The
    # weights are random and the preset's chain starts at t = T-1, where one
    # DDIM update multiplies an error in ε̂ by sqrt(1-ᾱ)/sqrt(ᾱ) ≈ 2·10⁴: over
    # 10 steps bf16's rounding (which differs between batch 1 and batch 2)
    # grows beyond any bound worth stating, so that chain is gated in f32 and
    # only printed in bf16. What gates bf16 is one net call, and one whole
    # decode of two steps from t_start = 0.15·(T-1) (t = 150, then 0), where
    # the updates do not amplify: its pixels may differ from the two-call
    # chain's by twice what the first net call's measured error gives
    # through the first update (the second, at t = 0, weighs ε̂ by 0.006),
    # plus 2 LSB.
    gsteps = 10
    shape7 = (1, ph7, pw7, 3)
    x_t = torch.randn(shape7, generator=seeded(), device=dev)
    t_vec = torch.full((1,), 500, dtype=torch.int32, device=dev)
    rtL32 = port.CodecRuntime(lcfg, copy.deepcopy(lmodel), device=dev,
                              policy=port.F32_POLICY)
    guided = {}

    gamma_l = float(np.float32(rtL._header_gamma(hdr7, gsteps, grid=False)))

    def crop7(x0, x_bar):
        """The chain's x₀ as the device stage finishes it: γ blend, uint8."""
        x = x_bar + gamma_l * (x0 - x_bar)
        return codec_runtime._to_uint8(x).cpu().numpy()[0][
            :hdr7.height, :hdr7.width]

    with torch.inference_mode():
        for name, rt in (("bf16", rtL), ("f32", rtL32)):
            net = rt.model
            _, y_l, mu_l, _ = rt._decode_symbols(blob768)
            y_hat_l = y_l.to(torch.float32) + mu_l
            cf, ct = net.cond_signal(y_hat_l)
            x_bar = net.synthesize(y_hat_l)
            two_call = make_cfg_eps_fn(
                lambda x, t: net.denoise(x, t, cf, ct, x_bar),
                lambda x, t: net.denoise(x, t, torch.zeros_like(cf),
                                         torch.zeros_like(ct),
                                         torch.zeros_like(x_bar)), 2.0)
            cf2, ct2, xb2 = (torch.cat([a, torch.zeros_like(a)])
                             for a in (cf, ct, x_bar))
            doubled = make_batched_cfg_eps_fn(
                lambda x, t: net.denoise(x, t, cf2, ct2, xb2), 2.0)
            ref_eps = two_call(x_t, t_vec)
            err = (doubled(x_t, t_vec) - ref_eps).abs().max().item()
            ref_max = ref_eps.abs().max().item()
            (g_u8, n), g_ms = timed(lambda: counted(lambda: rt.decompress(
                blob768, generator=seeded(), guidance=2.0, steps=gsteps)))
            g_again = rt.decompress(blob768, generator=seeded(), guidance=2.0,
                                    steps=gsteps)
            x0 = ddim_sample(two_call, rt.schedule, shape7,
                             generator=seeded(), device=dev, x_ref=x_bar,
                             tables=rt._decode_tables(gsteps, 0.0))
            two_u8 = crop7(x0, x_bar)
            # Two steps from the truncated start.
            rt1 = with_sample(rt, rt.policy, truncate_frac=0.15)
            tab1 = rt1._decode_tables(2, 0.0)
            sa, c1 = (float(tab1[k][0])
                      for k in ("sqrt_ab", "sqrt_one_minus_ab"))
            t_1 = torch.full((1,), int(tab1["t"][0]), dtype=torch.int32,
                             device=dev)
            x_1 = sa * x_bar.to(torch.float32) + c1 * x_t   # the chain's start
            ref_1 = two_call(x_1, t_1)
            err_1 = (doubled(x_1, t_1) - ref_1).abs().max().item()
            one_u8 = rt1.decompress(blob768, generator=seeded(), guidance=2.0,
                                    steps=2)
            two_1 = crop7(ddim_sample(two_call, rt.schedule, shape7,
                                      generator=seeded(), device=dev,
                                      x_ref=x_bar, tables=tab1), x_bar)
            guided[name] = {
                "net_call_max_err": err, "net_call_max_ref": ref_max,
                "ms": g_ms, "launches": n, "steps": gsteps,
                "repeatable": bool(np.array_equal(g_u8, g_again)),
                "vs_two_call_psnr_db": psnr_db(g_u8, two_u8),
                "vs_two_call_max_lsb": lsb_gap(g_u8, two_u8)[0],
                "short_t": int(tab1["t"][0]),
                "short_net_call_max_err": err_1,
                "short_net_call_max_ref": ref_1.abs().max().item(),
                "short_max_lsb": lsb_gap(one_u8, two_1)[0],
                "short_psnr_db": psnr_db(one_u8, two_1),
                "short_lsb_bound": 2 * 127.5 * gamma_l * c1 / sa * err_1 + 2}
    rel = {"bf16": ATTN_BF16_REL, "f32": 1e-4}
    for name, g in guided.items():
        say("large", f"guidance 2.0 {name}: one net call, batch-doubled vs two "
            f"calls: max|err| {g['net_call_max_err']:.3g} (max|ref| "
            f"{g['net_call_max_ref']:.3g}); DDIM-{gsteps}: {g['ms']:.0f} ms, "
            f"launches {g['launches']}, repeatable {g['repeatable']}; against "
            f"the two-call chain PSNR {g['vs_two_call_psnr_db']:.2f} dB, "
            f"max|diff| {g['vs_two_call_max_lsb']} LSB")
        say("large", f"guidance 2.0 {name}, two steps from t = "
            f"{g['short_t']}: net call max|err| "
            f"{g['short_net_call_max_err']:.3g} (bound {rel[name]:g} of "
            f"max|ref| {g['short_net_call_max_ref']:.3g}); decode against "
            f"the two-call chain max|diff| {g['short_max_lsb']} LSB (bound "
            f"{g['short_lsb_bound']:.1f}: twice that error through the first "
            f"update, plus 2), "
            f"PSNR {g['short_psnr_db']:.2f} dB")
        check(g["launches"] == decode_launches(lcfg, gsteps)
              and g["repeatable"], f"guided decode of the large preset {name}")
        check(g["net_call_max_err"] <= rel[name] * g["net_call_max_ref"]
              and g["short_net_call_max_err"]
              <= rel[name] * g["short_net_call_max_ref"],
              f"batch-doubled guidance differs from two calls ({name})")
        check(g["short_max_lsb"] <= g["short_lsb_bound"],
              f"two-step guided decode differs from the two-call chain "
              f"({name})")
    say("large", f"bounds: net call bf16 {ATTN_BF16_REL:g} max|ref|, f32 1e-4 "
        f"max|ref|; two-step decode as printed; 10-step chain f32 PSNR 40 dB, "
        f"bf16 printed only: on drawn weights the bf16 pixels of this preset "
        f"carry launch counts, times and repeatability, nothing else")
    check(guided["f32"]["vs_two_call_psnr_db"] >= 40.0,
          "guided f32 chain differs from the two-call chain")
    n = guided["bf16"]["launches"]
    path_launches["large_guided"] = n
    REPORT["large"] = {"ddim_ms": [ddim_ms, ddim_ms2], "ddim_steps": lsteps,
                       "ddpm_ms": ddpm_ms, "ddpm_steps": T,
                       "guided": guided}
    REPORT["path_launches"] = path_launches

    # ---- 14. eval & API ----
    phase_eval_api(torch, dev, port, cfg, rt16, blob768, img768, fx,
                   path_launches)

    # ---- 15. train ----
    trained = phase_train(torch, dev, port, state, img768, discover,
                          device_us, rt16, rtv16,
                          REPORT["eval_api"]["cli"]["vr_target_bpp"])
    path_launches["train_step"] = trained

    # ---- 16. mesh ----
    path_launches.update(phase_mesh(torch, dev, port, rt16, big_blob,
                                    img768))

    kernels = []
    for name in ("gn_silu", "attention"):
        p = per[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_compress_spatial": enc_launches[name],
            **{f"launches_{path}": n[name]
               for path, n in path_launches.items()},
            "max_abs_err": errs[name], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": ("bytes" if p["bytes_ms"] >= p["ops_ms"]
                         else "operations"),
            "library_ms": p["library_ms"],
            **{f"dit_decode_{k}": per_dit[name][k]
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            **({"dit_decode_sm90_launches": dit_sm90}
               if name == "attention" else {})})
    REPORT["kernels"] = kernels
    REPORT["device_ms"] = {name: per[name]["device_ms"] for name in per}
    REPORT["dit_decode_device_ms"] = {name: per_dit[name]["device_ms"]
                                      for name in per_dit}
    REPORT["shapes"] = shape_rows
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1))

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase_eval_api(torch, dev, port, cfg, rt16, blob768, img768, fx,
                   path_launches, n_images=24) -> None:
    """Phase 14: the metrics once more, now that runtimes exist; the API
    against the runtimes of phase 6; the eval harness over the Kodak set
    with its launch counts; the CLI in-process against the direct calls."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    from tpucdc_torch import api
    from tpucdc_torch.cli import main as cli
    from tpucdc_torch.data import eval_dataset
    from tpucdc_torch.ops import _kernels
    from tpucdc_torch.pipelines.evaluate import (EvalOptions,
                                                 evaluate_dataset,
                                                 step_guidance_sweep,
                                                 time_decode)
    from tpucdc_torch.presets import SERVING_OVERRIDES, VR_WIDE_OVERRIDES

    def seeded(seed=0):
        return torch.Generator(dev).manual_seed(seed)

    t_phase = time.perf_counter()
    card = card_line()
    rep = REPORT["eval_api"] = {}
    # (a) the metrics after the runtimes, against JAX's fixture values.
    before = REPORT["eval_metrics_before_runtime"]
    after = eval_metrics_check(torch, dev)
    rep["metrics_after_runtime"] = after
    say("eval", f"metrics vs JAX's fixture, before any runtime (cudnn TF32 "
        f"flag {before['cudnn_allow_tf32']}) and after (flag "
        f"{after['cudnn_allow_tf32']}): " + "; ".join(
            f"{k} {before[k]:.6f} / {after[k]:.6f}" for k in before
            if k != "cudnn_allow_tf32"))
    say("eval", f"bounds: PSNR {EVAL_BOUNDS['psnr']:g} dB, MS-SSIM and GMSD "
        f"{EVAL_BOUNDS['ms_ssim']:g} absolute, LPIPS and the features "
        f"{EVAL_REL:g} relative")

    # (b) the API: the trained flagship through load_runtime.
    rt = api.load_runtime("flagship", checkpoint=str(WEIGHTS),
                          overrides=SERVING_OVERRIDES)
    check(rt.config.model == cfg.model and rt.config.sample == cfg.sample,
          "load_runtime(SERVING_OVERRIDES) is not flagship_serving()")
    api_u8 = rt.decompress(blob768, generator=seeded())
    ref_u8 = rt16.decompress(blob768, generator=seeded())
    check(np.array_equal(api_u8, ref_u8),
          f"API decode differs from the runtime's: {lsb_gap(api_u8, ref_u8)}")
    tables = {p: {k: fx[f"{p}_{k}"] for k in ("cdfs", "cdf_lengths",
                                               "offsets")} for p in "zy"}
    rt_tab = port.CodecRuntime(rt.config, rt.model, device=dev,
                               cdf_tables=tables)
    exported = rt_tab.export_cdf_tables()
    check(all(np.array_equal(exported[f"{p}_{k}"], v)
              for p, t in tables.items() for k, v in t.items()),
          "export_cdf_tables differs from the tables it was given")
    blob = fx["blob"].tobytes()
    _, z_sym, _, _ = rt_tab._host_z_stage(blob)
    _, y_sym, _, _ = rt_tab._decode_symbols(blob)
    same = (np.array_equal(z_sym, fx["z_sym"])
            and np.array_equal(y_sym.cpu().numpy(), fx["y_sym"]))
    check(same, "the runtime on JAX's coder tables decodes other symbols")
    say("api", "load_runtime('flagship', artifacts/flagship_params.npz, "
        "SERVING_OVERRIDES) = flagship_serving(); its decode of "
        "flagship_768x512.tpucdc (seed 0) is bit-equal to the runtime's; on "
        "JAX's exported coder tables (cdf_tables=) it decodes JAX's 384x512 "
        "bitstream to JAX's symbols")

    # (c) the harness: the Kodak set at full width, with LPIPS.
    ds = eval_dataset("kodak")
    ds.images = ds.images[:n_images]
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = evaluate_dataset(rt, ds, EvalOptions(steps=5))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    n = dict(_kernels.LAUNCHES)
    want = {k: n_images * v for k, v in decode_launches(cfg, 5).items()}
    agg = res["aggregate"]
    say("eval", f"evaluate_dataset kodak ({len(ds)} images "
        f"{ds.images[0].shape[1]}x{ds.images[0].shape[0]}, synthetic "
        f"{ds.synthetic}, steps 5, LPIPS): {eval_s:.2f} s, launches {n} "
        f"(want {want}); aggregate {json.dumps(agg)}")
    check(n == want, f"eval launches {n} != {want}")
    check(all(np.isfinite(agg[k]) for k in ("bpp", "psnr", "ms_ssim",
                                            "gmsd", "lpips")),
          f"non-finite aggregate {agg}")
    per = {k: [r[k] for r in res["rows"]] for k in ("encode_s", "decode_s")}
    rep["eval"] = {"aggregate": agg, "seconds": eval_s, "launches": n,
                   "images": len(ds), "synthetic": ds.synthetic,
                   "encode_s": per["encode_s"], "decode_s": per["decode_s"]}
    say("eval", "harness decode_s per image (ms): median "
        f"{1e3 * statistics.median(per['decode_s']):.2f}, min "
        f"{1e3 * min(per['decode_s']):.2f}, max "
        f"{1e3 * max(per['decode_s']):.2f}; encode_s median "
        f"{1e3 * statistics.median(per['encode_s']):.2f}; whole eval "
        f"{1e3 * eval_s / len(ds):.2f} ms an image ({card})")
    path_launches["eval_kodak"] = n

    # The metrics of one 512x768 pair apart: host ms a call (median of 7
    # after a warm-up; each returns a float, so the card has finished), and
    # the LPIPS proxy's device time (profiler) against its bound.
    from tpucdc_torch.eval import PerceptualMetric, gmsd, ms_ssim, psnr
    from tpucdc_torch.eval.fid import _FeatureExtractor
    img0 = ds.images[0]
    rec0 = rt.decompress(rt.compress(img0))
    lpips, feats = PerceptualMetric(device=dev), _FeatureExtractor(device=dev)
    calls = {"psnr": lambda: psnr(img0, rec0, device=dev),
             "ms_ssim": lambda: ms_ssim(img0, rec0, device=dev),
             "gmsd": lambda: gmsd(img0, rec0, device=dev),
             "lpips": lambda: lpips(img0, rec0),
             "fid_features": lambda: feats(img0[None])}
    metric_ms = {}
    for name, fn in calls.items():
        fn()
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        metric_ms[name] = statistics.median(times)
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            calls["lpips"]()
        torch.cuda.synchronize()
    lpips_dev = sum(float(e.self_device_time_total)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 5e3
    h, w = img0.shape[:2]
    flops, cin = 0, 3
    for i, cout in enumerate((64, 128, 256, 512, 512)):
        flops += 2 * 2 * 9 * cin * cout * (h >> i) * (w >> i)   # two images
        cin = cout
    lpips_bound = 1e3 * flops / PEAK_FLOPS["f32"]
    say("eval", f"one {w}x{h} pair, host ms a call (median of 7): " + ", ".join(
        f"{k} {v:.3f}" for k, v in metric_ms.items()) + f"; LPIPS device "
        f"{lpips_dev:.3f} ms against its bound {lpips_bound:.3f} ms "
        f"({flops:.3g} FLOP in f32 without TF32) ({card})")
    rep["metric_ms"] = metric_ms
    rep["lpips_device_ms"] = lpips_dev
    rep["lpips_bound_ms"] = lpips_bound

    two = dataclasses.replace(ds, images=ds.images[:2])
    t0 = time.perf_counter()
    sweep = step_guidance_sweep(rt, two, (2, 5), (1.0, 2.0),
                                EvalOptions(compute_lpips=False))
    sweep_s = time.perf_counter() - t0
    for row in sweep:
        check(np.isfinite(row["fid"]), f"non-finite FID {row}")
        say("eval", f"step/guidance sweep steps {row['steps']} guidance "
            f"{row['guidance']}: PSNR {row['psnr']:.3f}, MS-SSIM "
            f"{row['ms_ssim']:.5f}, GMSD {row['gmsd']:.5f}, FID "
            f"{row['fid']:.4f} ({row['fid_features']})")
    timing = time_decode(rt, rt.compress(ds.images[0]), steps=5)
    say("eval", f"sweep of 4 points x 2 images: {sweep_s:.2f} s; "
        f"time_decode steps 5: median {1e3 * timing['decode_s_median']:.2f} "
        f"ms, best {1e3 * timing['decode_s_best']:.2f} ms ({card})")
    rep["sweep"] = sweep
    rep["time_decode"] = timing

    # (d) the CLI, in-process, on the trained flagship.
    try:
        import PIL  # noqa: F401
        pillow = True
    except ImportError:
        pillow = False
    say("cli", f"Pillow imports on this machine: {pillow}")
    if not pillow:
        say("cli", "no Pillow: the CLI's two image-I/O helpers read and "
            "write .npy here (in-process); the runtime, weights and kernels "
            "are the same")
        cli._read_image = lambda path: np.load(path)
        cli._write_image = lambda path, img: np.save(path, img)
    sets = [f"--set={k}={v}" for k, v in SERVING_OVERRIDES.items()]
    flag = ["--preset", "flagship", *sets, "--checkpoint", str(WEIGHTS)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        src = tmp / ("img.png" if pillow else "img.npy")
        dst = tmp / ("out.png" if pillow else "out.npy")
        if pillow:
            from PIL import Image
            Image.fromarray(img768).save(src)
        else:
            np.save(src, img768)
        t0 = time.perf_counter()
        cli.main(["compress", "--optimize-gamma", "spatial", *flag,
                  str(src), str(tmp / "img.tpucdc")])
        cli_blob = (tmp / "img.tpucdc").read_bytes()
        direct = rt.compress(img768, optimize_gamma="spatial")
        check(cli_blob == direct, "CLI compress bytes differ from "
              "rt.compress(optimize_gamma='spatial')")
        cli.main(["decompress", "--seed", "0", *flag,
                  str(tmp / "img.tpucdc"), str(dst)])
        cli_u8 = cli._read_image(dst)
        want_u8 = rt.decompress(direct, generator=seeded())
        check(np.array_equal(cli_u8, want_u8),
              f"CLI decompress differs: {lsb_gap(cli_u8, want_u8)}")
        cli.main(["eval", "--sweep", "latency", *flag,
                  "--workdir", str(tmp / "eval")])
        vr_flag = ["--preset", "flagship", *sets,
                   *[f"--set={k}={v}" for k, v in VR_WIDE_OVERRIDES.items()],
                   "--checkpoint", str(VR_WEIGHTS)]
        rtv = api.load_runtime("flagship", checkpoint=str(VR_WEIGHTS),
                               overrides={**SERVING_OVERRIDES,
                                          **VR_WIDE_OVERRIDES})
        npix = img768.shape[0] * img768.shape[1]
        ends = [8 * len(rtv.compress(img768, quality=q)) / npix
                for q in (0.0, 2.0)]
        target = float(np.sqrt(ends[0] * ends[1]))
        blob_d, q_d, bpp_d = rtv.compress_to_bpp(img768, target)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["compress", "--target-bpp", f"{target!r}", *vr_flag,
                      str(src), str(tmp / "vr.tpucdc")])
        row = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(buf.getvalue().strip())
        vr_blob = (tmp / "vr.tpucdc").read_bytes()
        say("cli", f"vr_wide --target-bpp {target:.4f} (between q0 "
            f"{ends[0]:.4f} and q2 {ends[1]:.4f}): bpp {row['bpp']:.4f} at "
            f"quality {row['quality']:.4f}; direct compress_to_bpp "
            f"{bpp_d:.4f} at {q_d:.4f}")
        check(abs(row["bpp"] - target) <= 0.03 * target,
              f"rate control missed: {row['bpp']} for {target}")
        check(vr_blob == blob_d, "CLI --target-bpp bytes differ from "
              "compress_to_bpp")
        cli_s = time.perf_counter() - t0
    say("cli", f"compress --optimize-gamma spatial: {len(cli_blob)} B = "
        f"rt.compress; decompress --seed 0 = rt.decompress; eval --sweep "
        f"latency ran; {cli_s:.1f} s for the CLI part ({card})")
    rep["cli"] = {"pillow": pillow, "bytes": len(cli_blob),
                  "vr_target_bpp": target, "vr_row": row, "seconds": cli_s}
    rep["seconds"] = time.perf_counter() - t_phase
    say("eval", f"phase 14 took {rep['seconds']:.1f} s ({card})")


def _rel(got, want) -> float:
    """‖got − want‖ / ‖want‖ in f64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def phase_train(torch, dev, port, state, img768, discover, device_us,
                rt16, rtv16, vr_target) -> dict:
    """Phase 15: the training path (see the module docstring). Returns
    the launches of one recipe step, by kernel."""
    import tempfile

    import numpy as np
    import torch.nn.functional as F
    from tpucdc_torch import api
    from tpucdc_torch.cli import main as cli
    from tpucdc_torch.data import kodak, train_crop_iterator
    from tpucdc_torch.eval.lpips import PerceptualMetric
    from tpucdc_torch.ops import _kernels
    from tpucdc_torch.pipelines import codec_runtime, train
    from tpucdc_torch.presets import SERVING_OVERRIDES
    from tpucdc_torch.runtime import pin_numerics, set_policy
    from tpucdc_torch.utils.checkpoint import CheckpointManager
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    attn_mod = importlib.import_module("tpucdc_torch.ops.attention")
    groupnorm = importlib.import_module("tpucdc_torch.ops.groupnorm")

    t_phase = time.perf_counter()
    card = card_line()
    rep = REPORT["train"] = {}
    times = rep["seconds_by_part"] = {}
    recipe = {**SERVING_OVERRIDES, **RECIPE}
    rcfg = api.build_config("flagship", recipe)
    tc = rcfg.train
    gen = torch.Generator(dev).manual_seed(5)

    # One recipe step on a fresh initialisation (BF16_POLICY, as JAX
    # trains), with its launches counted: (c), and the shapes for (a).
    step_fn = train.make_train_step(rcfg, train.schedule_tables(rcfg, dev))

    def recipe_step(state_, batch_u8, seed):
        return step_fn(state_, batch_u8,
                       torch.Generator(dev).manual_seed(seed))

    pin_numerics()
    _, rstate = train.create_state(rcfg, seed=0, device=dev)
    data_imgs = kodak().images
    batch16 = torch.from_numpy(next(train_crop_iterator(
        data_imgs, tc.batch_size, tc.crop_size, as_uint8=True))).to(dev)
    recipe_step(rstate, batch16, 0)                 # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launches()
    recipe_step(rstate, batch16, 1)
    torch.cuda.synchronize()
    step_launches = dict(_kernels.LAUNCHES)
    want = decode_launches(rcfg, 1)
    say("train", f"one recipe train step (batch {tc.batch_size}, crop "
        f"{tc.crop_size}, BF16_POLICY): launches {step_launches} (derived "
        f"{want}: the forward's; the backward launches no kernel)")
    check(step_launches == want == {"gn_silu": 21, "attention": 12},
          f"train step launches {step_launches} != {want}")
    rep["step_launches"] = step_launches

    # (a) kernel gradients at every shape of a recipe step and of the
    # fixture's batch 2, on head views where the block makes them; batch 1.
    seen = discover(lambda: recipe_step(rstate, batch16, 2))
    seen2 = discover(lambda: recipe_step(rstate, batch16[:2], 3))
    gn_shapes = sorted(set(seen["gn_silu"]) | set(seen2["gn_silu"]))
    gn_shapes += [((1,) + s[1:], g) for s, g in gn_shapes if s[0] != 1]
    at_shapes = sorted(set(seen["attention"]) | set(seen2["attention"]))
    at_shapes += [((1,) + q[1:], (1,) + k[1:], v) for q, k, v in at_shapes
                  if q[0] != 1]
    worst = {"gn_silu": {}, "attention": {}}
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for dn, dt in dtypes.items():
        for shape, groups in dict.fromkeys(gn_shapes):
            x = torch.randn(shape, generator=gen, device=dev).to(dt)
            g = torch.randn(shape[-1], generator=gen, device=dev)
            b = torch.randn(shape[-1], generator=gen, device=dev)
            x.requires_grad_(True), g.requires_grad_(True)
            b.requires_grad_(True)
            out = groupnorm.group_norm_silu(x, g, b, groups)
            check(out.grad_fn is not None, "GN+SiLU output has no grad_fn")
            dout = torch.randn(shape, generator=gen, device=dev).to(dt)
            got = torch.autograd.grad(out, (x, g, b), dout)
            ref = torch.autograd.grad(groupnorm.gn_reference(
                x, g, b, groups, 1e-5, True), (x, g, b), dout)
            err = max(_rel(a, r) for a, r in zip(got, ref))
            worst["gn_silu"][dn] = max(worst["gn_silu"].get(dn, 0.0), err)
            check(err <= GRAD_TOL[dn],
                  f"GN+SiLU gradient {shape}/{groups} {dn}: {err}")
        for qs, ks, views in dict.fromkeys(at_shapes):
            def make(shp):
                b_, h_, n_, d_ = shp
                if views:
                    t = torch.randn((b_, n_, h_ * d_), generator=gen,
                                    device=dev).to(dt).requires_grad_(True)
                    return t, t.reshape(b_, n_, h_, d_).transpose(1, 2)
                t = torch.randn(shp, generator=gen, device=dev).to(dt)
                return t.requires_grad_(True), t
            (q0, q), (k0, k), (v0, v) = make(qs), make(ks), make(ks)
            out = attn_mod.attention(q, k, v)
            check(out.grad_fn is not None, "attention output has no grad_fn")
            dout = torch.randn(out.shape, generator=gen, device=dev).to(dt)
            got = torch.autograd.grad(out, (q0, k0, v0), dout)
            ref = torch.autograd.grad(attn_mod.attention_reference(q, k, v),
                                      (q0, k0, v0), dout)
            err = max(_rel(a, r) for a, r in zip(got, ref))
            worst["attention"][dn] = max(worst["attention"].get(dn, 0.0),
                                         err)
            check(err <= GRAD_TOL[dn],
                  f"attention gradient {qs} {ks} {dn}: {err}")
    say("train", f"kernel gradients vs autograd of the plain versions at "
        f"{len(set(gn_shapes))} GN+SiLU and {len(set(at_shapes))} attention "
        f"shapes (recipe batch 16, fixture batch 2, batch 1; head views as "
        f"the block makes them), worst relative 2-norm {worst} (bounds "
        f"{GRAD_TOL})")
    rep["grad_worst"] = worst
    times["c_a_launches_gradients"] = time.perf_counter() - t_phase
    t_part = time.perf_counter()
    rep["grad_shapes"] = {"gn_silu": [list(s) + [g] for s, g in gn_shapes],
                          "attention": [[list(q), list(k), v]
                                        for q, k, v in at_shapes]}

    # Forward and backward device time a step, at the recipe's shapes
    # (bf16), beside the bounds and autograd through the library calls. One
    # profiler session a row runs every shape as often as a step does.
    def device_ms(calls):
        """``device_us`` of every kernel one pass over ``calls`` launches,
        in ms. The profiler has come back empty once in many sessions (a
        lost CUPTI buffer): one empty reading is taken again, a second one
        fails."""
        def run():
            for fn in calls:
                fn()
        try:
            return 1e-3 * device_us(run, None, iters=5)
        except AssertionError:
            say("train", "the profiler saw no kernel; measuring again")
            return 1e-3 * device_us(run, None, iters=5)

    calls = {"gn_silu": collections.defaultdict(list),
             "attention": collections.defaultdict(list)}
    bound_ms = collections.Counter()
    for (shape, groups), n in seen["gn_silu"].items():
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(shape[-1], generator=gen, device=dev)
        b = torch.randn(shape[-1], generator=gen, device=dev)
        dout = torch.randn_like(x)
        xn = x.reshape(shape[0], -1, shape[-1]).transpose(1, 2).contiguous()
        xn.requires_grad_(True)
        gl, bl = g.clone().requires_grad_(True), b.clone().requires_grad_(True)
        lib = F.silu(F.group_norm(xn, groups, gl.to(x.dtype), bl.to(x.dtype),
                                  1e-5))
        row = calls["gn_silu"]
        row["fwd_ms"] += [functools.partial(
            groupnorm.gn_silu_cuda, x, g, b, groups)] * n
        row["bwd_ms"] += [functools.partial(
            groupnorm.gn_silu_backward, dout, x, g, b, groups, 1e-5)] * n
        row["bwd_library_ms"] += [functools.partial(
            torch.autograd.grad, lib, (xn, gl, bl), torch.randn_like(lib),
            retain_graph=True)] * n
        # dx from x and dout, dγ and dβ: each byte once.
        bound_ms["gn_silu"] += n * 1e3 * (
            3 * x.numel() * 2 + 4 * shape[-1] * 4) / HBM_BYTES_S
    for (qs, ks, views), n in seen["attention"].items():
        b_, h_, nq, d = qs
        nk = ks[2]
        q, k, v = (torch.randn(s_, generator=gen, device=dev).to(
            torch.bfloat16) for s_ in (qs, ks, ks))
        dout = torch.randn_like(q)
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
        lib = F.scaled_dot_product_attention(ql, kl, vl)
        row = calls["attention"]
        row["fwd_ms"] += [functools.partial(
            attn_mod.attention_cuda, q, k, v, d ** -0.5)] * n
        row["bwd_ms"] += [functools.partial(
            attn_mod.attention_backward, dout, q, k, v, d ** -0.5)] * n
        row["bwd_library_ms"] += [functools.partial(
            torch.autograd.grad, lib, (ql, kl, vl), dout,
            retain_graph=True)] * n
        flops = 10 * b_ * h_ * nq * nk * d
        nbytes = (4 * q.numel() + 3 * k.numel()) * 2
        bound_ms["attention"] += n * 1e3 * max(flops / PEAK_FLOPS["bf16"],
                                               nbytes / HBM_BYTES_S)
    per_step = {name: {**{key: device_ms(fns) for key, fns in rows.items()},
                       "bwd_bound_ms": bound_ms[name]}
                for name, rows in calls.items()}
    del calls
    times["kernel_ms"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    for name, row in per_step.items():
        say("train", f"{name} a recipe step ({step_launches[name]} launches, "
            f"bf16, device ms): forward {row['fwd_ms']:.4f}, backward "
            f"{row['bwd_ms']:.4f} (bound {row['bwd_bound_ms']:.4f}, autograd "
            f"through the library call {row['bwd_library_ms']:.4f}) ({card})")
    rep["kernel_ms_per_step"] = {k_: dict(v_) for k_, v_ in per_step.items()}

    # (b) the trained flagship against JAX's training-step fixture.
    fx = np.load(FIXTURES / "flagship_train_step.npz")
    fmodel = port.CDCModel(rcfg.model)
    fmodel.load_state_dict(state, strict=True)
    fmodel.to(dev)
    set_policy(fmodel, port.F32_POLICY)
    pin_numerics()
    draws = {k[5:]: torch.from_numpy(fx[k]).to(dev) for k in fx.files
             if k.startswith("draw_")}
    fbatch = torch.from_numpy(fx["batch_u8"]).to(dev).to(torch.float32) \
        * (1.0 / 127.5) - 1.0
    loss, metrics = train.loss_fn(
        fmodel, fbatch, train.schedule_tables(rcfg, dev), tc.rd_lambda,
        distortion=tc.distortion, lpips_weight=tc.lpips_weight,
        lpips_fn=PerceptualMetric(device=dev).distance, draws=draws)
    loss.backward()
    metric_err = {}
    for key in (k[7:] for k in fx.files if k.startswith("metric_")):
        want_v = float(fx[f"metric_{key}"])
        metric_err[key] = abs(float(metrics[key].detach()) - want_v) / abs(
            want_v)
    check(set(metric_err) == set(metrics), "metric keys differ from JAX's")
    grads = {n: p.grad for n, p in fmodel.named_parameters()}
    norm_ratio, full_ratio = [], []
    for n, want_norm in zip(fx["grad_names"], fx["grad_norms"]):
        got_norm = float(grads[str(n)].double().norm())
        norm_ratio.append((abs(got_norm - want_norm)
                           / (TRAIN_GRAD_REL * want_norm + TRAIN_GRAD_ABS),
                           str(n)))
    for key in (k for k in fx.files if k.startswith("grad__")):
        want_g = torch.from_numpy(fx[key]).to(dev).double()
        got_g = grads[key[6:]].double()
        full_ratio.append((float((got_g - want_g).norm()) / (
            TRAIN_GRAD_REL * float(want_g.norm()) + TRAIN_GRAD_ABS), key[6:]))
    worst_norm, worst_full = max(norm_ratio), max(full_ratio)
    say("train", f"flagship training step vs JAX's fixture (F32_POLICY, TF32 "
        f"off, batch 2, crop 192, JAX's draws): loss "
        f"{float(loss.detach()):.6f} (JAX {float(fx['metric_loss']):.6f}); "
        f"largest metric error {max(metric_err.values()):.3g} relative "
        f"({max(metric_err, key=metric_err.get)}; bound "
        f"{TRAIN_METRIC_REL:g}); gradient norms of {len(norm_ratio)} "
        f"parameters, worst at {worst_norm[0]:.3g} of the bound "
        f"({worst_norm[1]}); {len(full_ratio)} full gradients, worst at "
        f"{worst_full[0]:.3g} of the bound ({worst_full[1]}); bound "
        f"{TRAIN_GRAD_REL:g}·‖g_JAX‖ + {TRAIN_GRAD_ABS:g}")
    check(max(metric_err.values()) <= TRAIN_METRIC_REL,
          f"training metrics differ from JAX's: {metric_err}")
    check(worst_norm[0] <= 1 and worst_full[0] <= 1,
          f"gradients differ from JAX's: {worst_norm} {worst_full}")
    rep["fixture"] = {"metric_rel_err": metric_err,
                      "grad_norm_worst": worst_norm,
                      "grad_full_worst": worst_full}
    del fmodel, grads, loss, metrics
    times["b_fixture"] = time.perf_counter() - t_part

    # (d) the recipe through the CLI, in-process, from a fresh init.
    t_d = time.perf_counter()
    k = tc.steps_per_dispatch
    n_steps = RECIPE_CHUNKS * k
    run_overrides = {**recipe, "train.warmup_steps": str(2 * k),
                     "train.steps": str(n_steps), "train.log_every": "1",
                     "train.checkpoint_every": str(n_steps // 2)}
    run_cfg = api.build_config("flagship", run_overrides)
    sets = [f"--set={key}={val}" for key, val in run_overrides.items()]
    lpips_fn = PerceptualMetric(device=dev).distance
    tables = train.schedule_tables(run_cfg, dev)
    fixed = torch.from_numpy(next(train_crop_iterator(
        data_imgs, tc.batch_size, tc.crop_size, seed=99))).to(dev)

    def main_loss(model) -> float:
        """The loss less its aux term (rate and weighted distortion) on a
        fixed batch with fixed draws, without gradients."""
        with torch.no_grad():
            loss, m = train.loss_fn(
                model, fixed, tables, run_cfg.train.rd_lambda,
                distortion=run_cfg.train.distortion,
                lpips_weight=run_cfg.train.lpips_weight, lpips_fn=lpips_fn,
                generator=torch.Generator(dev).manual_seed(11))
        return float(loss - m["aux"])

    init_model, _ = train.create_state(run_cfg, seed=run_cfg.train.seed,
                                       device=dev)
    loss_init = main_loss(init_model)
    times["d_setup"] = time.perf_counter() - t_d
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cli.main(["train", "--preset", "flagship", *sets, "--steps",
                  str(n_steps), "--workdir", str(tmp)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        run = api.run_dir(tmp, rcfg)
        rows = [json.loads(line) for line in
                (run / "logs" / "metrics.jsonl").read_text().splitlines()]
        losses = [m["loss"] for m in rows]
        main_logged = [m["loss"] - m["aux"] for m in rows]
        sps = [m["steps_per_sec"] for m in rows[1:]]
        chunk_s = k / statistics.median(sps)
        mngr = CheckpointManager(run / "ckpt")
        final = mngr.read(n_steps)["params"]
        init_model.load_state_dict(final, strict=True)
        loss_end = main_loss(init_model)
        del init_model
        say("train", f"CLI train {n_steps} steps ({RECIPE_CHUNKS} chunks of "
            f"{k}) in {run_s:.1f} s: {statistics.median(sps):.2f} steps a "
            f"second (median over chunks 2..{RECIPE_CHUNKS} of the run's log; "
            f"a chunk {chunk_s:.2f} s; {n_steps * tc.batch_size / run_s:.1f} "
            f"images a second over the whole run); peak device memory "
            f"{peak / 2 ** 30:.2f} GiB; logged loss of the first chunk "
            f"{losses[0]:.4f}, of the last {losses[-1]:.4f} (less aux "
            f"{main_logged[0]:.4f}, {main_logged[-1]:.4f}); loss less aux "
            f"on a fixed batch and fixed draws: {loss_init:.4f} at the "
            f"initialisation, {loss_end:.4f} at step {n_steps} ({card})")
        check(len(rows) == RECIPE_CHUNKS and all(np.isfinite(losses)),
              f"logged rows {len(rows)} != chunks {RECIPE_CHUNKS}")
        check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        check(loss_end < loss_init, f"the loss less aux did not fall: "
              f"{loss_init} -> {loss_end}")
        # Resume from the mid-run checkpoint: the batches, then the params;
        # the resumed run's last chunk runs under the profiler.
        check(mngr.steps() == [n_steps // 2, n_steps],
              f"checkpoints {mngr.steps()}")
        times["d_cli"] = run_s
        times["d_checks"] = time.perf_counter() - t0 - run_s
        t_part = time.perf_counter()
        plain = train_crop_iterator(data_imgs, tc.batch_size, tc.crop_size,
                                    as_uint8=True)
        for _ in range(n_steps // 2):
            next(plain)
        resumed = train_crop_iterator(data_imgs, tc.batch_size,
                                      tc.crop_size, as_uint8=True,
                                      start=n_steps // 2)
        same_batches = all(np.array_equal(next(plain), next(resumed))
                           for _ in range(2))
        check(same_batches, "the resumed batches differ")
        _, fresh = train.create_state(run_cfg, seed=1, device=dev)
        mngr.restore(fresh, step=n_steps // 2)
        resumed = train_crop_iterator(data_imgs, tc.batch_size,
                                      tc.crop_size, as_uint8=True,
                                      start=n_steps // 2)
        train.fit(run_cfg, resumed, start_state=fresh,
                  num_steps=n_steps // 2 - k, device=dev)
        # Its last PROFILED_STEPS steps in chunks of that many (a step does
        # not depend on K) under the profiler, the card's activity alone:
        # aggregating the host's events of a whole chunk took longer than
        # the chunk.
        tail_cfg = dataclasses.replace(run_cfg, train=dataclasses.replace(
            run_cfg.train, steps_per_dispatch=PROFILED_STEPS))
        train.fit(tail_cfg, resumed, start_state=fresh,
                  num_steps=k - PROFILED_STEPS, device=dev)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train.fit(tail_cfg, resumed, start_state=fresh,
                      num_steps=PROFILED_STEPS, device=dev)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        busy_s = 1e-6 * sum(float(e.self_device_time_total)
                            for e in prof.key_averages()
                            if e.device_type == torch.autograd.DeviceType.CUDA)
        step_s = chunk_s / k
        got = fresh.model.state_dict()
        diff = torch.sqrt(sum(torch.sum(torch.square(
            got[n].double().cpu() - final[n].double())) for n in final))
        norm = torch.sqrt(sum(torch.sum(torch.square(final[n].double()))
                              for n in final))
        bit_equal = all(torch.equal(got[n].cpu(), final[n]) for n in final)
        resume_rel = float(diff / norm)
        say("train", f"resume from step {n_steps // 2}: the same batches; "
            f"parameters after {n_steps} steps against the uninterrupted "
            f"run: relative 2-norm {resume_rel:.3g} (bound 1e-3), "
            f"bit-equal {bit_equal}. Its last {PROFILED_STEPS} steps under "
            f"the profiler: {prof_s:.2f} s, " + (
                f"the card busy {busy_s:.3f} s ({100 * busy_s / prof_s:.1f} "
                f"% of the profiled steps, "
                f"{100 * busy_s / (PROFILED_STEPS * step_s):.1f} % of "
                f"{PROFILED_STEPS} steps of the CLI run)" if busy_s else
                "the profiler saw no kernel (a lost CUPTI buffer): busy "
                "share not measured") + f" ({card})")
        check(resume_rel <= 1e-3, f"resumed run differs: {resume_rel}")
        del fresh
        times["d_resume"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # The run directory serves its EMA weights.
        rt = api.load_runtime("flagship", checkpoint=str(run),
                              overrides=SERVING_OVERRIDES)
        ema = mngr.read(n_steps)["ema_params"]
        check(all(torch.equal(p.cpu(), ema[n])
                  for n, p in rt.model.named_parameters()),
              "load_runtime does not serve the run's EMA weights")
        blob = rt.compress(img768)
        x = torch.from_numpy(codec_runtime.to_model_range(
            codec_runtime.pad_image(img768)[0]))[None].to(dev)
        y, z_enc = rt._analysis(x, 0)
        y_enc, _, _ = rt._y_passes(z_enc.cpu().numpy(), y=y)
        _, y_dec, _, _ = rt._decode_symbols(blob)
        check(torch.equal(y_dec.cpu(), y_enc.cpu()),
              "the trained run's own round trip is not exact")
        out = rt.decompress(blob)
        check(out.shape == img768.shape, "bad decode of the trained run")
        say("train", f"load_runtime(checkpoint=<run dir>) serves the step-"
            f"{n_steps} EMA weights; its round trip of the 768x512 image is "
            f"exact ({len(blob)} B)")
    times["d_serve"] = time.perf_counter() - t_part
    rep["recipe"] = {"steps": n_steps, "chunk_s": chunk_s,
                     "profiled_steps": PROFILED_STEPS,
                     "profiled_s": prof_s, "busy_s": busy_s,
                     "busy_share_profiled": busy_s / prof_s,
                     "busy_share": busy_s / (PROFILED_STEPS * step_s),
                     "run_s": run_s,
                     "steps_per_sec": sps, "peak_bytes": peak,
                     "losses": losses, "main_losses": main_logged,
                     "main_loss_fixed": [loss_init, loss_end],
                     "resume_rel": resume_rel,
                     "resume_bit_equal": bit_equal}
    times["d_recipe"] = time.perf_counter() - t_d
    # (e) the analytic rate estimate against the coder.
    t_part = time.perf_counter()
    npix = img768.shape[0] * img768.shape[1]
    gaps = {}
    for name, rt_, q in (("flagship", rt16, 0), ("vr_wide q0", rtv16, 0),
                         ("vr_wide q1", rtv16, 1), ("vr_wide q2", rtv16, 2)):
        est = rt_.estimate_bpp(img768, q)
        real = 8 * len(rt_.compress(img768, quality=q if rt_ is rtv16
                                    else None)) / npix
        gaps[name] = {"estimate": est, "actual": real,
                      "rel": (est - real) / real}
    say("train", "estimate_bpp vs compress, 768x512 (BF16_POLICY): " + "; ".join(
        f"{k_} {v_['estimate']:.4f} / {v_['actual']:.4f} "
        f"({100 * v_['rel']:+.2f} %)" for k_, v_ in gaps.items())
        + f" (sanity bound {100 * RATE_GAP_SANITY:g} %)")
    check(all(abs(v_["rel"]) <= RATE_GAP_SANITY for v_ in gaps.values()),
          f"estimate off the coder by more than the bound: {gaps}")
    t0 = time.perf_counter()
    blob_e, q_e, bpp_e = rtv16.compress_to_bpp(img768, vr_target,
                                               probe="estimate")
    est_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, q_c, bpp_c = rtv16.compress_to_bpp(img768, vr_target)
    enc_s = time.perf_counter() - t0
    padded = codec_runtime.pad_image(img768)
    xv = torch.from_numpy(codec_runtime.to_model_range(
        padded[0]))[None].to(dev)

    def med(fn, runs=5):
        fn()
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0_))
        return statistics.median(times)
    probe_est = med(lambda: rtv16._estimate_bpp_device(xv, padded[1], 1.0))
    probe_enc = med(lambda: rtv16.compress(img768, quality=1.0))
    say("train", f"vr_wide compress_to_bpp({vr_target:.4f}): probe "
        f"'estimate' bpp {bpp_e:.4f} at quality {q_e:.4f} in {est_s:.2f} s; "
        f"probe 'encode' bpp {bpp_c:.4f} at quality {q_c:.4f} in "
        f"{enc_s:.2f} s; one estimate probe {probe_est:.2f} ms, one encode "
        f"probe {probe_enc:.2f} ms (median of 5) ({card})")
    check(abs(bpp_e - vr_target) <= RATE_EST_REL * vr_target,
          f"probe='estimate' missed {vr_target}: {bpp_e}")
    rep["rate"] = {"gaps": gaps, "target": vr_target,
                   "estimate": [bpp_e, q_e, est_s],
                   "encode": [bpp_c, q_c, enc_s],
                   "probe_ms": {"estimate": probe_est, "encode": probe_enc}}
    times["e_rate"] = time.perf_counter() - t_part
    rep["seconds"] = time.perf_counter() - t_phase
    say("train", f"phase 15 took {rep['seconds']:.1f} s: " + ", ".join(
        f"{key} {val:.1f}" for key, val in times.items()) + f" ({card})")
    return step_launches


# Phase 16: the mesh at world 1 over NCCL (the card is one).
MESH_CHUNKS = 2
MESH_VERB_STEPS = 4
MESH_PHASE_S = 90.0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_mesh(torch, dev, port, rt16, big_blob, img768) -> dict:
    """Phase 16: the mesh paths on the card (see the module docstring).
    Returns the launches of a mesh train step and of the mesh tiled decode,
    by kernel."""
    import os
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from tpucdc_torch import api
    from tpucdc_torch.data import kodak, train_crop_iterator
    from tpucdc_torch.ops import _kernels
    from tpucdc_torch.pipelines import train
    from tpucdc_torch.presets import SERVING_OVERRIDES
    from tpucdc_torch.runtime import make_mesh, maybe_init_distributed

    t_phase = time.perf_counter()
    card = card_line()
    rep = REPORT["mesh"] = {}
    # (a) NCCL at world 1 from the TPUCDC_* variables. The train verb of
    # phase 15 formed a world of 1 on an in-memory store; it goes first.
    if dist.is_initialized():
        dist.destroy_process_group()
    env = {"TPUCDC_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "TPUCDC_NUM_PROCESSES": "1", "TPUCDC_PROCESS_ID": "0"}
    os.environ.update(env)
    check(maybe_init_distributed(dev) is True,
          "maybe_init_distributed did not initialise")
    backend = dist.get_backend()
    mesh = make_mesh(device=dev)
    shape = tuple(mesh.mesh.shape)
    on_card = dev.type == "cuda"
    nccl = (".".join(map(str, torch.cuda.nccl.version())) if on_card
            else "none")
    say("mesh", f"maybe_init_distributed({dev.type!r}): backend {backend}, "
        f"NCCL {nccl}, world {dist.get_world_size()}; make_mesh(): "
        f"{mesh.mesh_dim_names} {shape} on {mesh.device_type}"
        + (f":{torch.cuda.current_device()}" if on_card else ""))
    check(backend == ("nccl" if on_card else "gloo") and shape == (1, 1)
          and mesh.mesh_dim_names == ("data", "model")
          and mesh.device_type == dev.type,
          "the mesh is not (1, 1) over NCCL on the card")
    rep.update(backend=backend, nccl=nccl, mesh=list(shape))

    # (b) the recipe of phase 15 with and without the mesh, in turns.
    recipe = {**SERVING_OVERRIDES, **RECIPE}
    rcfg = api.build_config("flagship", recipe)
    tc = rcfg.train
    k = tc.steps_per_dispatch
    n_steps = MESH_CHUNKS * k
    cfg_n = api.build_config("flagship", {
        **recipe, "train.steps": str(n_steps), "train.log_every": "1",
        "train.warmup_steps": str(k)})
    data_imgs = kodak().images

    def run(cfg_, mesh_):
        rows = []
        data = train_crop_iterator(data_imgs, tc.batch_size, tc.crop_size,
                                   seed=tc.seed, as_uint8=True)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        _, st = train.fit(cfg_, data, mesh=mesh_, num_steps=n_steps,
                          device=dev, writer=lambda s_, m: rows.append(m))
        torch.cuda.synchronize()
        return st, rows, dict(_kernels.LAUNCHES)

    def bit_equal(a, b):
        names = [n_ for n_, _ in a.model.named_parameters()]
        return (len(names),
                all(torch.equal(a.model.get_parameter(n_),
                                b.model.get_parameter(n_)) for n_ in names),
                all(torch.equal(a.ema_params[n_], b.ema_params[n_])
                    for n_ in names))

    sps = {"none": [], "mesh": []}
    states = {}
    t_part = time.perf_counter()
    for label in ("none", "mesh", "mesh", "none"):
        st, rows, launches = run(cfg_n, mesh if label == "mesh" else None)
        # The last chunk's rate: the first carries the warm-up.
        sps[label].append(rows[-1]["steps_per_sec"])
        if label == "mesh":
            mesh_launches = {n_: v // n_steps for n_, v in launches.items()}
            check(all(v == mesh_launches[n_] * n_steps
                      for n_, v in launches.items()),
                  f"mesh fit launches {launches} over {n_steps} steps")
        states.setdefault(label, st)
        del st
    n_params, params_equal, ema_equal = bit_equal(states["none"],
                                                  states["mesh"])
    say("mesh", f"recipe fit (batch {tc.batch_size}, crop {tc.crop_size}, K "
        f"{k}, {MESH_CHUNKS} chunks, BF16_POLICY, fresh init at seed "
        f"{tc.seed}): mesh=None against mesh=make_mesh(): {n_params} "
        f"parameters bit-equal {params_equal}, EMA bit-equal {ema_equal}; "
        f"launches a mesh step {mesh_launches}; steps a second of the last "
        f"chunk in turns (N M M N): none {sps['none']}, mesh {sps['mesh']} "
        f"({card})")
    check(n_params == 398 and params_equal and ema_equal,
          "the mesh fit differs from the one-card fit")
    check(mesh_launches == {"gn_silu": 21, "attention": 12},
          f"mesh train step launches {mesh_launches}")
    del states["none"]
    cfg_t = api.build_config("flagship", {
        **recipe, "train.steps": str(n_steps), "train.log_every": "1",
        "train.warmup_steps": str(k), "train.param_sharding": "tensor"})
    st_t, _, _ = run(cfg_t, mesh)
    _, tensor_params, tensor_ema = bit_equal(st_t, states["mesh"])
    say("mesh", f"param_sharding='tensor' on the (1, 1) mesh, "
        f"{MESH_CHUNKS} chunks: parameters bit-equal to the replicated "
        f"run's {tensor_params}, EMA {tensor_ema} (every leaf is replicated "
        f"at model 1)")
    check(tensor_params and tensor_ema,
          "the tensor-sharded fit differs from the replicated")
    del st_t, states
    rep["fit"] = {"steps_per_sec": sps, "launches_per_step": mesh_launches,
                  "params_bit_equal": params_equal,
                  "ema_bit_equal": ema_equal,
                  "tensor_bit_equal": tensor_params and tensor_ema,
                  "seconds": time.perf_counter() - t_part}

    # (c) the 48-tile decode of phase 11 over the mesh, in turns.
    t_part = time.perf_counter()
    outs, ms = {}, {"none": [], "mesh": []}
    for label in ("none", "mesh", "mesh", "none"):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        out = rt16.decompress_tiled(
            big_blob, mesh=mesh if label == "mesh" else None)
        torch.cuda.synchronize()
        ms[label].append(1e3 * (time.perf_counter() - t0))
        n_ = dict(_kernels.LAUNCHES)
        if label == "mesh":
            tiled_launches = n_
        outs[label] = out
    worst, within1 = lsb_gap(outs["mesh"], outs["none"])
    say("mesh", f"decompress_tiled of phase 11's 2048x1536 image (48 tiles), "
        f"BF16_POLICY, seed-0 noise: mesh against none max|diff| {worst} "
        f"LSB (bound 1), {100 * within1:.4f} % within 1, equal "
        f"{np.array_equal(outs['mesh'], outs['none'])}; launches {tiled_launches}; "
        f"ms in turns (N M M N): none {ms['none']}, mesh {ms['mesh']} "
        f"({card})")
    check(worst <= 1, "the mesh tiled decode differs from the one-card one")
    check(tiled_launches == {"gn_silu": 93, "attention": 60},
          f"mesh tiled decode launches {tiled_launches}")
    rep["tiled"] = {"max_lsb": worst, "within1": within1, "ms": ms,
                    "launches": tiled_launches,
                    "seconds": time.perf_counter() - t_part}

    # (d) the train verb in a process of its own under the TPUCDC_*
    # variables (its own port: this process's store holds the first).
    t_part = time.perf_counter()
    verb = {**recipe, "train.steps": str(MESH_VERB_STEPS),
            "train.steps_per_dispatch": str(MESH_VERB_STEPS),
            "train.warmup_steps": "1", "train.log_every": "1",
            "train.checkpoint_every": str(MESH_VERB_STEPS)}
    with tempfile.TemporaryDirectory() as tmp:
        child_env = {**os.environ, **env, "TPUCDC_COORDINATOR":
                     f"127.0.0.1:{_free_port()}"}
        out = subprocess.run(
            [sys.executable, "-m", "tpucdc_torch", "train", "--preset",
             "flagship", "--device", dev.type,
             *[f"--set={key}={val}" for key, val in verb.items()],
             "--steps", str(MESH_VERB_STEPS), "--workdir", tmp],
            cwd=ROOT, env=child_env, capture_output=True, text=True,
            timeout=300)
        check(out.returncode == 0, f"train verb failed:\n{out.stderr[-3000:]}")
        run_dir = api.run_dir(tmp, rcfg)
        rows = (run_dir / "logs" / "metrics.jsonl").read_text().splitlines()
        ckpts = sorted(p_.name for p_ in (run_dir / "ckpt").iterdir())
        rt = api.load_runtime("flagship", checkpoint=str(run_dir),
                              overrides=SERVING_OVERRIDES, device=dev)
        blob = rt.compress(img768)
        got = rt.decompress(blob)
        _, y_dec, _, _ = rt._decode_symbols(blob)
        check(got.shape == img768.shape and len(rows) == 1
              and ckpts == [str(MESH_VERB_STEPS)],
              f"train verb run directory: rows {rows}, ckpts {ckpts}")
        verb_s = time.perf_counter() - t_part
        say("mesh", f"python -m tpucdc_torch train under TPUCDC_* (world 1, "
            f"{backend}), {MESH_VERB_STEPS} steps: {verb_s:.1f} s with the "
            f"process's start; run directory {ckpts} + 1 log row; "
            f"load_runtime on it compresses and decodes the 768x512 image "
            f"({len(blob)} B, {tuple(got.shape)})")
    rep["verb_s"] = verb_s
    del rt
    dist.destroy_process_group()
    for key in env:
        os.environ.pop(key, None)
    rep["seconds"] = time.perf_counter() - t_phase
    say("mesh", f"phase 16 took {rep['seconds']:.1f} s (bound "
        f"{MESH_PHASE_S:g}) ({card})")
    check(rep["seconds"] <= MESH_PHASE_S, "phase 16 took too long")
    return {"mesh_train_step": mesh_launches, "mesh_tiled": tiled_launches}


if __name__ == "__main__":
    main()
