#!/usr/bin/env python3
"""The mesh paths of tpucdc_torch across several cards, one process a card,
held against the same work on one card.

Usage, on a host with N >= 2 cards (N = 4 in PERF.md):

    python3 scripts/mesh_torch_cards.py [--nproc 4]

The script builds the kernels once, then starts itself under ``python3 -m
torch.distributed.run --standalone --nproc_per_node=N`` (the worker), then
the ``train`` verb and ``eval --mesh --tiled`` under the same launcher, then
``eval --tiled`` in one process, and checks what the verbs wrote. Every
process finds its world in torchrun's variables alone
(``runtime.maybe_init_distributed``). The worker, on every rank:

  (a) NCCL from torchrun's variables, this rank's card ``LOCAL_RANK``; the
      meshes (N, 1) and (N/2, 2); one ``all_reduce`` of the recipe's
      gradient buffer (8,565,187 f32) over each data group, median of 20.
  (b) One step of the flagship recipe (``chip_smoke.RECIPE``: batch 16, crop
      192) under F32_POLICY with TF32 off, from one fresh initialisation and
      the same draws: on one card (every rank alone, ``mesh=None``), over
      (N, 1), and over (N/2, 2) with ``param_sharding="tensor"``. The loss
      and every metric within 1e-4 relative of the one-card step's, every
      parameter's gradient within 1e-3·‖g‖ + 1e-6 (the card's training
      bounds, PERF.md §2).
  (c) The recipe under BF16_POLICY from a fresh initialisation for 2
      K-chunks: one card, (N, 1), (N/2, 2) replicated and (N/2, 2)
      ``"tensor"``, in turns (1 D R T T R D 1). ``"tensor"`` bit-equal to
      replicated on the same mesh; each rank's EMA and moments of a
      ``"tensor"`` run hold half of every shardable leaf; 21 GN+SiLU and 12
      attention launches a step on every rank. Printed: the steps a second
      of the last chunk, and the distance of each run's parameters from the
      one-card run's (relative 2-norm, and over the one-card run's update).
  (d) The trained flagship's tiled decode of ``chip_smoke.seeded_image(1536,
      2048, seed=11)`` (48 tiles, as phase 11) and of a seeded 512×768 image
      (6 tiles, padded to a multiple of N), over (N, 1) against the one-card
      decode on the same rank with the same noise. Under F32_POLICY within 1
      LSB (phase 11's bound for tiles decoded in another batch). Under the
      served BF16_POLICY, in turns (1 M M 1): at least 35 dB PSNR (the bf16
      bound of PERF.md §2: each rank decodes N times fewer tiles a batch,
      and bf16 convolutions round by batch), the largest gap printed, 93 /
      60 launches on every rank, the ms. Every rank gets rank 0's image.

The verbs: ``train`` for 4 steps (K = 4) of the recipe writes one run
directory (one log row, one checkpoint) whose EMA weights ``load_runtime``
serves with its own round trip; ``eval --mesh --tiled --no-lpips`` of
``kodak()`` prints one aggregate (rank 0's) and logs 24 + 1 rows, with the
bytes of the same eval in one process (a world of 1) and its PSNR within
0.01 dB, MS-SSIM and GMSD within 1e-4 (decodes within 1 LSB).

Any failed check raises and the script exits non-zero. The last line is one
JSON object of the readings, also written to
chiprun_out/mesh_torch_cards/summary.json. ``--device cpu --small``
rehearses it all over gloo on the CPU at the tiny preset (drawn weights,
batch 4, crop 64, K 1, a 320×640 image decoded at 0 steps: the tiny preset's
ε-prediction chain is not the mesh branch's, which JAX's mesh branch starts
from pure noise; the eval at 1 step): checks of launches and the card's
name are skipped there. Imports nothing of JAX or tpucdc.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (RECIPE, TRAIN_GRAD_ABS, TRAIN_GRAD_REL,  # noqa: E402
                        TRAIN_METRIC_REL, check, lsb_gap, psnr_db,
                        seeded_image)

OUT = ROOT / "chiprun_out" / "mesh_torch_cards"
WEIGHTS = ROOT / "artifacts" / "flagship_params.npz"
CHUNKS = 2
VERB_STEPS = 4
EVAL_PSNR_DB, EVAL_SSIM = 0.01, 1e-4


def settings(small: bool) -> dict:
    """The model, weights and sizes of a run: the flagship's, or the tiny
    preset's for a rehearsal on the CPU."""
    from tpucdc_torch.presets import SERVING_OVERRIDES
    if small:
        return {"preset": "tiny", "serving": {}, "weights": None,
                "recipe": {**RECIPE, "train.batch_size": "4",
                           "train.crop_size": "64",
                           "train.steps_per_dispatch": "1"},
                "images": [(320, 640)], "decode_steps": 0, "eval_steps": 1,
                "verb_steps": 2}
    return {"preset": "flagship", "serving": SERVING_OVERRIDES,
            "weights": str(WEIGHTS), "recipe": RECIPE,
            "images": [(1536, 2048), (512, 768)], "decode_steps": None,
            "eval_steps": None, "verb_steps": VERB_STEPS}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
    except FileNotFoundError:
        return "no card"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "no card"


# ---- the worker: one process a card ----

def worker(args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from tpucdc_torch import api
    from tpucdc_torch.data import kodak, train_crop_iterator
    from tpucdc_torch.model import CDCModel
    from tpucdc_torch.ops import _kernels
    from tpucdc_torch.parallel.tiling import make_tile_plan
    from tpucdc_torch.pipelines import train
    from tpucdc_torch.pipelines.codec_runtime import CodecRuntime
    from tpucdc_torch.runtime import (BF16_POLICY, F32_POLICY, make_mesh,
                                      maybe_init_distributed, pin_numerics,
                                      prng, set_policy, shard_batch)
    from tpucdc_torch.runtime.mesh import DATA_AXIS, axis_group

    on_card = args.device == "cuda"
    check(maybe_init_distributed(args.device) is True,
          "maybe_init_distributed found no world")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))
    s = settings(args.small)
    rep = {"world": world, "backend": dist.get_backend()}

    def say(msg: str) -> None:
        if rank == 0:
            print(f"[cards] {msg}", flush=True)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()

    def every_rank(value) -> list:
        got = [None] * world
        dist.all_gather_object(got, value)
        return got

    cards = every_rank((os.environ.get("LOCAL_RANK"), str(dev)))
    check(len({c for _, c in cards}) == world or not on_card,
          f"ranks share a card: {cards}")
    mesh_d = make_mesh(device=dev)
    mesh_t = make_mesh(n_data=world // 2, n_model=2, device=dev)
    nccl = (".".join(map(str, torch.cuda.nccl.version())) if on_card
            else "none")
    card = card_line()
    say(f"world {world} over {rep['backend']} (NCCL {nccl}), ranks on "
        f"{[c for _, c in cards]}; meshes {tuple(mesh_d.mesh.shape)} and "
        f"{tuple(mesh_t.mesh.shape)} ({card})")
    rep.update(nccl=nccl, card=card)

    # (a) the gradient all_reduce alone, over each data group.
    n_grad = sum(p.numel() for p in CDCModel(api.build_config(
        s["preset"], {**s["serving"], **s["recipe"]}).model).parameters())
    flat = torch.ones(n_grad, device=dev)
    allreduce_ms = {}
    for label, mesh_ in (("data", mesh_d), ("data_of_2x2", mesh_t)):
        group = axis_group(mesh_, DATA_AXIS)
        times = []
        for i in range(23):
            sync()
            t0 = time.perf_counter()
            dist.all_reduce(flat, group=group)
            sync()
            if i >= 3:
                times.append(1e3 * (time.perf_counter() - t0))
        allreduce_ms[label] = statistics.median(times)
    say(f"all_reduce of {n_grad} f32 ({4 * n_grad / 1e6:.1f} MB), median of "
        f"20 with a barrier each: over the data group of "
        f"{tuple(mesh_d.mesh.shape)} {allreduce_ms['data']:.3f} ms, of "
        f"{tuple(mesh_t.mesh.shape)} {allreduce_ms['data_of_2x2']:.3f} ms "
        f"({card})")
    rep["allreduce_ms"] = allreduce_ms
    del flat

    # (b) one F32 step on one card, over (N, 1), over (N/2, 2) "tensor".
    recipe = {**s["serving"], **s["recipe"]}
    images = kodak().images

    def config(**extra):
        return api.build_config(s["preset"], {**recipe, **{
            f"train.{k}": str(v) for k, v in extra.items()}})

    cfg = config()
    tc = cfg.train
    tables = train.schedule_tables(cfg, dev)
    batch = next(train_crop_iterator(images, tc.batch_size, tc.crop_size,
                                     seed=tc.seed, as_uint8=True))

    def one_step(mesh_, sharding):
        cfg_ = config(param_sharding=sharding)
        model, st = train.create_state(cfg_, seed=tc.seed, mesh=mesh_,
                                       device=dev)
        set_policy(model, F32_POLICY)
        pin_numerics()
        step_fn = train.make_train_step(cfg_, tables, mesh_)
        local = batch if mesh_ is None else shard_batch(batch, mesh_)
        m = step_fn(st, torch.from_numpy(np.ascontiguousarray(local)).to(dev),
                    prng.generator(tc.seed + 1, 0, device=dev))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 .detach().double() for n, p in model.named_parameters()}
        return {k: float(v) for k, v in m.items()}, grads

    want_m, want_g = one_step(None, "replicated")
    step_rep = {}
    for label, mesh_, sharding in (("data", mesh_d, "replicated"),
                                   ("tensor_2x2", mesh_t, "tensor")):
        got_m, got_g = one_step(mesh_, sharding)
        metric = max(abs(got_m[k] - v) / max(abs(v), 1e-30)
                     for k, v in want_m.items())
        grad = max(float((got_g[n] - g).norm())
                   / (TRAIN_GRAD_REL * float(g.norm()) + TRAIN_GRAD_ABS)
                   for n, g in want_g.items())
        worst = every_rank((metric, grad))
        metric, grad = max(w[0] for w in worst), max(w[1] for w in worst)
        step_rep[label] = {"metric_rel": metric, "grad_over_bound": grad}
        say(f"one recipe step (batch {tc.batch_size}, crop {tc.crop_size}) "
            f"F32_POLICY, TF32 off, over {label} against one card: worst "
            f"metric {metric:.3g} relative (bound {TRAIN_METRIC_REL:g}), "
            f"worst gradient at {grad:.3g} of 1e-3·‖g‖ + 1e-6 "
            f"({len(want_g)} parameters, every rank)")
        check(metric <= TRAIN_METRIC_REL and grad <= 1.0,
              f"the {label} step differs from the one-card step")
        del got_g
    rep["step"] = step_rep
    del want_g

    # (c) the BF16 recipe over 2 chunks, in turns.
    k = tc.steps_per_dispatch
    n_steps = CHUNKS * k
    runs = {"one": (None, "replicated"), "data": (mesh_d, "replicated"),
            "replicated_2x2": (mesh_t, "replicated"),
            "tensor_2x2": (mesh_t, "tensor")}
    init = None
    finals, sps, layouts = {}, {key: [] for key in runs}, {}
    t_part = time.perf_counter()
    for label in ("one", "data", "replicated_2x2", "tensor_2x2",
                  "tensor_2x2", "replicated_2x2", "data", "one"):
        mesh_, sharding = runs[label]
        cfg_ = config(steps=n_steps, log_every=1, warmup_steps=k,
                      param_sharding=sharding)
        if init is None:
            init = torch.cat([p.detach().reshape(-1).double() for p in
                              train.create_state(cfg_, seed=tc.seed,
                                                 device=dev)[0].parameters()])
        rows = []
        data = train_crop_iterator(images, tc.batch_size, tc.crop_size,
                                   seed=tc.seed, as_uint8=True)
        sync()
        _kernels.reset_launches()
        _, st = train.fit(cfg_, data, mesh=mesh_, num_steps=n_steps,
                          device=dev, writer=lambda s_, m: rows.append(m))
        sync()
        launches = dict(_kernels.LAUNCHES)
        if rank == 0:
            sps[label].append(rows[-1]["steps_per_sec"])
        if on_card:
            per_step = every_rank({n: v / n_steps for n, v in
                                   launches.items()})
            check(all(p == {"gn_silu": 21, "attention": 12, "adaln": 0}
                      for p in per_step),
                  f"{label} fit launches a step by rank {per_step}")
        if label not in finals:
            finals[label] = torch.cat([p.detach().reshape(-1).double()
                                       for p in st.model.parameters()])
            held = sum(e.numel() for e in st.ema_params.values())
            held += sum(m.numel() for m in st.opt.mu + st.opt.nu)
            layouts[label] = held
        del st
    one = finals["one"]
    dist_rep = {}
    for label in ("data", "replicated_2x2", "tensor_2x2"):
        d = finals[label] - one
        dist_rep[label] = {"rel": float(d.norm() / one.norm()),
                           "over_update": float(d.norm()
                                                / (one - init).norm())}
    tensor_equal = every_rank(bool(torch.equal(finals["tensor_2x2"],
                                               finals["replicated_2x2"])))
    say(f"recipe fit (batch {tc.batch_size}, crop {tc.crop_size}, K {k}, "
        f"{CHUNKS} chunks, BF16_POLICY, fresh init at seed {tc.seed}): "
        f"21 / 12 launches a step on every rank; 'tensor' bit-equal to "
        f"replicated on {tuple(mesh_t.mesh.shape)} on every rank "
        f"{tensor_equal}; parameters against the one-card run's: {dist_rep}; "
        f"EMA and moments held a rank: replicated {layouts['replicated_2x2']}"
        f", tensor {layouts['tensor_2x2']} values; steps a second of the "
        f"last chunk in turns (1 D R T T R D 1): {sps} ({card})")
    check(all(tensor_equal), "the tensor-sharded fit differs from the "
          "replicated one on the same mesh")
    check(layouts["tensor_2x2"] < layouts["replicated_2x2"],
          "the tensor-sharded state holds no slice")
    rep["fit"] = {"steps_per_sec": sps, "distance": dist_rep,
                  "tensor_bit_equal": all(tensor_equal),
                  "held_values": layouts,
                  "seconds": time.perf_counter() - t_part}
    del finals, one, init

    # (d) the tiled decode over (N, 1) against one card: the served
    # BF16_POLICY in turns, then F32_POLICY, where a tile's pixels do not
    # hang on the batch it is decoded in (phase 11's bound).
    cfg_s = api.build_config(s["preset"], s["serving"])
    rts = {name: CodecRuntime(cfg_s, api.load_model(cfg_s, s["weights"]),
                              device=dev, policy=policy)
           for name, policy in (("bf16", BF16_POLICY), ("f32", F32_POLICY))}
    rep["tiled"] = {}
    for h, w in s["images"]:
        blob = [rts["bf16"].compress(seeded_image(h, w, seed=11))
                if rank == 0 else None]
        dist.broadcast_object_list(blob, src=0)
        blob = blob[0]
        outs, ms = {}, {"one": [], "mesh": []}
        for label in ("one", "mesh", "mesh", "one"):
            sync()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            out = rts["bf16"].decompress_tiled(
                blob, mesh=mesh_d if label == "mesh" else None,
                steps=s["decode_steps"])
            if on_card:
                torch.cuda.synchronize()
            ms[label].append(1e3 * (time.perf_counter() - t0))
            if label == "mesh":
                launches = dict(_kernels.LAUNCHES)
            outs[label] = out
        f32 = {label: rts["f32"].decompress_tiled(
            blob, mesh=mesh_d if label == "mesh" else None,
            steps=s["decode_steps"]) for label in ("one", "mesh")}
        gap32 = lsb_gap(f32["mesh"], f32["one"])[0]
        gap16, within1 = lsb_gap(outs["mesh"], outs["one"])
        db = psnr_db(outs["mesh"], outs["one"])
        same = True
        for img in (outs["mesh"], f32["mesh"]):
            mine = torch.from_numpy(img).to(dev)
            rank0 = mine.clone()
            dist.broadcast(rank0, src=0)
            same = same and bool(torch.equal(mine, rank0))
        per_rank = every_rank((gap32, gap16, db, same, launches))
        n_tiles = make_tile_plan(h, w).num_tiles
        say(f"decompress_tiled {w}x{h} ({n_tiles} tiles, padded to "
            f"{-(-n_tiles // world) * world}) over {tuple(mesh_d.mesh.shape)} "
            f"against one card, same noise: F32_POLICY max|diff| by rank "
            f"{[p[0] for p in per_rank]} LSB (bound 1); BF16_POLICY max|diff|"
            f" by rank {[p[1] for p in per_rank]} LSB, rank 0 within 1 "
            f"{100 * within1:.4f} %, PSNR {min(p[2] for p in per_rank):.2f} "
            f"dB (bound 35); equal to rank 0's on every rank "
            f"{all(p[3] for p in per_rank)}; BF16 launches by rank "
            f"{[p[4] for p in per_rank]}; BF16 ms in turns (1 M M 1): one "
            f"{ms['one']}, mesh {ms['mesh']} ({card})")
        check(all(p[0] <= 1 and p[2] >= 35 and p[3] for p in per_rank),
              "the mesh tiled decode differs from the one-card one")
        if on_card:
            check(all(p[4] == {"gn_silu": 93, "attention": 60, "adaln": 0}
                      for p in per_rank),
                  f"mesh tiled decode launches {per_rank}")
        rep["tiled"][f"{w}x{h}"] = {
            "f32_max_lsb": max(p[0] for p in per_rank),
            "bf16_max_lsb": max(p[1] for p in per_rank),
            "bf16_within1": within1,
            "bf16_psnr_db": min(p[2] for p in per_rank),
            "ms": ms, "launches": [p[4] for p in per_rank]}
    if rank == 0:
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "worker.json").write_text(json.dumps(rep, indent=1))
    dist.destroy_process_group()


# ---- the launcher: the worker and the verbs ----

def run(cmd, env, timeout) -> tuple[str, float]:
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    sys.stdout.write(out.stdout)
    check(out.returncode == 0, f"{cmd[:8]} failed ({out.returncode}):\n"
          f"{out.stderr[-4000:]}")
    return out.stdout, seconds


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--small", action="store_true")
    p.add_argument("--worker", action="store_true")
    args = p.parse_args()
    if args.worker:
        return worker(args)

    import torch
    if args.device == "cuda":
        check(torch.cuda.device_count() >= args.nproc,
              f"{args.nproc} cards wanted, {torch.cuda.device_count()} found")
        from tpucdc_torch.entropy import _build as rans_build
        from tpucdc_torch.ops import _kernels
        _kernels.build(force=True)
        check(rans_build.build_library(force=True) is not None,
              "rANS coder build failed")
    check(args.nproc >= 2 and args.nproc % 2 == 0,
          "--nproc must be even and at least 2")
    from tpucdc_torch import api
    s = settings(args.small)
    for old in ("train", "eval_mesh", "eval_one"):
        shutil.rmtree(OUT / old, ignore_errors=True)
    OUT.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUCDC_") and k not in (
               "RANK", "WORLD_SIZE", "LOCAL_RANK", "COORDINATOR_ADDRESS")}
    if args.small:
        from PIL import Image
        kodak_dir = OUT / "kodak_small"
        kodak_dir.mkdir(exist_ok=True)
        Image.fromarray(seeded_image(320, 320, seed=3)).save(
            kodak_dir / "0.png")
        env["TPUCDC_KODAK_DIR"] = str(kodak_dir)
    launcher = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={args.nproc}"]
    flags = (["--small"] if args.small else [])
    summary = {"card": card_line(), "nproc": args.nproc,
               "torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    _, summary["worker_s"] = run(
        launcher + [str(pathlib.Path(__file__).resolve()), "--worker",
                    "--device", args.device, *flags], env, 1500)
    summary["worker"] = json.loads((OUT / "worker.json").read_text())

    common = ["--preset", s["preset"], "--device", args.device,
              *[f"--set={k}={v}" for k, v in s["serving"].items()]]
    # The train verb under torchrun: rank 0 alone writes the run directory.
    n = s["verb_steps"]
    workdir = OUT / "train"
    verb = {**s["recipe"], "train.steps": str(n),
            "train.steps_per_dispatch": str(n), "train.warmup_steps": "1",
            "train.log_every": "1", "train.checkpoint_every": str(n)}
    _, summary["train_verb_s"] = run(
        launcher + ["-m", "tpucdc_torch", "train", *common,
                    *[f"--set={k}={v}" for k, v in verb.items()
                      if k not in s["serving"]],
                    "--steps", str(n), "--workdir", str(workdir)], env, 900)
    rcfg = api.build_config(s["preset"], {**s["serving"], **verb})
    run_dir = api.run_dir(workdir, rcfg)
    rows = (run_dir / "logs" / "metrics.jsonl").read_text().splitlines()
    ckpts = sorted(q.name for q in (run_dir / "ckpt").iterdir())
    check(len(rows) == 1 and ckpts == [str(n)],
          f"train verb run directory: {len(rows)} rows, ckpts {ckpts}")
    rt = api.load_runtime(s["preset"], checkpoint=str(run_dir),
                          overrides=s["serving"], device=args.device)
    img = seeded_image(512, 768, seed=5)
    blob = rt.compress(img)
    got = rt.decompress(blob, steps=s["eval_steps"])
    check(got.shape == img.shape, f"served shape {got.shape}")
    shutil.rmtree(workdir)     # the checkpoint is 4 × the parameters' size
    print(f"[cards] train verb under torchrun ({args.nproc} ranks), {n} "
          f"steps: {summary['train_verb_s']:.1f} s with the processes' start;"
          f" one log row, checkpoints {ckpts}; load_runtime on it compresses "
          f"and decodes a 768x512 image ({len(blob)} B)", flush=True)
    del rt

    # eval --mesh --tiled under torchrun against the same in one process.
    ev = [*common, "--mesh", "--tiled", "--no-lpips"]
    if s["weights"]:
        ev += ["--checkpoint", s["weights"]]
    if s["eval_steps"]:
        ev += ["--steps", str(s["eval_steps"])]
    out_m, summary["eval_mesh_s"] = run(
        launcher + ["-m", "tpucdc_torch", "eval", *ev,
                    "--workdir", str(OUT / "eval_mesh")], env, 900)
    out_1, summary["eval_one_s"] = run(
        [sys.executable, "-m", "tpucdc_torch", "eval", *ev, "--workdir",
         str(OUT / "eval_one")], env, 900)
    printed = [json.loads(ln) for ln in out_m.splitlines()
               if ln.startswith("{")]
    want = [json.loads(ln) for ln in out_1.splitlines()
            if ln.startswith("{")][-1]
    logged = (OUT / "eval_mesh" / "metrics.jsonl").read_text().splitlines()
    n_img = want["num_images"]
    check(len(printed) == 1 and len(logged) == n_img + 1,
          f"eval --mesh: {len(printed)} printed aggregates, {len(logged)} "
          f"logged rows for {n_img} images")
    got = printed[0]
    gaps = {k: abs(got[k] - want[k]) for k in ("bpp", "psnr", "ms_ssim",
                                                "gmsd")}
    print(f"[cards] eval --mesh --tiled under torchrun ({args.nproc} ranks, "
          f"{n_img} images): {summary['eval_mesh_s']:.1f} s, one aggregate "
          f"and {len(logged)} rows; against the same in one process "
          f"({summary['eval_one_s']:.1f} s): |diff| {gaps}; PSNR "
          f"{got['psnr']:.4f} dB ({summary['card']})", flush=True)
    check(gaps["bpp"] == 0 and gaps["psnr"] <= EVAL_PSNR_DB
          and gaps["ms_ssim"] <= EVAL_SSIM and gaps["gmsd"] <= EVAL_SSIM,
          "eval --mesh over the ranks differs from the one-process eval")
    summary["eval"] = {"gaps": gaps, "mesh_ms_an_image":
                       1e3 * got["decode_s"], "one_ms_an_image":
                       1e3 * want["decode_s"]}
    summary["seconds"] = time.perf_counter() - t0
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
