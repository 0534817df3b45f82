"""What the serving loops share: the port's runtime built from a
configuration file, the seeded images and ε, the closed loop with its
reservoir of kept answers and its traced slice, and the reference.

The loop is closed with one caller: each request is sent when the previous
reply is back, as a library's caller does. A request's latency runs from the
call to the uint8 image or the bitstream on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from cdcbench import core, tracing
from cdcbench.spans import Spans

TAG_IMAGE, TAG_NOISE, TAG_QUALITY, TAG_KEEP, TAG_WARM = 1, 2, 3, 4, 5


def port_runtime(run: core.Run):
    """The port's ``CodecRuntime`` of the configuration file, on the run's
    device, under its policy."""
    from tpucdc_torch import api, config as port_config
    from tpucdc_torch.pipelines.codec_runtime import CodecRuntime
    from tpucdc_torch.runtime import BF16_POLICY, F32_POLICY

    from cdcbench.reference.codec_ref import from_dict
    cfg = from_dict(port_config.Config, run.config["config"]).validated()
    model = api.load_model(cfg, str(core.ROOT / run.config["weights"]))
    policy = {"bf16": BF16_POLICY, "f32": F32_POLICY}[run.config["policy"]]
    return CodecRuntime(cfg, model, device=run.device, policy=policy)


def reference(run: core.Run):
    from cdcbench.reference import codec_ref
    return codec_ref.RefCodec(codec_ref.build_config(run.config["config"]),
                              core.ROOT / run.config["weights"], run.device)


def images(run: core.Run) -> list:
    t = run.traffic
    return [core.seeded_image(t["height"], t["width"],
                              core.seed_words(run.seed, TAG_IMAGE, i))
            for i in range(t["pool"])]


def qualities(run: core.Run) -> list:
    """Each pool image's quality: the ladder's first row, or one drawn
    uniformly over the whole ladder where the traffic asks for continuous
    quality."""
    t, nq = run.traffic, run.config["config"]["model"]["codec"]["num_qualities"]
    if not t.get("continuous_quality"):
        return [None] * t["pool"]
    g = core.rng(run.seed, TAG_QUALITY)
    return [float(q) for q in g.uniform(0.0, nq - 1, t["pool"])]


def noise(run: core.Run, i: int, shape, tag: int = TAG_NOISE):
    """Request i's initial ε, from the seed, on the run's device."""
    import torch
    gen = torch.Generator(run.device).manual_seed(
        core.seed_words(run.seed, tag, i))
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=run.device)


def padded_shape(run: core.Run):
    h, w = run.traffic["height"], run.traffic["width"]
    return (1, h + (-h) % 64, w + (-w) % 64, 3)


def activities(run: core.Run) -> list:
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def sync(run: core.Run) -> None:
    import torch
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


@dataclasses.dataclass
class Loop:
    latencies: list
    requests: list
    kept: dict                      # request index → answer
    seconds: float
    traced: dict | None
    profile: dict | None
    failed: int


def closed_loop(run: core.Run, request: Callable[[int], object]) -> Loop:
    """Send request 0, 1, 2, ... each after the previous reply, until the
    window's seconds have passed; keep a seeded uniform sample of the
    answers (reservoir sampling); with a trace, profile requests
    ``trace_after`` to ``trace_after + trace_requests`` - 1."""
    import torch
    t = run.traffic
    keep = t["judge_requests"]
    pick = core.rng(run.seed, TAG_KEEP)
    lat, reqs, kept = [], [], {}
    slots: list = []
    first, count = t.get("trace_after", 0), t.get("trace_requests", 0)
    prof = profile = None
    failed = 0
    start = core.now()
    i = 0
    while core.now() - start < run.seconds or (
            run.trace and i < first + count):
        if run.trace and i == first:
            prof = torch.profiler.profile(activities=activities(run))
            prof.__enter__()
        t0 = core.now()
        try:
            out = request(i)
        except (RuntimeError, ValueError) as e:
            # A request that raises has failed; the window goes on.
            failed += 1
            out = e
        t1 = core.now()
        if run.trace and i == first + count - 1:
            sync(run)
            prof.__exit__(None, None, None)
            profile = tracing.read_profile(prof)
        lat.append(t1 - t0)
        reqs.append((t0, t1))
        if i < keep:
            slots.append(i)
            kept[i] = out
        else:
            j = int(pick.integers(0, i + 1))
            if j < keep:
                kept.pop(slots[j])
                slots[j] = i
                kept[i] = out
        i += 1
    seconds = reqs[-1][1] - start
    traced = {"first": first, "count": count} if run.trace else None
    return Loop(lat, reqs, kept, seconds, traced, profile, failed)


def trace_view(run: core.Run, loop: Loop, spans: Spans, counts: dict):
    traced = set(range(loop.traced["first"],
                       loop.traced["first"] + loop.traced["count"]))
    per_request = [b - a for k, (a, b) in enumerate(loop.requests)
                   if k not in traced]
    p = loop.profile
    untraced = {name: [s for k, s in enumerate(calls) if k not in traced]
                for name, calls in spans.seconds.items()}
    return tracing.TraceView(
        ops=p["ops"], window_s=p["window_s"], busy_s=p["busy_s"],
        requests=loop.traced["count"], spans=untraced,
        per_request=per_request, counts=counts, workload=run.workload,
        breakdown=p["breakdown"], chips=run.chips)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
