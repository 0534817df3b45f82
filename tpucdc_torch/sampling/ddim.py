"""DDIM sampler, mirroring tpucdc/sampling/ddim.py.

The per-step tables (ᾱ_t, ᾱ_prev, σ_t, timesteps) are computed once on the
host in float64 and stored as float32, as in the JAX package; the loop over
steps is a Python loop, shared by the plain and the block-cached sampler. The
JAX sampler draws its noise from threefry keys, which PyTorch cannot
reproduce: here the initial ε (and, when η > 0, each step's z) is injected by
the caller or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpucdc_torch.ops.schedules import DiffusionSchedule, ddim_subsequence
from tpucdc_torch.runtime.device import resolve_device
from tpucdc_torch.utils.profiling import span

NetFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x_t, t) -> out


def ddim_step_tables(schedule: DiffusionSchedule, num_steps: int,
                     eta: float = 0.0, t_start: int | None = None) -> dict:
    """Host-side per-step scalar tables, as [K] numpy arrays (f32, t int32)."""
    ab_full = np.asarray(schedule.alpha_bars, dtype=np.float64)
    ts = ddim_subsequence(schedule.num_steps, num_steps, t_max=t_start)
    ab = ab_full[ts]
    ab_prev = np.concatenate([ab_full[ts[1:]], [1.0]])         # final step → ᾱ=1
    sigma = eta * np.sqrt((1 - ab_prev) / (1 - ab)) * np.sqrt(1 - ab / ab_prev)
    f32 = lambda a: np.asarray(a, np.float32)
    return {
        "t": np.asarray(ts, np.int32),
        "sqrt_ab": f32(np.sqrt(ab)),
        "sqrt_one_minus_ab": f32(np.sqrt(1 - ab)),
        "sqrt_ab_prev": f32(np.sqrt(ab_prev)),
        "dir_coef": f32(np.sqrt(np.maximum(1 - ab_prev - sigma**2, 0.0))),
        "sigma": f32(sigma),
    }


def _row(tables: dict, k: int) -> dict:
    """Step k's scalars as Python floats (exactly the stored f32 values)."""
    return {name: (int(v[k]) if name == "t" else float(v[k]))
            for name, v in tables.items()}


def _ddim_update(x, out, tab, z=None, clip_x0=True, prediction="eps",
                 x_ref=None):
    """One DDIM step from the net output under any parameterization.

    "eps": out is ε̂. "x0": out IS x₀. "residual": x₀ = x_ref + out. ``z`` is
    the step's noise, needed only when ``tab["sigma"]`` is non-zero.
    """
    if prediction in ("x0", "residual"):
        x0 = out if prediction == "x0" else x_ref.to(torch.float32) + out
        if clip_x0:
            x0 = torch.clamp(x0, -1.0, 1.0)
        eps = (x - tab["sqrt_ab"] * x0) / max(tab["sqrt_one_minus_ab"], 1e-4)
    else:
        eps = out
        x0 = (x - tab["sqrt_one_minus_ab"] * eps) / tab["sqrt_ab"]
        if clip_x0:
            x0 = torch.clamp(x0, -1.0, 1.0)
    x_prev = tab["sqrt_ab_prev"] * x0 + tab["dir_coef"] * eps
    if tab["sigma"] != 0.0:
        x_prev = x_prev + tab["sigma"] * z
    return x_prev


def make_draw(shape, generator: Optional[torch.Generator],
              device: torch.device) -> Callable:
    """``draw(given)``: ``given`` as f32 on ``device``, or a fresh standard
    normal of ``shape`` from ``generator`` when it is None."""
    def draw(given: Optional[torch.Tensor] = None) -> torch.Tensor:
        if given is not None:
            return given.to(device=device, dtype=torch.float32)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)
    return draw


def _chain_start(tables: dict, draw, noise, x_ref, x_init, prediction):
    """x at the first subsequence timestep, for both DDIM loops.

    With ``x_ref`` the chain starts from q_sample(x_ref) drawn with the
    initial ε; ``x_init`` is taken as x already at that timestep; with neither
    the chain starts from ε.
    """
    if prediction == "residual" and x_ref is None:
        raise ValueError("prediction='residual' needs x_ref (the synthesis "
                         "reconstruction the net's output perturbs)")
    if x_ref is not None:
        if x_init is not None:
            raise ValueError("pass x_init or x_ref, not both")
        first = _row(tables, 0)
        return (first["sqrt_ab"] * x_ref.to(torch.float32)
                + first["sqrt_one_minus_ab"] * draw(noise))
    return draw(noise) if x_init is None else draw(x_init)


def ddim_sample(net_fn: NetFn, schedule: DiffusionSchedule, shape,
                num_steps: int = 50, eta: float = 0.0,
                noise: Optional[torch.Tensor] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                device="cuda",
                x_init: Optional[torch.Tensor] = None,
                x_ref: Optional[torch.Tensor] = None,
                t_start: int | None = None,
                clip_x0: bool = True,
                tables: dict | None = None,
                prediction: str = "eps") -> torch.Tensor:
    """Run DDIM to x₀ on ``device`` (the card unless the caller names the
    CPU). ``shape`` is NHWC [B, H, W, 3].

    ``noise`` is the initial ε (drawn from ``generator`` when None). With
    ``x_ref`` (truncated refinement) the chain starts from
    sqrt(ᾱ₀)·x_ref + sqrt(1-ᾱ₀)·ε; ``x_init`` (not both) is x already at the
    first timestep; otherwise the chain starts from ε. When η > 0 each step
    adds σ_t·z with z from ``step_noise[k]`` or the generator.
    """
    return _ddim_loop(lambda k, x, t, cache: (net_fn(x, t), cache), schedule,
                      shape, num_steps, eta, noise, step_noise, generator,
                      device, x_init, x_ref, t_start, clip_x0, tables,
                      prediction)


def ddim_sample_blockcached(fresh_fn, cached_fn, schedule: DiffusionSchedule,
                            shape, num_steps: int = 50, cache_period: int = 2,
                            eta: float = 0.0,
                            noise: Optional[torch.Tensor] = None,
                            step_noise: Optional[Sequence[torch.Tensor]] = None,
                            generator: Optional[torch.Generator] = None,
                            device="cuda",
                            x_init: Optional[torch.Tensor] = None,
                            x_ref: Optional[torch.Tensor] = None,
                            t_start: int | None = None,
                            clip_x0: bool = True,
                            tables: dict | None = None,
                            prediction: str = "eps") -> torch.Tensor:
    """DDIM with deep-block caching, mirroring JAX's sampler of that name.

    Step k runs the full net and refreshes the deep cache when
    ``k % cache_period == 0``; the steps in between reuse it and run only the
    shallow levels. Everything else follows ``ddim_sample``.

    fresh_fn:  (x_t, t) -> (net output, cache)
    cached_fn: (x_t, t, cache) -> net output
    """
    if cache_period < 1:
        raise ValueError(f"cache_period must be >= 1: {cache_period}")

    def net(k, x, t, cache):
        if k % cache_period == 0:
            return fresh_fn(x, t)
        return cached_fn(x, t, cache), cache

    return _ddim_loop(net, schedule, shape, num_steps, eta, noise, step_noise,
                      generator, device, x_init, x_ref, t_start, clip_x0,
                      tables, prediction)


def _ddim_loop(net, schedule, shape, num_steps, eta, noise, step_noise,
               generator, device, x_init, x_ref, t_start, clip_x0, tables,
               prediction):
    """The DDIM chain; ``net(k, x, t, cache) -> (net output, cache)``."""
    device = resolve_device(device)
    if tables is None:
        tables = ddim_step_tables(schedule, num_steps, eta, t_start)
    draw = make_draw(shape, generator, device)
    x = _chain_start(tables, draw, noise, x_ref, x_init, prediction)
    cache = None
    for k in range(len(tables["t"])):
        with span("ddim.step"):
            tab = _row(tables, k)
            t_vec = torch.full((shape[0],), tab["t"], dtype=torch.int32,
                               device=device)
            out, cache = net(k, x, t_vec, cache)
            with span("ddim.update"):
                z = None
                if tab["sigma"] != 0.0:
                    z = draw(None if step_noise is None else step_noise[k])
                x = _ddim_update(x, out.to(torch.float32), tab, z, clip_x0,
                                 prediction, x_ref)
    return x
