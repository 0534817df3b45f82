"""DDIM sampler, mirroring tpucdc/sampling/ddim.py.

The per-step tables (ᾱ_t, ᾱ_prev, σ_t, timesteps) are computed once on the
host in float64 and stored as float32, as in the JAX package; the loop over
steps is a Python loop. The JAX sampler draws its noise from threefry keys,
which PyTorch cannot reproduce: here the initial ε (and, when η > 0, each
step's z) is injected by the caller or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpucdc_torch.ops.schedules import DiffusionSchedule, ddim_subsequence

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


def ddim_sample(net_fn: NetFn, schedule: DiffusionSchedule, shape,
                num_steps: int = 50, eta: float = 0.0,
                noise: Optional[torch.Tensor] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                device="cpu",
                x_ref: Optional[torch.Tensor] = None,
                t_start: int | None = None,
                clip_x0: bool = True,
                tables: dict | None = None,
                prediction: str = "eps") -> torch.Tensor:
    """Run DDIM to x₀. ``shape`` is NHWC [B, H, W, 3].

    ``noise`` is the initial ε (drawn from ``generator`` when None). With
    ``x_ref`` (truncated refinement) the chain starts from
    sqrt(ᾱ₀)·x_ref + sqrt(1-ᾱ₀)·ε, otherwise from ε. When η > 0 each step
    adds σ_t·z with z from ``step_noise[k]`` or the generator.
    """
    if tables is None:
        tables = ddim_step_tables(schedule, num_steps, eta, t_start)
    if prediction == "residual" and x_ref is None:
        raise ValueError("prediction='residual' needs x_ref (the synthesis "
                         "reconstruction the net's output perturbs)")

    def draw(given):
        if given is not None:
            return given.to(device=device, dtype=torch.float32)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)

    eps0 = draw(noise)
    first = _row(tables, 0)
    if x_ref is not None:
        x = (first["sqrt_ab"] * x_ref.to(torch.float32)
             + first["sqrt_one_minus_ab"] * eps0)
    else:
        x = eps0
    b = shape[0]
    for k in range(len(tables["t"])):
        tab = _row(tables, k)
        t_vec = torch.full((b,), tab["t"], dtype=torch.int32, device=device)
        out = net_fn(x, t_vec).to(torch.float32)
        z = None
        if tab["sigma"] != 0.0:
            z = draw(None if step_noise is None else step_noise[k])
        x = _ddim_update(x, out, tab, z, clip_x0, prediction, x_ref)
    return x
