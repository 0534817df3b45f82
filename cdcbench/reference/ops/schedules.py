# Frozen copy of the port's ops/schedules.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Diffusion noise schedules as host tables (numpy copy of tpucdc/ops/schedules.py).

Every per-timestep quantity is built once in float64 and stored as float32,
exactly as the JAX package does, so the two packages index identical tables.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

ScheduleKind = Literal["linear", "cosine"]


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep tables for a T-step diffusion process ((T,) f32)."""
    betas: np.ndarray
    alphas: np.ndarray
    alpha_bars: np.ndarray            # cumulative product of alphas
    alpha_bars_prev: np.ndarray       # alpha_bar[t-1], 1.0 at t=0
    sqrt_alpha_bars: np.ndarray
    sqrt_one_minus_alpha_bars: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance: np.ndarray   # clipped at t=0
    posterior_mean_coef_x0: np.ndarray
    posterior_mean_coef_xt: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.betas.shape[0])


def _linear_betas(T: int, beta_start: float, beta_end: float) -> np.ndarray:
    scale = 1000.0 / T
    betas = np.linspace(scale * beta_start, scale * beta_end, T, dtype=np.float64)
    return np.clip(betas, 1e-8, 0.999)


def _cosine_betas(T: int, s: float = 0.008, max_beta: float = 0.999) -> np.ndarray:
    # Nichol & Dhariwal cosine schedule: alpha_bar(t) ∝ cos²((t/T+s)/(1+s)·π/2).
    steps = np.arange(T + 1, dtype=np.float64) / T
    f = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
    alpha_bars = f / f[0]
    betas = 1.0 - alpha_bars[1:] / alpha_bars[:-1]
    return np.clip(betas, 0.0, max_beta)


def make_schedule(kind: ScheduleKind = "cosine", num_steps: int = 1000,
                  beta_start: float = 1e-4, beta_end: float = 2e-2) -> DiffusionSchedule:
    """Build the full table set for a ``linear`` or ``cosine`` schedule."""
    if kind == "linear":
        betas = _linear_betas(num_steps, beta_start, beta_end)
    elif kind == "cosine":
        betas = _cosine_betas(num_steps)
    else:
        raise ValueError(f"unknown schedule kind: {kind!r}")

    alphas = 1.0 - betas
    alpha_bars = np.cumprod(alphas)
    alpha_bars_prev = np.concatenate([[1.0], alpha_bars[:-1]])

    posterior_variance = betas * (1.0 - alpha_bars_prev) / (1.0 - alpha_bars)
    posterior_log_variance = np.log(
        np.concatenate([[posterior_variance[1]], posterior_variance[1:]])
        if num_steps > 1 else np.maximum(posterior_variance, 1e-20))
    coef_x0 = betas * np.sqrt(alpha_bars_prev) / (1.0 - alpha_bars)
    coef_xt = (1.0 - alpha_bars_prev) * np.sqrt(alphas) / (1.0 - alpha_bars)

    as_f32 = lambda a: np.asarray(a, np.float32)
    return DiffusionSchedule(
        betas=as_f32(betas),
        alphas=as_f32(alphas),
        alpha_bars=as_f32(alpha_bars),
        alpha_bars_prev=as_f32(alpha_bars_prev),
        sqrt_alpha_bars=as_f32(np.sqrt(alpha_bars)),
        sqrt_one_minus_alpha_bars=as_f32(np.sqrt(1.0 - alpha_bars)),
        posterior_variance=as_f32(posterior_variance),
        posterior_log_variance=as_f32(posterior_log_variance),
        posterior_mean_coef_x0=as_f32(coef_x0),
        posterior_mean_coef_xt=as_f32(coef_xt),
    )


def ddim_subsequence(num_train_steps: int, num_sample_steps: int,
                     t_max: int | None = None) -> np.ndarray:
    """Evenly spaced timestep subsequence for DDIM, descending (t_max → 0)."""
    t_max = num_train_steps - 1 if t_max is None else int(t_max)
    if not 0 <= t_max < num_train_steps:
        raise ValueError(f"t_max {t_max} outside [0, {num_train_steps - 1}]")
    if not 1 <= num_sample_steps <= t_max + 1:
        raise ValueError("need 1 <= sample steps <= t_max + 1")
    ts = np.linspace(0, t_max, num_sample_steps)
    return np.unique(np.round(ts)).astype(np.int32)[::-1].copy()
