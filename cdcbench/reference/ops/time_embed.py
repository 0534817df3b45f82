# Frozen copy of the port's ops/time_embed.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Sinusoidal timestep embedding (cos first, then sin, as the JAX package)."""

from __future__ import annotations

import math

import torch


def sinusoidal_time_embed(t: torch.Tensor, dim: int,
                          max_period: float = 10000.0) -> torch.Tensor:
    """Transformer-style sinusoidal embedding of (possibly fractional) steps.

    t: [...] float or int tensor of timesteps. Returns [..., dim] f32.
    """
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.to(torch.float32)[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
