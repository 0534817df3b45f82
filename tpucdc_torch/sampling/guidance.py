"""Classifier-free guidance, mirroring tpucdc/sampling/guidance.py.

The guided net output is ``ε_u + s·(ε_c − ε_u)``. The pipelines evaluate the
conditional and the unconditional branch in one batch-doubled net call: one
launch per kernel serves both, where two calls would pay the launch cost
twice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def make_cfg_eps_fn(cond_eps_fn: Callable, uncond_eps_fn: Optional[Callable],
                    guidance_scale: float) -> Callable:
    """A net function for the samplers with classifier-free guidance.

    cond_eps_fn / uncond_eps_fn: (x_t, t) -> eps. With scale 1 or no
    unconditional branch, returns cond_eps_fn itself.
    """
    if guidance_scale == 1.0 or uncond_eps_fn is None:
        return cond_eps_fn

    def eps_fn(x_t, t):
        eps_c = cond_eps_fn(x_t, t)
        eps_u = uncond_eps_fn(x_t, t)
        return eps_u + guidance_scale * (eps_c - eps_u)

    return eps_fn


def make_batched_cfg_eps_fn(eps_fn_doubled: Callable,
                            guidance_scale: float) -> Callable:
    """Batch-doubled guidance: ``eps_fn_doubled`` carries its conditioning
    stacked [cond; uncond] along the batch, so one net call serves both."""
    def eps_fn(x_t, t):
        both = eps_fn_doubled(torch.cat([x_t, x_t], dim=0),
                              torch.cat([t, t], dim=0))
        eps_c, eps_u = both.chunk(2, dim=0)
        return eps_u + guidance_scale * (eps_c - eps_u)
    return eps_fn
