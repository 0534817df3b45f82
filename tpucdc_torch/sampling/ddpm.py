"""DDPM ancestral sampler, mirroring tpucdc/sampling/ddpm.py.

All T steps in descending order as a Python loop; every per-step quantity is
read from the schedule's host tables. As in ``ddim_sample`` the initial ε and
each step's z are injected by the caller or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpucdc_torch.ops.schedules import DiffusionSchedule
from tpucdc_torch.runtime.device import resolve_device
from tpucdc_torch.sampling.ddim import NetFn, make_draw


def ddpm_sample(eps_fn: NetFn, schedule: DiffusionSchedule, shape,
                noise: Optional[torch.Tensor] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                device="cuda", clip_x0: bool = True) -> torch.Tensor:
    """Ancestral sampling from pure noise over all ``schedule.num_steps``.

    ``noise`` is x_T; ``step_noise[k]`` is the z of the k-th step taken
    (t = T-1-k). The step at t = 0 adds no noise, but draws its z all the
    same so that a generator's stream does not depend on it.
    """
    device = resolve_device(device)
    draw = make_draw(shape, generator, device)
    x = draw(noise)
    T = schedule.num_steps
    for k, t in enumerate(range(T - 1, -1, -1)):
        t_vec = torch.full((shape[0],), t, dtype=torch.int32, device=device)
        eps = eps_fn(x, t_vec).to(torch.float32)
        x0 = ((x - float(schedule.sqrt_one_minus_alpha_bars[t]) * eps)
              / float(schedule.sqrt_alpha_bars[t]))
        if clip_x0:
            x0 = torch.clamp(x0, -1.0, 1.0)
        x = (float(schedule.posterior_mean_coef_x0[t]) * x0
             + float(schedule.posterior_mean_coef_xt[t]) * x)
        z = draw(None if step_noise is None else step_noise[k])
        if t > 0:
            # exp in f32, as the JAX package takes it.
            std = np.exp(np.float32(0.5) * schedule.posterior_log_variance[t])
            x = x + float(std) * z
    return x
