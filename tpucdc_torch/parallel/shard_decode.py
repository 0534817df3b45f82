"""Batched decode sharded over the mesh's data axis, mirroring
tpucdc/parallel/shard_decode.py.

Every rank of the mesh calls ``sharded_sample`` with the whole batch; each
decodes its slice on its card with no collective inside the chain, and one
``all_gather`` over the data group returns the whole batch to every rank.
Where JAX passes one PRNG key per image, the port takes one initial ε per
image (``noise``), drawn in image order; the η > 0 step noise is drawn from
``generator`` for the whole batch at every step, in image order, on every
rank, which then keeps its slice. Image i's decode therefore does not
depend on the number of ranks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpucdc_torch.ops.schedules import DiffusionSchedule
from tpucdc_torch.runtime.mesh import (DATA_AXIS, axis_group, axis_index,
                                       axis_size)
from tpucdc_torch.sampling import ddim_sample


class _StepNoise:
    """Step k's z for this rank's images: the whole batch's, drawn from the
    generator in step order, sliced. The sampler reads it in step order."""

    def __init__(self, generator, shape, lo: int, hi: int, device):
        self.generator, self.shape, self.device = generator, shape, device
        self.lo, self.hi = lo, hi

    def __getitem__(self, k: int) -> torch.Tensor:
        z = torch.randn(self.shape, generator=self.generator,
                        dtype=torch.float32, device=self.device)
        return z[self.lo:self.hi]


def sharded_sample(model_apply, params, schedule: DiffusionSchedule, mesh,
                   y_hat: torch.Tensor, noise: torch.Tensor,
                   image_hw: tuple[int, int], num_steps: int = 100,
                   eta: float = 0.0, x_ref_fn=None,
                   t_start: int | None = None, prediction: str = "eps",
                   blend_gamma: float = 1.0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Decode a batch of conditioning latents, the batch sharded on
    ``data``; every rank gets the whole [B, h, w, 3] result.

    model_apply: (params, y_shard, x_t, t[, x_bar]) -> net output, the
      conditioning head and the UNet for one shard (the x̄ argument is
      passed iff ``x_ref_fn`` is given).
    y_hat: [B, hy, wy, C] on this rank's device, B divisible by the data
      axis. noise: [B, h, w, 3], image i's initial ε.
    x_ref_fn: (params, y_shard) -> x̄, computed once per shard. With
      ``t_start`` the chain refines x̄ over [0, t_start]; ``num_steps == 0``
      returns x̄.
    generator: the η > 0 step noise (seed 0 on the device when None).
    """
    h, w = image_hw
    batch = y_hat.shape[0]
    n_data = axis_size(mesh, DATA_AXIS)
    if batch % n_data:
        raise ValueError(f"batch {batch} not divisible by data axis {n_data}")
    if t_start is not None and x_ref_fn is None:
        raise ValueError("t_start needs x_ref_fn (truncation refines x̄)")
    if num_steps == 0 and x_ref_fn is None:
        raise ValueError("num_steps=0 (mean decode) needs x_ref_fn "
                         "(codec.synthesis)")
    device = y_hat.device
    size = batch // n_data
    lo = axis_index(mesh, DATA_AXIS) * size
    y_shard = y_hat[lo:lo + size]
    x_bar = x_ref_fn(params, y_shard) if x_ref_fn is not None else None
    if num_steps == 0:
        x0 = x_bar
    else:
        def net_fn(x_t, t):
            if x_bar is None:
                return model_apply(params, y_shard, x_t, t)
            return model_apply(params, y_shard, x_t, t, x_bar)

        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        eps = noise[lo:lo + size]
        kw = dict(num_steps=num_steps, eta=eta, device=device,
                  prediction=prediction,
                  step_noise=_StepNoise(generator, (batch, h, w, 3), lo,
                                        lo + size, device))
        shape = (size, h, w, 3)
        if t_start is not None or prediction == "residual":
            # Truncated start from x̄ (and the residual full chain, whose
            # update needs x̄ every step): the chain starts from
            # q_sample(x̄) with this image's ε.
            x0 = ddim_sample(net_fn, schedule, shape, noise=eps,
                             t_start=t_start, x_ref=x_bar, **kw)
        else:
            x0 = ddim_sample(net_fn, schedule, shape, x_init=eps, **kw)
        if x_bar is not None:
            # Distortion-perception blend, as the single-card decode does.
            gamma = float(np.float32(blend_gamma))
            x0 = x_bar + gamma * (x0 - x_bar)
    x0 = x0.to(torch.float32).contiguous()
    return _gather(x0, mesh, n_data)


def _gather(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """Every rank's [b, ...] slice, concatenated in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=axis_group(mesh, DATA_AXIS))
    return torch.cat(parts)
