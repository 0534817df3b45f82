# Frozen copy of the port's ops/groupnorm.py, plain path only: the
# benchmark's reference for the fused GN+SiLU kernel.
"""GroupNorm and GroupNorm+SiLU over NHWC input, in plain PyTorch: f32
statistics, the input dtype out."""

from __future__ import annotations

import torch


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    return gn_reference(x, gamma, beta, num_groups, eps, fuse_silu=False)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    return gn_reference(x, gamma, beta, num_groups, eps, fuse_silu=True)


def gn_reference(x, gamma, beta, num_groups: int, eps: float,
                 fuse_silu: bool) -> torch.Tensor:
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"C={c} not divisible by groups={num_groups}")
    xf = x.to(torch.float32).reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * gamma.to(torch.float32) + beta.to(torch.float32)
    if fuse_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)
