# Frozen copy of the port's diffusion/blocks.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""UNet building blocks: GN+SiLU, ResBlock, attention blocks, resampling.

Mirrors tpucdc/diffusion/blocks.py module for module and parameter for
parameter (names included, so flax checkpoints map onto them mechanically).
NHWC throughout; parameters f32, compute in the policy's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cdcbench.reference.ops import attention, group_norm, group_norm_silu
from cdcbench.reference.ops.layers import Conv, Dense, upsample_nearest2x
from cdcbench.reference.runtime import DEFAULT_POLICY, Policy


def _num_groups(channels: int, target: int = 32) -> int:
    g = min(target, channels)
    while channels % g:
        g -= 1
    return g


class GNSiLU(nn.Module):
    """GroupNorm+SiLU with learned affine; the fused kernel on the card."""

    def __init__(self, channels: int, groups: int = 32,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.num_groups = _num_groups(channels, groups)
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.policy = policy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x.contiguous(), self.scale, self.bias,
                               self.num_groups)


class ResBlock(nn.Module):
    """GN+SiLU → 3×3 conv → time-FiLM → GN → (1+s)·h+b → SiLU → 3×3 conv → +skip."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 groups: int = 32, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.norm1 = GNSiLU(in_channels, groups, policy)
        self.conv1 = Conv(in_channels, out_channels, 3)
        self.temb_proj = Dense(temb_dim, 2 * out_channels)
        self.norm2_groups = _num_groups(out_channels, groups)
        self.norm2_scale = nn.Parameter(torch.ones(out_channels))
        self.norm2_bias = nn.Parameter(torch.zeros(out_channels))
        self.conv2 = Conv(out_channels, out_channels, 3)
        self.skip = (Conv(in_channels, out_channels, 1)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        dt = self.policy.compute_dtype
        h = self.norm1(x)
        h = self.conv1(h, dt)
        emb = self.temb_proj(F.silu(temb), dt)[:, None, None, :]
        scale, shift = emb.chunk(2, dim=-1)
        h = group_norm(h, self.norm2_scale, self.norm2_bias, self.norm2_groups)
        h = F.silu(h * (1 + scale) + shift)
        h = self.conv2(h, dt)
        if self.skip is not None:
            x = self.skip(x, dt)
        return x + h


class AttentionBlock(nn.Module):
    """Pre-norm multi-head attention with a residual; self-attention, or
    cross-attention with K/V from ``context`` (the conditioning tokens)."""

    def __init__(self, channels: int, context_dim: Optional[int] = None,
                 num_heads: int = 4, groups: int = 32,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.num_heads = num_heads
        self.num_groups = _num_groups(channels, groups)
        self.norm_scale = nn.Parameter(torch.ones(channels))
        self.norm_bias = nn.Parameter(torch.zeros(channels))
        kv_dim = channels if context_dim is None else context_dim
        self.q = Dense(channels, channels)
        self.k = Dense(kv_dim, channels)
        self.v = Dense(kv_dim, channels)
        self.proj = Dense(channels, channels)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.policy.compute_dtype
        b, hgt, wid, c = x.shape
        h = group_norm(x, self.norm_scale, self.norm_bias, self.num_groups)
        tokens = h.reshape(b, hgt * wid, c)
        kv_src = tokens if context is None else context

        def heads(t):
            # The [B, H, N, d] view of a [B, N, H·d] projection: no copy.
            return t.reshape(b, t.shape[1], self.num_heads,
                             c // self.num_heads).transpose(1, 2)

        out = attention(heads(self.q(tokens, dt)), heads(self.k(kv_src, dt)),
                        heads(self.v(kv_src, dt)))
        # attention stores its result as [B, N, H, d]: this reshape is a view.
        out = out.transpose(1, 2).reshape(b, hgt * wid, c)
        out = self.proj(out, dt)
        return x + out.reshape(b, hgt, wid, c)


class Downsample(nn.Module):
    """2× strided-conv downsample (flax "SAME": pads (0, 1) on even input)."""

    def __init__(self, channels: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.conv = Conv(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.policy.compute_dtype)


class Upsample(nn.Module):
    """2× nearest-neighbor upsample + 3×3 conv."""

    def __init__(self, channels: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.conv = Conv(channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest2x(x), self.policy.compute_dtype)
