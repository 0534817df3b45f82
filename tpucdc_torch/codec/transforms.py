"""Decode-side codec transforms: GDN/IGDN, synthesis g_s and hyper-synthesis h_s.

Mirrors tpucdc/codec/transforms.py. The analysis transforms g_a and h_a
belong to the encode slice and are not ported yet. NHWC; parameters f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpucdc_torch.config import CodecConfig
from tpucdc_torch.ops.layers import Conv, ConvTranspose
from tpucdc_torch.runtime import DEFAULT_POLICY, Policy


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (logaddexp(x, 0)) operation for operation."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


class GDN(nn.Module):
    """Generalized divisive normalization over channels (inverse = IGDN).

    y_c = x_c / sqrt(β_c + Σ_k γ_kc x_k²) with β = β_r² + 1e-6, γ = γ_r²;
    computed in f32, output in the input dtype.
    """

    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self.beta_r = nn.Parameter(torch.ones(channels))
        self.gamma_r = nn.Parameter(0.1 * torch.eye(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = self.beta_r * self.beta_r + 1e-6
        gamma = self.gamma_r * self.gamma_r
        xf = x.to(torch.float32)
        norm = torch.matmul(xf * xf, gamma) + beta
        out = xf * torch.sqrt(norm) if self.inverse else xf * torch.rsqrt(norm)
        return out.to(x.dtype)


class SynthesisTransform(nn.Module):
    """g_s: latent ŷ [B,H/16,W/16,M] → reconstruction x̄ [B,H,W,3] (f32)."""

    def __init__(self, config: CodecConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        n, m = config.hidden_channels, config.latent_channels
        for i, cin in enumerate((m, n, n)):
            setattr(self, f"deconv{i}", ConvTranspose(cin, n, 5, 2))
            setattr(self, f"igdn{i}", GDN(n, inverse=True))
        self.deconv3 = ConvTranspose(n, 3, 5, 2)

    def forward(self, y_hat: torch.Tensor) -> torch.Tensor:
        dt = self.policy.compute_dtype
        h = y_hat.to(dt)
        for i in range(3):
            h = getattr(self, f"deconv{i}")(h, dt)
            h = getattr(self, f"igdn{i}")(h)
        return self.deconv3(h, dt).to(torch.float32)


class HyperSynthesis(nn.Module):
    """h_s: ẑ → (μ, σ) of the conditional Gaussian over y."""

    def __init__(self, config: CodecConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.scale_min = config.scale_min
        n = config.hidden_channels
        self.deconv0 = ConvTranspose(config.hyper_channels, n, 5, 2)
        self.deconv1 = ConvTranspose(n, n, 5, 2)
        self.proj = Conv(n, 2 * config.latent_channels, 3)

    def forward(self, z_hat: torch.Tensor):
        dt = self.policy.compute_dtype
        h = F.silu(self.deconv0(z_hat.to(dt), dt))
        h = F.silu(self.deconv1(h, dt))
        h = self.proj(h, dt).to(torch.float32)
        means, scales_raw = h.chunk(2, dim=-1)
        scales = torch.clamp_min(softplus(scales_raw), self.scale_min)
        return means, scales
