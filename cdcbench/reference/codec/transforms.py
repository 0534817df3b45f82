# Frozen copy of the port's codec/transforms.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Codec transforms: GDN/IGDN, analysis g_a, synthesis g_s, h_a and h_s.

Mirrors tpucdc/codec/transforms.py: ``g_a`` maps the image to the latent y
(16× down), ``h_a`` maps |y| to the side information z (a further 4×),
``h_s`` maps the decoded ẑ to the (μ, σ) of the Gaussian over y (or, for the
context entropy models, to their feature trunk) and ``g_s`` decodes ŷ to the
reconstruction x̄. NHWC; parameters f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cdcbench.reference.config import CodecConfig
from cdcbench.reference.ops.layers import Conv, ConvTranspose
from cdcbench.reference.runtime import DEFAULT_POLICY, Policy


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


class AnalysisTransform(nn.Module):
    """g_a: image [B,H,W,3] → latent y [B,H/16,W/16,M] (f32)."""

    def __init__(self, config: CodecConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        n = config.hidden_channels
        for i, cin in enumerate((3, n, n)):
            setattr(self, f"conv{i}", Conv(cin, n, 5, 2))
            setattr(self, f"gdn{i}", GDN(n))
        self.conv3 = Conv(n, config.latent_channels, 5, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.policy.compute_dtype
        h = x.to(dt)
        for i in range(3):
            h = getattr(self, f"conv{i}")(h, dt)
            h = getattr(self, f"gdn{i}")(h)
        return self.conv3(h, dt).to(torch.float32)


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


class HyperAnalysis(nn.Module):
    """h_a: y → z [B,H/64,W/64,Cz] (f32); it sees |y|."""

    def __init__(self, config: CodecConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        n = config.hidden_channels
        self.conv0 = Conv(config.latent_channels, n, 3)
        self.conv1 = Conv(n, n, 5, 2)
        self.conv2 = Conv(n, config.hyper_channels, 5, 2)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        dt = self.policy.compute_dtype
        h = F.silu(self.conv0(y.abs().to(dt), dt))
        h = F.silu(self.conv1(h, dt))
        return self.conv2(h, dt).to(torch.float32)


def split_mean_scale(raw: torch.Tensor, scale_min: float):
    """[..., 2C] head output → (μ, σ = max(softplus(·), scale_min)) in f32."""
    means, scales_raw = raw.to(torch.float32).chunk(2, dim=-1)
    return means, torch.clamp_min(softplus(scales_raw), scale_min)


class HyperSynthesis(nn.Module):
    """h_s: ẑ → (μ, σ) of the conditional Gaussian over y.

    With ``features=True`` (the context models' trunk) it returns the
    pre-projection feature map instead. A checkpoint trained with a context
    model never ran the projection and holds no weights for it, so ``proj``
    exists only for the "hyperprior" context.
    """

    def __init__(self, config: CodecConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.scale_min = config.scale_min
        n = config.hidden_channels
        self.deconv0 = ConvTranspose(config.hyper_channels, n, 5, 2)
        self.deconv1 = ConvTranspose(n, n, 5, 2)
        self.proj = (Conv(n, 2 * config.latent_channels, 3)
                     if config.context == "hyperprior" else None)

    def forward(self, z_hat: torch.Tensor, features: bool = False):
        dt = self.policy.compute_dtype
        h = F.silu(self.deconv0(z_hat.to(dt), dt))
        h = F.silu(self.deconv1(h, dt))
        if features:
            return h
        if self.proj is None:
            raise ValueError("h_s has no (μ, σ) projection under a context "
                             "entropy model; call it with features=True")
        return split_mean_scale(self.proj(h, dt), self.scale_min)
