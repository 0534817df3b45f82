# Frozen copy of the port's diffusion/conditioning.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Conditioning head: decoded latent ŷ → UNet conditioning signal.

Mirrors tpucdc/diffusion/conditioning.py: a stem conv, GN+SiLU, a token
projection for cross-attention, then ×2 upsampling stages up to the UNet's
post-patch grid, each followed by GN+SiLU, and an output conv. A stage is a
nearest ×2 upsample then a conv (``"repeat"``), or a conv at the low
resolution to 4·ch then depth-to-space ×2 (``"shuffle"``).
Its GN+SiLU blocks use the default target of 32 groups (not the UNet's), so
``_num_groups`` gives 32 groups at 96 and 32 channels and 24 at 48.
"""

from __future__ import annotations

import torch
from torch import nn

from cdcbench.reference.config import ConditioningConfig
from cdcbench.reference.diffusion.blocks import GNSiLU
from cdcbench.reference.ops.layers import Conv, Dense, upsample_nearest2x
from cdcbench.reference.runtime import DEFAULT_POLICY, Policy


class ConditioningHead(nn.Module):
    """ŷ [B, Hy, Wy, Cy] → (features [B, Hy·f, Wy·f, Cf], tokens [B, Hy·Wy, D])."""

    def __init__(self, config: ConditioningConfig, latent_channels: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = self.config = config
        if cfg.upsample not in ("repeat", "shuffle"):
            raise ValueError(f"unknown conditioning upsample {cfg.upsample!r}")
        self.policy = policy
        self.stem = Conv(latent_channels, cfg.hidden_channels, 3)
        self.stem_norm = GNSiLU(cfg.hidden_channels, policy=policy)
        self.token_proj = Dense(cfg.hidden_channels, cfg.token_dim)
        up_factor = cfg.latent_factor // cfg.output_stride
        stages = up_factor.bit_length() - 1
        if 2 ** stages != up_factor:
            raise ValueError("latent_factor/output_stride must be a power of 2")
        ch = cfg.hidden_channels
        self.stages = stages
        for s in range(stages):
            out = max(cfg.feature_channels, ch // 2)
            conv_out = 4 * out if cfg.upsample == "shuffle" else out
            setattr(self, f"up{s}", Conv(ch, conv_out, 3))
            setattr(self, f"up{s}_norm", GNSiLU(out, policy=policy))
            ch = out
        self.out = Conv(ch, cfg.feature_channels, 3)

    def forward(self, y_hat: torch.Tensor):
        dt = self.policy.compute_dtype
        h = self.stem(self.policy.cast_to_compute(y_hat), dt)
        h = self.stem_norm(h)
        tokens = self.token_proj(h.reshape(h.shape[0], -1, h.shape[-1]), dt)
        for s in range(self.stages):
            conv = getattr(self, f"up{s}")
            if self.config.upsample == "shuffle":
                h = _depth_to_space2x(conv(h, dt))
            else:
                h = conv(upsample_nearest2x(h), dt)
            h = getattr(self, f"up{s}_norm")(h)
        return self.out(h, dt), tokens


def _depth_to_space2x(h: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 4c] → [B, 2H, 2W, c], channel (py·2 + px)·c + k going to
    row 2i+py, column 2j+px: the JAX package's reshape and transpose."""
    b, hh, ww, cc = h.shape
    h = h.reshape(b, hh, ww, 2, 2, cc // 4).permute(0, 1, 3, 2, 4, 5)
    return h.reshape(b, hh * 2, ww * 2, cc // 4)
