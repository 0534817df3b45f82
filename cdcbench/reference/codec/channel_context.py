# Frozen copy of the port's codec/channel_context.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Channel-group autoregressive entropy model, mirroring
tpucdc/codec/channel_context.py.

The latent's M channels split into ``num_groups`` equal groups; group g's
(μ, σ) condition on the hyper features and the decoded groups 0..g-1.
Decoding is ``num_groups`` dense passes over the whole grid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cdcbench.reference.codec.transforms import split_mean_scale
from cdcbench.reference.ops.layers import Conv
from cdcbench.reference.runtime import DEFAULT_POLICY, Policy


def group_size(latent_channels: int, num_groups: int) -> int:
    if latent_channels % num_groups:
        raise ValueError("latent_channels must divide into num_groups")
    return latent_channels // num_groups


class ChannelARContext(nn.Module):
    """(hyper features, decoded prior groups) → per-group (μ, σ)."""

    def __init__(self, hidden_channels: int, latent_channels: int,
                 num_groups: int = 4, scale_min: float = 0.11,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.scale_min = scale_min
        self.num_groups = num_groups
        mg = self.group_size = group_size(latent_channels, num_groups)
        self.heads = nn.ModuleList(
            nn.ModuleList([Conv(hidden_channels + g * mg, 2 * mg, 3),
                           Conv(2 * mg, 2 * mg, 1)])
            for g in range(num_groups))

    def group_params(self, group: int, hyper_feats: torch.Tensor,
                     y_prev: torch.Tensor):
        """(μ, σ) of channel group ``group``.

        y_prev: [B, hy, wy, group·Mg], the decoded groups 0..group-1 (zero
        channels wide for group 0).
        """
        dt = self.policy.compute_dtype
        h = torch.cat([hyper_feats.to(dt), y_prev.to(dt)], dim=-1)
        conv3, conv1 = self.heads[group]
        return split_mean_scale(conv1(F.silu(conv3(h, dt)), dt),
                                self.scale_min)

    def forward(self, hyper_feats: torch.Tensor, y_tilde: torch.Tensor):
        """Full (μ, σ) over all groups, each group's context taken from
        y_tilde's prior groups."""
        mg = self.group_size
        means, scales = [], []
        for g in range(self.num_groups):
            m, s = self.group_params(g, hyper_feats, y_tilde[..., :g * mg])
            means.append(m)
            scales.append(s)
        return torch.cat(means, -1), torch.cat(scales, -1)
