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

from tpucdc_torch.codec.passes import ContextModel, Pass
from tpucdc_torch.codec.transforms import split_mean_scale
from tpucdc_torch.ops.layers import Conv
from tpucdc_torch.runtime import DEFAULT_POLICY, Policy


def group_size(latent_channels: int, num_groups: int) -> int:
    if latent_channels % num_groups:
        raise ValueError("latent_channels must divide into num_groups")
    return latent_channels // num_groups


class ChannelARContext(ContextModel):
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

    def passes(self) -> list[Pass]:
        """One pass a group, given the decoded groups before it."""
        mg = self.group_size
        return [Pass(slice(g * mg, (g + 1) * mg), None,
                     lambda f, y_prev, y_anchor, g=g:
                     self.group_params(g, f, y_prev))
                for g in range(self.num_groups)]
