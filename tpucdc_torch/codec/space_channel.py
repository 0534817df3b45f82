"""Combined space-channel context entropy model, mirroring
tpucdc/codec/space_channel.py.

Channels split into ``num_groups`` groups and, within each group, a spatial
checkerboard. Group g's anchors condition on the hyper features and all
decoded prior groups; its non-anchors also see a conv over the group's own
decoded anchors. Decoding is 2·G dense passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpucdc_torch.codec.channel_context import group_size
from tpucdc_torch.codec.passes import ContextModel, Pass
from tpucdc_torch.codec.transforms import split_mean_scale
from tpucdc_torch.ops.layers import Conv
from tpucdc_torch.runtime import DEFAULT_POLICY, Policy


class SpaceChannelContext(ContextModel):

    def __init__(self, hidden_channels: int, latent_channels: int,
                 num_groups: int = 4, scale_min: float = 0.11,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.scale_min = scale_min
        self.num_groups = num_groups
        mg = self.group_size = group_size(latent_channels, num_groups)
        self.anchor_heads = nn.ModuleList(
            nn.ModuleList([Conv(hidden_channels + g * mg, 2 * mg, 3),
                           Conv(2 * mg, 2 * mg, 1)])
            for g in range(num_groups))
        self.ctx_convs = nn.ModuleList(
            Conv(mg, 2 * mg, 5) for _ in range(num_groups))
        self.fuse = nn.ModuleList(
            nn.ModuleList([Conv(4 * mg, 2 * mg, 1), Conv(2 * mg, 2 * mg, 1)])
            for _ in range(num_groups))

    def _base(self, group: int, hyper_feats, y_prev) -> torch.Tensor:
        dt = self.policy.compute_dtype
        h = torch.cat([hyper_feats.to(dt), y_prev.to(dt)], dim=-1)
        c3, c1 = self.anchor_heads[group]
        return c1(F.silu(c3(h, dt)), dt)

    def anchor_params(self, group: int, hyper_feats: torch.Tensor,
                      y_prev: torch.Tensor):
        """Group ``group`` anchors: hyper features + decoded prior groups."""
        return split_mean_scale(self._base(group, hyper_feats, y_prev),
                                self.scale_min)

    def nonanchor_params(self, group: int, hyper_feats: torch.Tensor,
                         y_prev: torch.Tensor,
                         y_group_anchor_masked: torch.Tensor):
        """Group ``group`` non-anchors: + a conv over its own anchors."""
        dt = self.policy.compute_dtype
        ctx = self.ctx_convs[group](y_group_anchor_masked, dt)
        base = self._base(group, hyper_feats, y_prev)
        f1, f2 = self.fuse[group]
        h = F.silu(f1(torch.cat([base, ctx], dim=-1), dt))
        return split_mean_scale(f2(h, dt), self.scale_min)

    def passes(self) -> list[Pass]:
        """Per group, its anchors, then its non-anchors."""
        mg, out = self.group_size, []
        for g in range(self.num_groups):
            channels = slice(g * mg, (g + 1) * mg)
            out += [Pass(channels, True, lambda f, y_prev, y_anchor, g=g:
                         self.anchor_params(g, f, y_prev)),
                    Pass(channels, False, lambda f, y_prev, y_anchor, g=g:
                         self.nonanchor_params(g, f, y_prev, y_anchor))]
        return out
