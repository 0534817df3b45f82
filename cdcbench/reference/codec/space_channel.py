# Frozen copy of the port's codec/space_channel.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
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

from cdcbench.reference.codec.channel_context import group_size
from cdcbench.reference.codec.context_model import checkerboard_mask
from cdcbench.reference.codec.transforms import split_mean_scale
from cdcbench.reference.ops.layers import Conv
from cdcbench.reference.runtime import DEFAULT_POLICY, Policy


class SpaceChannelContext(nn.Module):

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

    def forward(self, hyper_feats: torch.Tensor, y_tilde: torch.Tensor):
        """Full (μ, σ); each position's parameters use only its causal
        context (prior groups + same-group anchors)."""
        am = torch.from_numpy(checkerboard_mask(
            y_tilde.shape[1], y_tilde.shape[2], anchor=True)).to(y_tilde.device)
        mg = self.group_size
        means, scales = [], []
        for g in range(self.num_groups):
            y_prev = y_tilde[..., :g * mg]
            y_g = y_tilde[..., g * mg:(g + 1) * mg]
            m_a, s_a = self.anchor_params(g, hyper_feats, y_prev)
            m_na, s_na = self.nonanchor_params(g, hyper_feats, y_prev,
                                               y_g * am)
            means.append(m_a * am + m_na * (1 - am))
            scales.append(s_a * am + s_na * (1 - am))
        return torch.cat(means, -1), torch.cat(scales, -1)
