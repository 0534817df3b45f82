"""Checkerboard spatial-context entropy model, mirroring
tpucdc/codec/context_model.py.

The latent y is split by spatial parity into anchors ((i+j) even) and
non-anchors. Anchors are coded from the hyper features alone; non-anchors
also see a 5×5 conv over the already-decoded anchors (the input is zero at
non-anchor positions, so nothing leaks). Decoding is two dense passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpucdc_torch.codec.passes import ContextModel, Pass
from tpucdc_torch.codec.transforms import split_mean_scale
from tpucdc_torch.ops.layers import Conv
from tpucdc_torch.runtime import DEFAULT_POLICY, Policy


class CheckerboardContext(ContextModel):
    """(hyper features, decoded anchors) → (μ, σ) for both parities."""

    def __init__(self, hidden_channels: int, latent_channels: int,
                 scale_min: float = 0.11, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.scale_min = scale_min
        c = latent_channels
        self.anchor_head = Conv(hidden_channels, 2 * c, 1)
        self.ctx_conv = Conv(c, 2 * c, 5)
        self.fuse1 = Conv(4 * c, 2 * c, 1)
        self.fuse2 = Conv(2 * c, 2 * c, 1)

    def anchor_params(self, hyper_feats: torch.Tensor):
        dt = self.policy.compute_dtype
        return split_mean_scale(self.anchor_head(hyper_feats, dt),
                                self.scale_min)

    def nonanchor_params(self, hyper_feats: torch.Tensor,
                         y_anchor_masked: torch.Tensor):
        """y_anchor_masked: ŷ with non-anchor positions zeroed."""
        dt = self.policy.compute_dtype
        ctx = self.ctx_conv(y_anchor_masked, dt)
        h = torch.cat([self.anchor_head(hyper_feats, dt), ctx], dim=-1)
        h = F.silu(self.fuse1(h, dt))
        return split_mean_scale(self.fuse2(h, dt), self.scale_min)

    def passes(self) -> list[Pass]:
        """The anchors, then the non-anchors given the decoded anchors."""
        every = slice(None)
        return [Pass(every, True, lambda f, y_prev, y_anchor:
                     self.anchor_params(f)),
                Pass(every, False, lambda f, y_prev, y_anchor:
                     self.nonanchor_params(f, y_anchor))]
