# Frozen copy of the port's codec/context_model.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Checkerboard spatial-context entropy model, mirroring
tpucdc/codec/context_model.py.

The latent y is split by spatial parity into anchors ((i+j) even) and
non-anchors. Anchors are coded from the hyper features alone; non-anchors
also see a 5×5 conv over the already-decoded anchors (the input is zero at
non-anchor positions, so nothing leaks). Decoding is two dense passes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cdcbench.reference.codec.transforms import split_mean_scale
from cdcbench.reference.ops.layers import Conv
from cdcbench.reference.runtime import DEFAULT_POLICY, Policy


def checkerboard_mask(h: int, w: int, anchor: bool) -> np.ndarray:
    """[h, w, 1] float mask; anchor=True selects (i+j) even positions."""
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    m = ((ii + jj) % 2 == 0) if anchor else ((ii + jj) % 2 == 1)
    return m.astype(np.float32)[..., None]


class CheckerboardContext(nn.Module):
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

    def forward(self, hyper_feats: torch.Tensor, y_hat: torch.Tensor):
        """Full (μ, σ) maps for both parities; non-anchors condition on
        y_hat's anchors only."""
        a_mask = torch.from_numpy(checkerboard_mask(
            y_hat.shape[1], y_hat.shape[2], anchor=True)).to(y_hat.device)
        m_a, s_a = self.anchor_params(hyper_feats)
        m_na, s_na = self.nonanchor_params(hyper_feats, y_hat * a_mask)
        means = m_a * a_mask + m_na * (1 - a_mask)
        scales = s_a * a_mask + s_na * (1 - a_mask)
        return means, scales
