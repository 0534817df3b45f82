"""The pass schedule of the y entropy models.

y is coded in passes. A pass codes one slice of y's channels, at every
position or at one parity of the checkerboard (anchors: (i+j) even), and its
(μ, σ) see the hyper features and what the passes before it decoded. The
hyperprior has one pass, h_s(ẑ) itself; a context module states its passes
in ``passes()``. ``walk`` runs them for the training likelihood (each pass
takes the given ỹ), the eval quantization (each pass rounds y against its
μ) and the coder (``CodecRuntime._y_passes``: each pass codes or decodes
its stream). A slice's passes are consecutive, their outputs blended by
their masks, a·m + b·(1−m).
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn


def checkerboard_mask(h: int, w: int, anchor: bool) -> np.ndarray:
    """[h, w, 1] float mask; anchor=True selects (i+j) even positions."""
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    m = ((ii + jj) % 2 == 0) if anchor else ((ii + jj) % 2 == 1)
    return m.astype(np.float32)[..., None]


class Pass(NamedTuple):
    """One pass: ``params(feats, y_prev, y_anchor)`` → (μ, σ) over
    ``channels`` on the whole grid, coded at every position (``anchors``
    None), at the anchors (True) or at the non-anchors (False).

    ``y_prev`` is the decoded ŷ of every channel before the slice (zero
    channels wide before the first slice), ``y_anchor`` the slice's decoded
    anchors, zero at the non-anchors (None in a slice's first pass).
    """
    channels: slice
    anchors: Optional[bool]
    params: Callable


def walk(passes, feats: torch.Tensor, decode, value=lambda outs: outs[0],
         stage=contextlib.nullcontext):
    """Run ``passes`` in order on the hyper features ``feats``.

    ``decode(p, mask, μ, σ)`` codes pass ``p`` and returns a tuple of
    tensors over p's channels on the whole grid; ``mask`` is the [h, w] bool
    of p's positions, None where p codes them all. Only p's positions of
    what it returns are kept. ``value`` gives the decoded ŷ from such a
    tuple, blended, where a later pass reads it. Returns the tuples blended
    over each slice's passes and concatenated over the slices. ``stage``
    opens a span a pass.
    """
    masks = {}

    def mask_of(anchors: bool, dtype=torch.bool) -> torch.Tensor:
        if not masks:
            am = torch.from_numpy(checkerboard_mask(
                *feats.shape[1:3], anchor=True)[..., 0] > 0).to(feats.device)
            masks.update({(True, torch.bool): am, (False, torch.bool): ~am})
        if (anchors, dtype) not in masks:
            masks[anchors, dtype] = masks[anchors, torch.bool][
                None, :, :, None].to(dtype)
        return masks[anchors, dtype]

    slices, done, part = [], [], None
    y_prev = feats.new_zeros(feats.shape[:-1] + (0,))
    for i, p in enumerate(passes):
        with stage("codec.y_pass"):
            mean, scale = p.params(feats, y_prev,
                                   None if part is None else value(part))
            mask = None if p.anchors is None else mask_of(p.anchors)
            got = decode(p, mask, mean, scale)
            if mask is not None:
                got = tuple(g * mask_of(p.anchors, g.dtype) for g in got)
                if part is not None:
                    got = tuple(a + g for a, g in zip(part, got))
            part = got
        if i + 1 == len(passes) or passes[i + 1].channels != p.channels:
            slices.append(part)
            part = None
            if i + 1 < len(passes):
                done.append(value(slices[-1]))
                y_prev = torch.cat(done, -1)
    if len(slices) == 1:
        return slices[0]
    return tuple(torch.cat(outs, -1) for outs in zip(*slices))


def given(y_tilde: torch.Tensor):
    """``walk``'s decode that takes ỹ as it is: yields (ỹ, μ, σ)."""
    return lambda p, mask, mean, scale: (y_tilde[..., p.channels], mean,
                                         scale)


class ContextModel(nn.Module):
    """A context entropy model; a subclass states its schedule in
    ``passes()``."""

    def forward(self, hyper_feats: torch.Tensor, y_tilde: torch.Tensor):
        """Full (μ, σ) maps; each pass's from y_tilde at the positions of
        the passes before it."""
        _, means, scales = walk(self.passes(), hyper_feats, given(y_tilde))
        return means, scales


class Schedule(NamedTuple):
    """ẑ → the features every pass reads, and the passes."""
    features: Callable
    passes: list
    stage: Callable

    def walk(self, z_hat: torch.Tensor, decode, value=lambda outs: outs[0]):
        return walk(self.passes, self.features(z_hat), decode, value,
                    self.stage)


def y_schedule(h_s, context: Optional[ContextModel],
               stage=contextlib.nullcontext) -> Schedule:
    """The schedule of h_s and the context module (None: the hyperprior).
    ``stage`` opens a span around each h_s call ("codec.hyper") and each
    pass ("codec.y_pass")."""
    def hyper(z_hat, **kwargs):
        with stage("codec.hyper"):
            return h_s(z_hat, **kwargs)
    if context is None:
        return Schedule(lambda z_hat: z_hat, [Pass(
            slice(None), None, lambda z_hat, y_prev, y_anchor: hyper(z_hat))],
            stage)
    return Schedule(lambda z_hat: hyper(z_hat, features=True),
                    context.passes(), stage)
