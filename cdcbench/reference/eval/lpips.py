# Frozen copy of the port's eval/lpips.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""LPIPS-style perceptual distance, mirroring tpucdc/eval/lpips.py.

Canonical LPIPS needs pretrained VGG/AlexNet features, which the repository
does not carry. The extractor loads real weights from an .npz when one is
given and otherwise builds a deterministic random-conv feature stack, drawn
with numpy exactly as the JAX package draws it, so both packages compute the
same proxy. ``PerceptualMetric.kind`` says which path is active.

Weights .npz layout (TPUCDC_LPIPS_WEIGHTS=/path/to/file.npz), as the JAX
package reads it:
  convN_kernel [kh, kw, cin, cout] (HWIO), convN_bias [cout] for N = 0..4
  (the VGG16 conv1_2/conv2_2/conv3_3/conv4_3/conv5_3 taps),
  linN [c], the per-layer channel weights.

The convolutions run in f32 with TF32 off (``runtime.exact_f32``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from cdcbench.reference.runtime import resolve_device
from cdcbench.reference.runtime.precision import exact_f32

_LAYER_CHANNELS = (64, 128, 256, 512, 512)


def _random_params(seed: int = 0):
    """Deterministic He-init conv stack standing in for VGG features: per
    layer a HWIO kernel, a zero bias and channel weights ``w``, drawn in
    that order from one numpy generator (f32 [kh, kw, cin, cout], [cout],
    [cout])."""
    rng = np.random.default_rng(seed)
    params = []
    cin = 3
    for cout in _LAYER_CHANNELS:
        k = rng.normal(size=(3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin))
        b = np.zeros(cout)
        w = np.abs(rng.normal(size=cout)) / cout
        params.append((k.astype(np.float32), b.astype(np.float32),
                       w.astype(np.float32)))
        cin = cout
    return params


def _load_npz(path: str):
    with np.load(path) as data:
        return [(np.asarray(data[f"conv{i}_kernel"], np.float32),
                 np.asarray(data[f"conv{i}_bias"], np.float32),
                 np.asarray(data[f"lin{i}"], np.float32)) for i in range(5)]


class PerceptualMetric:
    """Callable LPIPS(-proxy): (img_a, img_b uint8 HWC) -> float distance,
    on ``device`` (the card unless the caller passes "cpu")."""

    def __init__(self, weights_path: str | None = None, seed: int = 0,
                 device="cuda"):
        weights_path = weights_path or os.environ.get("TPUCDC_LPIPS_WEIGHTS")
        if weights_path and os.path.exists(weights_path):
            params = _load_npz(weights_path)
            self.kind = "lpips"
        else:
            params = _random_params(seed)
            self.kind = "lpips-random-proxy"
        self.device = resolve_device(device)
        # HWIO kernels become OIHW.
        self.params = [
            (torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))
                              ).to(self.device),
             torch.from_numpy(b).to(self.device),
             torch.from_numpy(w).to(self.device)) for k, b, w in params]

    def _features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: [B, H, W, 3] in [-1, 1] → the unit-normalized feature maps of
        the five taps, each [B, C, H', W'] (channels first)."""
        feats = []
        h = x.permute(0, 3, 1, 2)
        for i, (k, b, _) in enumerate(self.params):
            h = F.relu(F.conv2d(h, k, b, padding=1))
            norm = torch.sqrt(torch.sum(h * h, dim=1, keepdim=True) + 1e-10)
            feats.append(h / norm)
            if i + 1 < len(self.params):
                # A stride-2 pool between taps (a VGG-style pyramid).
                h = F.max_pool2d(h, 2)
        return feats

    def distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Differentiable batch distance between [-1, 1] NHWC tensors (a
        scalar tensor), usable as a loss term."""
        with exact_f32():
            fa = self._features(a)
            fb = self._features(b)
            total = 0.0
            for (_, _, w), xa, xb in zip(self.params, fa, fb):
                d = torch.square(xa - xb) * w[:, None, None]
                total = total + torch.mean(torch.sum(d, dim=1))
        return total

    def _to_input(self, img) -> torch.Tensor:
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(self.device, torch.float32)[None] / 127.5 - 1.0

    @torch.no_grad()
    def __call__(self, img_a, img_b) -> float:
        return float(self.distance(self._to_input(img_a),
                                   self._to_input(img_b)))
