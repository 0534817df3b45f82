"""FID: the Fréchet distance between two feature distributions, mirroring
tpucdc/eval/fid.py.

The Fréchet part (streaming mean and covariance in float64, the matrix
square root) is exact. The features are the last tap of the LPIPS stack
(eval.lpips), mean-pooled to 512: VGG-LPIPS features when real weights are
loaded, the random-conv proxy otherwise (``feature_kind`` says which), so a
number is comparable only with numbers from the same extractor.
"""

from __future__ import annotations

import numpy as np
import torch

from tpucdc_torch.eval.lpips import PerceptualMetric
from tpucdc_torch.runtime.precision import exact_f32


class _FeatureExtractor:
    def __init__(self, dim: int = 512, device="cuda"):
        self._metric = PerceptualMetric(device=device)
        self.kind = ("vgg-lpips" if self._metric.kind == "lpips"
                     else "random-conv")
        self.dim = dim

    @torch.no_grad()
    def __call__(self, imgs_u8) -> np.ndarray:
        """[B, H, W, 3] (or one HWC image) uint8 → [B, 512] float32."""
        if not isinstance(imgs_u8, torch.Tensor):
            imgs_u8 = torch.from_numpy(np.ascontiguousarray(imgs_u8))
        x = imgs_u8.to(self._metric.device, torch.float32) / 127.5 - 1.0
        if x.dim() == 3:
            x = x[None]
        with exact_f32():
            feats = self._metric._features(x)
        return torch.mean(feats[-1], dim=(2, 3)).cpu().numpy()


class FIDAccumulator:
    """Streaming mean/covariance over two image sets → FID."""

    def __init__(self, device="cuda"):
        self.extractor = _FeatureExtractor(device=device)
        self._stats = {"real": _Running(), "fake": _Running()}

    def add(self, which: str, imgs_u8) -> None:
        self._stats[which].update(self.extractor(imgs_u8))

    def compute(self) -> float:
        r, f = self._stats["real"], self._stats["fake"]
        return frechet_distance(r.mean, r.cov, f.mean, f.cov)


class _Running:
    def __init__(self):
        self.n = 0
        self.s1 = None
        self.s2 = None

    def update(self, feats: np.ndarray):
        feats = np.asarray(feats, np.float64)
        if self.s1 is None:
            d = feats.shape[-1]
            self.s1 = np.zeros(d)
            self.s2 = np.zeros((d, d))
        self.n += feats.shape[0]
        self.s1 += feats.sum(0)
        self.s2 += feats.T @ feats

    @property
    def mean(self):
        return self.s1 / max(self.n, 1)

    @property
    def cov(self):
        if self.n < 2:
            return np.zeros_like(self.s2)
        m = self.mean
        return (self.s2 - self.n * np.outer(m, m)) / (self.n - 1)


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """‖μ₁−μ₂‖² + Tr(Σ₁+Σ₂−2(Σ₁Σ₂)^{1/2}), with the usual eps jitter."""
    from scipy import linalg
    diff = mu1 - mu2
    eps = 1e-6 * np.eye(cov1.shape[0])
    covmean = linalg.sqrtm((cov1 + eps) @ (cov2 + eps))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(covmean))
