"""Distortion metrics: MSE, PSNR, MS-SSIM and GMSD, mirroring
tpucdc/eval/metrics.py.

Every function takes two uint8 (or 0..255 float) images, HWC or BHWC, as
numpy arrays or tensors, and computes in f32: on a tensor's own device, or
for a numpy pair on ``device``, the card unless the caller passes
``device="cpu"``. The filters are depthwise "valid" convolutions run with
TF32 off (``runtime.exact_f32``), whatever the process flags are: the
windowed E[x²]−μ² moments cancel, and a TF32 product breaks them (an
MS-SSIM above 1 is the symptom).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpucdc_torch.runtime.device import resolve_device
from tpucdc_torch.runtime.precision import exact_f32

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _both_f32(a, b, device):
    """Both images as f32 tensors on one device: the first tensor's own,
    else ``device``."""
    dev = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)),
               None) or resolve_device(device)

    def f32(img):
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(dev, torch.float32)

    return f32(a), f32(b)


def _pair_nchw(a, b, device):
    """Both images as f32 [B, C, H, W] on one device."""
    a, b = _both_f32(a, b, device)
    if a.dim() == 3:
        a, b = a[None], b[None]
    return a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)


def mse(a, b, device="cuda") -> float:
    a, b = _both_f32(a, b, device)
    return float(torch.mean(torch.square(a - b)))


def psnr(a, b, peak: float = 255.0, device="cuda") -> float:
    """PSNR in dB between two uint8 (or 0..255 float) images."""
    m = mse(a, b, device)
    return float(10.0 * np.log10(peak * peak / max(m, 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-0.5 * ((np.arange(size) - size // 2) / sigma) ** 2)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise "valid" 2-D filter over [B, C, H, W]."""
    c = img.shape[1]
    k = kernel.to(img.device)[None, None].expand(c, 1, *kernel.shape)
    return F.conv2d(img, k, groups=c)


def _ssim_pair(a, b, peak):
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    kern = torch.from_numpy(_gaussian_kernel())
    # Centred on the global means (one mean over the whole batch) before the
    # E[x²]−μ² moments form: at 255-scale the uncentred form cancels in f32.
    # Covariances are shift-invariant; the luminance term adds the means back.
    ga = torch.mean(a)
    gb = torch.mean(b)
    a0, b0 = a - ga, b - gb
    mu_a0, mu_b0 = _filter2(a0, kern), _filter2(b0, kern)
    mu_a, mu_b = mu_a0 + ga, mu_b0 + gb
    saa = _filter2(a0 * a0, kern) - mu_a0 * mu_a0
    sbb = _filter2(b0 * b0, kern) - mu_b0 * mu_b0
    sab = _filter2(a0 * b0, kern) - mu_a0 * mu_b0
    lum = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    cs = (2 * sab + c2) / (saa + sbb + c2)
    return torch.mean(lum * cs), torch.mean(cs)


def _ms_ssim(a, b, levels: int, peak: float) -> torch.Tensor:
    weights = torch.tensor(_MSSSIM_WEIGHTS[:levels], dtype=torch.float32,
                           device=a.device)
    weights = weights / torch.sum(weights)
    vals = []
    for lvl in range(levels):
        ssim_full, cs = _ssim_pair(a, b, peak)
        vals.append(ssim_full if lvl == levels - 1 else cs)
        if lvl != levels - 1:
            a = F.avg_pool2d(a, 2)
            b = F.avg_pool2d(b, 2)
    vals = torch.stack(vals)
    return torch.prod(torch.clamp(vals, min=1e-6) ** weights)


def ms_ssim(a, b, peak: float = 255.0, device="cuda") -> float:
    """Multi-scale SSIM (Wang et al.); the level count adapts to the image
    size (each level needs at least 11 px after the halvings) and the
    weights are renormalised over the levels used."""
    a, b = _pair_nchw(a, b, device)
    min_side = min(a.shape[2], a.shape[3])
    levels = 1
    while levels < 5 and min_side // (2 ** levels) >= 11:
        levels += 1
    with exact_f32():
        return float(_ms_ssim(a, b, levels, peak))


def _gmsd(a, b, peak: float) -> torch.Tensor:
    # Rec.601 luminance, then a 2×2 average-downsample.
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                     device=a.device)
    la = torch.tensordot(a.permute(0, 2, 3, 1), w, dims=([-1], [0]))[:, None]
    lb = torch.tensordot(b.permute(0, 2, 3, 1), w, dims=([-1], [0]))[:, None]
    la = F.avg_pool2d(la, 2)
    lb = F.avg_pool2d(lb, 2)
    # Prewitt gradient magnitudes.
    hx = torch.tensor([[1, 0, -1], [1, 0, -1], [1, 0, -1]],
                      dtype=torch.float32) / 3.0

    def grad_mag(x):
        gx = _filter2(x, hx)
        gy = _filter2(x, hx.T.contiguous())
        return torch.sqrt(gx * gx + gy * gy + 1e-12)

    ga, gb = grad_mag(la), grad_mag(lb)
    c = 170.0 * (peak / 255.0) ** 2   # the paper's c for the 8-bit range
    gms = (2.0 * ga * gb + c) / (ga * ga + gb * gb + c)
    return torch.sqrt(torch.mean(torch.square(gms - torch.mean(gms))))


def gmsd(a, b, peak: float = 255.0, device="cuda") -> float:
    """Gradient Magnitude Similarity Deviation (Xue, Zhang, Mou, Bovik
    2013): a weight-free full-reference perceptual metric, lower is better,
    0 for identical images."""
    a, b = _pair_nchw(a, b, device)
    with exact_f32():
        return float(_gmsd(a, b, peak))
