"""Eval: distortion and perceptual metrics, FID, and the eval harness."""

from tpucdc_torch.eval.fid import FIDAccumulator, frechet_distance
from tpucdc_torch.eval.lpips import PerceptualMetric
from tpucdc_torch.eval.metrics import gmsd, ms_ssim, mse, psnr

__all__ = ["psnr", "ms_ssim", "mse", "gmsd", "PerceptualMetric",
           "FIDAccumulator", "frechet_distance"]
