"""Diffusion decoder: UNet, its blocks, and the conditioning head."""

from tpucdc_torch.diffusion.conditioning import ConditioningHead
from tpucdc_torch.diffusion.unet import UNet

__all__ = ["ConditioningHead", "UNet"]
