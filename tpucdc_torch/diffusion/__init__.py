"""Diffusion decoder: the refiners (UNet, DiT), their blocks, and the
conditioning head."""

from tpucdc_torch.diffusion.conditioning import ConditioningHead
from tpucdc_torch.diffusion.dit import DiT
from tpucdc_torch.diffusion.unet import UNet

__all__ = ["ConditioningHead", "DiT", "UNet"]
