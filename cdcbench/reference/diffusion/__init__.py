# Frozen copy of the port's diffusion/__init__.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Diffusion decoder: UNet, its blocks, and the conditioning head."""

from cdcbench.reference.diffusion.conditioning import ConditioningHead
from cdcbench.reference.diffusion.unet import UNet

__all__ = ["ConditioningHead", "UNet"]
