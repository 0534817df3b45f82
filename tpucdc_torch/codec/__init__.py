"""Decode-side codec: synthesis transforms and entropy-model tables."""

from tpucdc_torch.codec.entropy_models import (FactorizedPrior,
                                               GaussianConditional,
                                               default_scale_table)
from tpucdc_torch.codec.transforms import (GDN, HyperSynthesis,
                                           SynthesisTransform)

__all__ = ["FactorizedPrior", "GaussianConditional", "default_scale_table",
           "GDN", "HyperSynthesis", "SynthesisTransform"]
