"""Codec: analysis/synthesis transforms, entropy-model tables, context models."""

from tpucdc_torch.codec.channel_context import ChannelARContext
from tpucdc_torch.codec.context_model import (CheckerboardContext,
                                              checkerboard_mask)
from tpucdc_torch.codec.entropy_models import (FactorizedPrior,
                                               GaussianConditional, bits,
                                               default_scale_table)
from tpucdc_torch.codec.space_channel import SpaceChannelContext
from tpucdc_torch.codec.transforms import (GDN, AnalysisTransform,
                                           HyperAnalysis, HyperSynthesis,
                                           SynthesisTransform)

__all__ = ["FactorizedPrior", "GaussianConditional", "bits",
           "default_scale_table",
           "GDN", "AnalysisTransform", "HyperAnalysis", "HyperSynthesis",
           "SynthesisTransform", "CheckerboardContext", "checkerboard_mask",
           "ChannelARContext", "SpaceChannelContext"]
