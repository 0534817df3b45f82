# Frozen copy of the port's codec/__init__.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Codec: analysis/synthesis transforms, entropy-model tables, context models."""

from cdcbench.reference.codec.channel_context import ChannelARContext
from cdcbench.reference.codec.context_model import (CheckerboardContext,
                                              checkerboard_mask)
from cdcbench.reference.codec.entropy_models import (FactorizedPrior,
                                               GaussianConditional, bits,
                                               default_scale_table)
from cdcbench.reference.codec.space_channel import SpaceChannelContext
from cdcbench.reference.codec.transforms import (GDN, AnalysisTransform,
                                           HyperAnalysis, HyperSynthesis,
                                           SynthesisTransform)

__all__ = ["FactorizedPrior", "GaussianConditional", "bits",
           "default_scale_table",
           "GDN", "AnalysisTransform", "HyperAnalysis", "HyperSynthesis",
           "SynthesisTransform", "CheckerboardContext", "checkerboard_mask",
           "ChannelARContext", "SpaceChannelContext"]
