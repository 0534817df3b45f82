"""Utilities: flax weight import, seeded weights, the native build
directory, metric logging and profiling."""

from tpucdc_torch.utils.logging import MetricLogger, code_sha
from tpucdc_torch.utils.profiling import profile_trace, timed_block
from tpucdc_torch.utils.weights import (draw_weights, load_params_npz,
                                        params_from_jax)

__all__ = ["draw_weights", "load_params_npz", "params_from_jax",
           "MetricLogger", "code_sha", "profile_trace", "timed_block"]
