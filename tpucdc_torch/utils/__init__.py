"""Utilities: flax weight import and export, the training initialisation,
seeded weights, checkpoints, the native build directory, metric logging and
profiling."""

from tpucdc_torch.utils.logging import MetricLogger, code_sha
from tpucdc_torch.utils.profiling import profile_trace, span
from tpucdc_torch.utils.weights import (draw_weights, init_weights,
                                        load_params_npz, params_from_jax,
                                        params_to_jax, save_params_npz)

__all__ = ["draw_weights", "init_weights", "load_params_npz",
           "save_params_npz", "params_from_jax", "params_to_jax",
           "MetricLogger", "code_sha", "profile_trace", "span"]
