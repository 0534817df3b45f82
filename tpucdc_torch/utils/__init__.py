"""Utilities: flax weight import, seeded weights and the native build
directory."""

from tpucdc_torch.utils.weights import (draw_weights, load_params_npz,
                                        params_from_jax)

__all__ = ["draw_weights", "load_params_npz", "params_from_jax"]
