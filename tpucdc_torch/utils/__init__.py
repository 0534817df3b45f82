"""Utilities: flax weight import and the native build directory."""

from tpucdc_torch.utils.weights import load_params_npz, params_from_jax

__all__ = ["load_params_npz", "params_from_jax"]
