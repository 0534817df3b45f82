"""Samplers: DDIM (the served decode's sampler)."""

from tpucdc_torch.sampling.ddim import ddim_sample, ddim_step_tables

__all__ = ["ddim_sample", "ddim_step_tables"]
