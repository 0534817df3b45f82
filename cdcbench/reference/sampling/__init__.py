"""The reference's DDIM sampler."""

from cdcbench.reference.sampling.ddim import ddim_sample, ddim_step_tables

__all__ = ["ddim_sample", "ddim_step_tables"]
