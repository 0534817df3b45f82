"""Samplers: DDIM (plain and block-cached), DDPM, classifier-free guidance."""

from tpucdc_torch.sampling.ddim import (ddim_sample, ddim_sample_blockcached,
                                        ddim_step_tables)
from tpucdc_torch.sampling.ddpm import ddpm_sample
from tpucdc_torch.sampling.guidance import (make_batched_cfg_eps_fn,
                                            make_cfg_eps_fn)

__all__ = ["ddim_sample", "ddim_sample_blockcached", "ddim_step_tables",
           "ddpm_sample", "make_cfg_eps_fn", "make_batched_cfg_eps_fn"]
