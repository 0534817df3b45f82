"""Ops: noise schedules, time embedding, NHWC layers, and the three kernels
(GN+SiLU, attention, the DiT's adaLN chain), each with its plain PyTorch
version."""

from tpucdc_torch.ops.adaln import adaln, adaln_reference
from tpucdc_torch.ops.attention import attention, attention_reference
from tpucdc_torch.ops.groupnorm import (gn_reference, group_norm,
                                        group_norm_silu)
from tpucdc_torch.ops.schedules import (DiffusionSchedule, ddim_subsequence,
                                        make_schedule)
from tpucdc_torch.ops.time_embed import sinusoidal_time_embed

__all__ = [
    "DiffusionSchedule",
    "make_schedule",
    "ddim_subsequence",
    "group_norm_silu",
    "group_norm",
    "gn_reference",
    "attention",
    "attention_reference",
    "adaln",
    "adaln_reference",
    "sinusoidal_time_embed",
]
