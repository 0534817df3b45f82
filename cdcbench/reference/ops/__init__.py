"""The reference's ops: schedules, time embedding, NHWC layers, and the
plain GroupNorm(+SiLU) and attention that stand where the port launches its
two kernels."""

from cdcbench.reference.ops.attention import attention, attention_reference
from cdcbench.reference.ops.groupnorm import (gn_reference, group_norm,
                                              group_norm_silu)
from cdcbench.reference.ops.schedules import (DiffusionSchedule,
                                              ddim_subsequence, make_schedule)
from cdcbench.reference.ops.time_embed import sinusoidal_time_embed

__all__ = ["DiffusionSchedule", "make_schedule", "ddim_subsequence",
           "group_norm_silu", "group_norm", "gn_reference", "attention",
           "attention_reference", "sinusoidal_time_embed"]
