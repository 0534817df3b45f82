"""Runtime: precision policy and device selection."""

from tpucdc_torch.runtime.device import resolve_device
from tpucdc_torch.runtime.precision import (BF16_POLICY, DEFAULT_POLICY,
                                            F32_POLICY, Policy, disable_tf32,
                                            set_policy)

__all__ = ["Policy", "BF16_POLICY", "F32_POLICY", "DEFAULT_POLICY",
           "set_policy", "disable_tf32", "resolve_device"]
