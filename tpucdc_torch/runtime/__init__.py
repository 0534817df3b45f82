"""Runtime: precision policy and device selection."""

from tpucdc_torch.runtime.device import resolve_device
from tpucdc_torch.runtime.precision import (BF16_POLICY, DEFAULT_POLICY,
                                            F32_POLICY, Policy, pin_numerics,
                                            set_policy)

__all__ = ["Policy", "BF16_POLICY", "F32_POLICY", "DEFAULT_POLICY",
           "set_policy", "pin_numerics", "resolve_device"]
