"""Runtime: precision policy and device selection."""

from tpucdc_torch.runtime.device import resolve_device
from tpucdc_torch.runtime.precision import (BF16_POLICY, DEFAULT_POLICY,
                                            F32_POLICY, Policy, exact_f32,
                                            pin_numerics, set_policy)

__all__ = ["Policy", "BF16_POLICY", "F32_POLICY", "DEFAULT_POLICY",
           "set_policy", "pin_numerics", "exact_f32", "resolve_device"]
