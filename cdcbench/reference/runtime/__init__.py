"""The reference's precision policies and device check."""

from cdcbench.reference.runtime.device import resolve_device
from cdcbench.reference.runtime.precision import (BF16_POLICY, DEFAULT_POLICY,
                                                  F32_POLICY, Policy,
                                                  set_policy)

__all__ = ["resolve_device", "BF16_POLICY", "DEFAULT_POLICY", "F32_POLICY",
           "Policy", "set_policy"]
