"""Runtime: precision policy, device selection, named random streams and
debug toggles."""

from tpucdc_torch.runtime.device import resolve_device
from tpucdc_torch.runtime.debug import (disable_debug_checks,
                                        enable_debug_checks)
from tpucdc_torch.runtime.precision import (BF16_POLICY, DEFAULT_POLICY,
                                            F32_POLICY, Policy, exact_f32,
                                            pin_numerics, set_policy)
from tpucdc_torch.runtime.prng import KeyChain

__all__ = ["Policy", "BF16_POLICY", "F32_POLICY", "DEFAULT_POLICY",
           "set_policy", "pin_numerics", "exact_f32", "resolve_device",
           "KeyChain", "enable_debug_checks", "disable_debug_checks"]
