"""Runtime: the mesh, precision policy, device selection, named random
streams and debug toggles, exporting what tpucdc/runtime/__init__.py
exports (the JAX-only ``data_sharding`` and ``replicated_sharding`` have no
counterpart; see ``runtime.mesh``)."""

from tpucdc_torch.runtime.device import resolve_device
from tpucdc_torch.runtime.debug import (disable_debug_checks,
                                        enable_debug_checks,
                                        maybe_init_distributed)
from tpucdc_torch.runtime.mesh import (DATA_AXIS, MODEL_AXIS,
                                       local_device_count, make_mesh,
                                       replicate, shard_batch)
from tpucdc_torch.runtime.precision import (BF16_POLICY, DEFAULT_POLICY,
                                            F32_POLICY, Policy, exact_f32,
                                            pin_numerics, set_policy)
from tpucdc_torch.runtime.prng import KeyChain

__all__ = ["make_mesh", "shard_batch", "replicate", "local_device_count",
           "DATA_AXIS", "MODEL_AXIS", "Policy", "BF16_POLICY", "F32_POLICY",
           "DEFAULT_POLICY", "set_policy", "pin_numerics", "exact_f32",
           "resolve_device", "KeyChain", "enable_debug_checks",
           "disable_debug_checks", "maybe_init_distributed"]
