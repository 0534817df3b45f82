"""Mixed-precision policy: bf16 compute / f32 params / f32 accumulation.

Mirrors tpucdc/runtime/precision.py. Parameters and normalization
statistics stay in f32; convolutions and matmuls run in the compute dtype.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Casting policy read by every model module."""
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # Reductions (norm statistics, softmax) always accumulate in f32.
    accum_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


BF16_POLICY = Policy()
F32_POLICY = Policy(compute_dtype=torch.float32)
DEFAULT_POLICY = BF16_POLICY


def set_policy(module: torch.nn.Module, policy: Policy) -> None:
    """Switch ``module`` and every submodule that carries a policy."""
    for m in module.modules():
        if hasattr(m, "policy"):
            m.policy = policy


def disable_tf32() -> None:
    """Make f32 convolutions and matmuls on the card run in full f32.

    cuDNN runs f32 convolutions in TF32 by default, which keeps only about
    three decimal digits; the F32_POLICY stages (the hyper stage's σ feeds
    the rANS row indexes) need true f32 to agree with the JAX reference.
    bf16 compute is unaffected by these flags.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
