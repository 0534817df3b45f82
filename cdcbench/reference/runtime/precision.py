# Frozen copy of the port's runtime/precision.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Mixed-precision policy: bf16 compute / f32 params / f32 accumulation.

Mirrors tpucdc/runtime/precision.py. Parameters and normalization
statistics stay in f32; convolutions and matmuls run in the compute dtype.
"""

from __future__ import annotations

import contextlib
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


def pin_numerics() -> None:
    """Pin what the coder's row indexes rely on; process-wide PyTorch flags.

    The encoder and the decoder each compute h_s and every context pass,
    and both must land every σ in the same scale-table row, or rANS
    desyncs. They call the same functions on tensors of the same shape;
    what remains is the library's choice of algorithm, pinned here, in the
    one place the runtime calls before it touches the card:

      * TF32 off for convolutions and matmuls: cuDNN and cuBLAS otherwise
        run f32 in TF32, which keeps about three decimal digits; the
        F32_POLICY stages need true f32 to agree with the JAX reference
        and with the CPU.
      * ``cudnn.benchmark`` off: with it on, cuDNN times candidate
        algorithms at the first call of each shape and keeps the winner,
        so two processes (or an encoder and a later decoder) can sum in
        different orders for the same shape. Off, the choice is a
        heuristic of the shape alone.
      * ``cudnn.deterministic`` on: a transposed convolution (h_s) is a
        backward-data pass, for which cuDNN has algorithms that accumulate
        with atomics and give run-to-run different last bits.

    bf16 compute is unaffected by the TF32 flags. One GPU model and one
    library version are assumed on both sides, as for any float-derived
    entropy parameters.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


@contextlib.contextmanager
def exact_f32():
    """TF32 off for convolutions and matmuls inside the block, whatever the
    process flags are, and the flags as they were after it.

    PyTorch lets cuDNN run f32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``); ``pin_numerics`` turns that off
    only once a runtime is built on the card. The eval metrics use this
    instead, so that a metric computed before any runtime exists is as exact
    as one computed after: their E[x²]−μ² moments cancel, which TF32's ten
    mantissa bits do not survive.
    """
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul
