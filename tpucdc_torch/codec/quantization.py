"""Quantization proxies, mirroring tpucdc/codec/quantization.py.

Training uses the additive-uniform-noise relaxation; evaluation and coding
use hard rounding, with a straight-through gradient where one is needed.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Optional

import torch


def additive_noise(x: torch.Tensor, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Train-time proxy: x + U(-0.5, 0.5)."""
    u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                   device=x.device)
    return x + (u - 0.5)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) forward, identity gradient backward."""
    return x + (torch.round(x) - x).detach()


def quantize_dequantize(y: torch.Tensor, means: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Eval-time quantization: round the mean-removed latent, add the mean back.

    Matches what the range coder transmits (symbols = round(y - μ)), so the
    reconstruction path sees exactly the decodable ŷ.
    """
    if means is None:
        return ste_round(y)
    return ste_round(y - means) + means
