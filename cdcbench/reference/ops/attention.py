# Frozen copy of the port's ops/attention.py, plain path only: the
# benchmark's reference for the attention kernel.
"""Scaled dot-product attention in plain PyTorch: [B, H, N, d] in, softmax
in f32, the [B, H, N, d] view of a [B, N, H, d] result out."""

from __future__ import annotations

import torch

from cdcbench.reference.ops.layers import fp8_round, fp8_on


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float | None = None) -> torch.Tensor:
    if fp8_on() and q.dtype == torch.bfloat16:
        q, k, v = fp8_round(q), fp8_round(k), fp8_round(v)
    return attention_reference(q, k, v, scale)


def _head_major(out_bhnd: torch.Tensor, dtype) -> torch.Tensor:
    b, h, n, d = out_bhnd.shape
    stored = torch.empty((b, n, h, d), dtype=dtype, device=out_bhnd.device)
    stored.copy_(out_bhnd.transpose(1, 2))
    return stored.transpose(1, 2)


def attention_reference(q, k, v, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(q.dtype).to(torch.float32),
                       v.to(torch.float32))
    return _head_major(out, q.dtype)
