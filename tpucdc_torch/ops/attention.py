"""Multi-head attention for the UNet's low-resolution feature maps.

On a CUDA tensor ``attention`` launches the hand-written kernel of
``csrc/attention.cu`` (which replaces the JAX package's Pallas kernel) for
every shape: there is no size gate and no fallback. On a CPU tensor it runs
the plain version beside it.
"""

from __future__ import annotations

import torch

from tpucdc_torch.ops import _kernels

_MAX_HEAD_DIM = 128
_MAX_BATCH_HEADS = 65535   # grid.y of the launch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float | None = None) -> torch.Tensor:
    """Scaled dot-product attention.

    q: [B, H, Nq, d], k/v: [B, H, Nk, d]. Softmax in f32, output q.dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return attention_cuda(q, k, v, scale)
    return attention_reference(q, k, v, scale)


def attention_reference(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Plain version: mirrors tpucdc/ops/attention.py::attention_reference."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(q.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Launch the attention kernel on contiguous [B,H,N,d] CUDA tensors."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention_cuda takes CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B,H,Nq,d] and k, v the same [B,H,Nk,d]")
    b, h, nq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if not 1 <= d <= _MAX_HEAD_DIM or b * h > _MAX_BATCH_HEADS:
        raise ValueError(f"attention kernel takes d <= {_MAX_HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention_cuda takes contiguous tensors")
    dtype = _kernels.dtype_code(q.dtype)
    out = torch.empty_like(q)
    lib = _kernels.library()
    rc = lib.tpucdc_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, nq,
        k.shape[2], d, float(scale), dtype,
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(rc, "attention")
    _kernels.LAUNCHES["attention"] += 1
    return out
