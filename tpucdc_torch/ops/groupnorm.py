"""GroupNorm and fused GroupNorm+SiLU over NHWC input.

``group_norm_silu`` is the inner-loop normalization of every UNet ResBlock
and of the conditioning head. On a CUDA tensor it launches the hand-written
kernel of ``csrc/gn_silu.cu`` (which replaces the JAX package's Pallas
kernel); on a CPU tensor it runs the plain version beside it. There is no
fallback: a CUDA tensor the kernel does not take raises.

``group_norm`` (ResBlock norm2, the attention pre-norm) is plain PyTorch, as
it is plain XLA in the JAX package.
"""

from __future__ import annotations

import torch

from tpucdc_torch.ops import _kernels

_MAX_CHANNELS = 3072   # the apply kernel keeps 3·C floats in shared memory
# tpucdc_gn_silu launches two kernels per call: statistics, then apply.
KERNELS_PER_CALL = 2


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain GroupNorm over NHWC input; f32 statistics, input dtype out."""
    return gn_reference(x, gamma, beta, num_groups, eps, fuse_silu=False)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Fused GroupNorm + SiLU. x: [B, ..., C] NHWC; gamma/beta: [C]."""
    if x.is_cuda:
        return gn_silu_cuda(x, gamma, beta, num_groups, eps)
    return gn_reference(x, gamma, beta, num_groups, eps, fuse_silu=True)


def gn_reference(x, gamma, beta, num_groups: int, eps: float,
                 fuse_silu: bool) -> torch.Tensor:
    """Plain version: mirrors tpucdc/ops/groupnorm.py::_gn_reference."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"C={c} not divisible by groups={num_groups}")
    xf = x.to(torch.float32).reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * gamma.to(torch.float32) + beta.to(torch.float32)
    if fuse_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def gn_silu_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Launch the GN+SiLU kernel on a contiguous NHWC CUDA tensor."""
    c = x.shape[-1]
    if not x.is_cuda:
        raise ValueError("gn_silu_cuda takes a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("gn_silu_cuda takes a contiguous NHWC tensor")
    if x.dim() < 2 or c % num_groups or c > _MAX_CHANNELS:
        raise ValueError(f"bad GN shape {tuple(x.shape)} / {num_groups} groups")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError("gamma/beta must be [C]")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("gamma/beta must be on the input's device")
    dtype = _kernels.dtype_code(x.dtype)
    b = x.shape[0]
    n = x.numel() // (b * c)
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # Enough (image, group, segment) blocks for two per SM.
    segments = max(1, min(n, -(-2 * sms // (b * num_groups))))
    partials = torch.empty((b, num_groups, segments, 3), dtype=torch.float32,
                           device=x.device)
    out = torch.empty_like(x)
    lib = _kernels.library()
    rc = lib.tpucdc_gn_silu(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        partials.data_ptr(), b, n, c, num_groups, segments, float(eps), dtype,
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(rc, "gn_silu")
    _kernels.LAUNCHES["gn_silu"] += KERNELS_PER_CALL
    return out
