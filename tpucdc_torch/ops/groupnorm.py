"""GroupNorm and fused GroupNorm+SiLU over NHWC input.

``group_norm_silu`` is the inner-loop normalization of every UNet ResBlock
and of the conditioning head. On a CUDA tensor it launches the hand-written
kernel of ``csrc/gn_silu.cu`` (which replaces the JAX package's Pallas
kernel); on a CPU tensor it runs the plain version beside it. There is no
fallback: a CUDA tensor the kernel does not take raises.

Where autograd records (grad enabled and an input that requires grad), the
kernel is the forward of ``_GNSiLU``, an autograd.Function whose backward
recomputes the f32 group statistics from the saved input in PyTorch
operations; otherwise (a decode) the wrapper launches the kernel directly.
The JAX package has no backward kernel (it differentiates its XLA
reference), so there is none to port; on a CPU tensor autograd runs through
the plain version.

``group_norm`` (ResBlock norm2, the attention pre-norm) is plain PyTorch, as
it is plain XLA in the JAX package.
"""

from __future__ import annotations

import torch

from tpucdc_torch.ops import _kernels

# The kernel keeps its per-thread statistics in two shared arrays of 3072
# floats, indexed (row lane, channel): one row lane is left at C = 3072.
_MAX_CHANNELS = 3072
# tpucdc_gn_silu is one cooperative launch per call.
KERNELS_PER_CALL = 1
# An image's rows are split over blocks of about this many elements, and the
# whole batch over no more than one block per SM (both measured best).
_ELEMENTS_PER_BLOCK = 4096

_sm_counts: dict[int, int] = {}
_scratch: dict[tuple[int, int], torch.Tensor] = {}


def _sm_count(device: torch.device) -> int:
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device.index]


def _partials(device: torch.device, stream: int, floats: int) -> torch.Tensor:
    """Scratch for the blocks' partial statistics, kept per device and stream
    (launches on one stream run in order, so they can share it)."""
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < floats:
        buf = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                          device=device)
        _scratch[key] = buf
    return buf


def scratch(device: torch.device, stream: int):
    """The scratch that launches on ``stream`` use now; None before the
    first. A CUDA graph holds the one it captured, as a larger call on the
    stream replaces it."""
    return _scratch.get((device.index, stream))


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain GroupNorm over NHWC input; f32 statistics, input dtype out."""
    return gn_reference(x, gamma, beta, num_groups, eps, fuse_silu=False)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Fused GroupNorm + SiLU. x: [B, ..., C] NHWC; gamma/beta: [C]."""
    if not x.is_cuda:
        return gn_reference(x, gamma, beta, num_groups, eps, fuse_silu=True)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _GNSiLU.apply(x, gamma, beta, num_groups, eps)
    return gn_silu_cuda(x, gamma, beta, num_groups, eps)


class _GNSiLU(torch.autograd.Function):
    """The kernel forward; a backward in PyTorch operations from the saved
    input, parameters and the recomputed f32 statistics."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups: int, eps: float):
        ctx.save_for_backward(x, gamma, beta)
        ctx.num_groups, ctx.eps = num_groups, eps
        return gn_silu_cuda(x, gamma, beta, num_groups, eps)

    @staticmethod
    def backward(ctx, dout):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = gn_silu_backward(dout, x, gamma, beta,
                                             ctx.num_groups, ctx.eps)
        return dx, dgamma, dbeta, None, None


def gn_silu_backward(dout, x, gamma, beta, num_groups: int, eps: float):
    """(dx, dγ, dβ) of GroupNorm+SiLU, in f32 and cast back: dx to x's
    dtype, dγ and dβ to the parameters' dtypes."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.to(torch.float32).reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean) * rstd).reshape(b, -1, c)
    y = xhat * gamma.to(torch.float32) + beta.to(torch.float32)
    sig = torch.sigmoid(y)
    g = dout.to(torch.float32).reshape(b, -1, c) * (sig * (1 + y * (1 - sig)))
    dgamma = (g * xhat).sum(dim=(0, 1))
    dbeta = g.sum(dim=(0, 1))
    dxhat = (g * gamma.to(torch.float32)).reshape(xf.shape)
    xhat = xhat.reshape(xf.shape)
    dx = rstd * (dxhat - dxhat.mean(dim=(1, 3), keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=(1, 3), keepdim=True))
    return (dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype))


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


def gn_chunked_reference(x, gamma, beta, num_groups: int, eps: float = 1e-5,
                         chunks: int = 4) -> torch.Tensor:
    """Plain mirror of the kernel's statistics, for the tests.

    The rows of each image are cut into ``chunks`` ranges, as the kernel cuts
    them over blocks. Each range gives per-channel (count, mean, M2); these
    fold into per-group partials, and the partials of an image merge, both
    by the kernel's rule: a weighted mean taken about a reference value, then
    M2 = Σ (M2_i + n_i (mean_i − mean)²), whose terms are all non-negative.
    Then y = (x − mean)·rstd·γ + β and SiLU, in f32, cast to the input dtype.
    """
    b, c = x.shape[0], x.shape[-1]
    cpg = c // num_groups
    xf = x.to(torch.float32).reshape(b, -1, c)
    n = xf.shape[1]
    rows_per = -(-n // chunks)

    def merge(count, mean, m2, dim):
        """Merge (count, mean, M2) triples along ``dim``."""
        ref = mean.narrow(dim, 0, 1)
        total = count.sum(dim, keepdim=True)
        mu = ref + (count * (mean - ref)).sum(dim, keepdim=True) / total
        q = (m2 + count * (mean - mu).square()).sum(dim, keepdim=True)
        return total, mu, q

    parts = []
    for r0 in range(0, n, rows_per):
        rows = xf[:, r0:r0 + rows_per]                       # [B, r, C]
        mean_c = rows.mean(dim=1)                            # [B, C]
        m2_c = (rows - mean_c[:, None]).square().sum(dim=1)
        count_c = torch.full_like(mean_c, rows.shape[1])
        parts.append(merge(*(t.reshape(b, num_groups, cpg)
                             for t in (count_c, mean_c, m2_c)), dim=2))
    count, mean, m2 = (torch.cat(t, dim=2) for t in zip(*parts))   # [B, G, S]
    total, mu, q = merge(count, mean, m2, dim=2)
    rstd = 1.0 / torch.sqrt(q / total + eps)                 # [B, G, 1]
    mu_c = mu.expand(b, num_groups, cpg).reshape(b, 1, c)
    scale_c = rstd.expand(b, num_groups, cpg).reshape(b, 1, c) \
        * gamma.to(torch.float32)
    y = (xf - mu_c) * scale_c + beta.to(torch.float32)
    y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def gn_silu_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Launch the GN+SiLU kernel on a contiguous NHWC CUDA tensor."""
    c = x.shape[-1]
    if not x.is_cuda:
        raise ValueError("gn_silu_cuda takes a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("gn_silu_cuda takes a contiguous NHWC tensor")
    if x.dim() < 2 or c % num_groups or c > _MAX_CHANNELS or x.numel() == 0:
        raise ValueError(f"bad GN shape {tuple(x.shape)} / {num_groups} groups")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError("gamma/beta must be [C]")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("gamma/beta must be on the input's device")
    dtype = _kernels.dtype_code(x.dtype)
    b = x.shape[0]
    n = x.numel() // (b * c)
    if gamma.dtype != torch.float32 or not gamma.is_contiguous():
        gamma = gamma.to(torch.float32).contiguous()
    if beta.dtype != torch.float32 or not beta.is_contiguous():
        beta = beta.to(torch.float32).contiguous()
    # Row ranges (blocks) per image.
    segments = max(1, min(n, -(-n * c // _ELEMENTS_PER_BLOCK),
                          _sm_count(x.device) // b))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    partials = _partials(x.device, stream, b * num_groups * segments * 4)
    out = torch.empty_like(x)
    lib = _kernels.library()
    rc = lib.tpucdc_gn_silu(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        partials.data_ptr(), b, n, c, num_groups, segments, float(eps), dtype,
        stream)
    _kernels.check(rc, "gn_silu")
    _kernels.LAUNCHES["gn_silu"] += KERNELS_PER_CALL
    return out
