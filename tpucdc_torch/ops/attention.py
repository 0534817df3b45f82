"""Multi-head attention for the UNet's low-resolution feature maps and the
DiT refiner's blocks.

On a CUDA tensor ``attention`` launches the hand-written kernel of
``csrc/attention.cu`` (which replaces the JAX package's Pallas kernel) for
every shape: there is no size gate and no fallback. That entry point takes
bf16 at d > 64 on aligned views to its Hopper design,
``csrc/attention_sm90.cu``, still one launch a call. On a CPU tensor it runs
the plain version beside it.

The public layout is the JAX package's ``[B, H, N, d]``, but q, k and v may
be any views with a contiguous last dimension: the head view of a
``[B, N, H*d]`` projection is read in place. The result is allocated as
``[B, N, H, d]`` and returned as its ``[B, H, N, d]`` view, so that
``out.transpose(1, 2).reshape(B, N, H*d)`` copies nothing.

Where autograd records (grad enabled and an input that requires grad), the
kernel is the forward of ``_Attention``, an autograd.Function whose backward
recomputes softmax(q·kᵀ·scale) in f32 from the saved q, k and v in PyTorch
operations; otherwise (a decode) the wrapper launches the kernel directly.
The JAX package has no backward kernel (it differentiates its XLA
reference), so there is none to port; on a CPU tensor autograd runs through
the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from tpucdc_torch.ops import _kernels

_MAX_HEAD_DIM = 128
_MAX_BLOCKS = 2 ** 31 - 1   # grid.x of the launch: row tiles × B·H


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float | None = None) -> torch.Tensor:
    """Scaled dot-product attention.

    q: [B, H, Nq, d], k/v: [B, H, Nk, d]. Softmax in f32, output q.dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return attention_reference(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, scale)
    return attention_cuda(q, k, v, scale)


class _Attention(torch.autograd.Function):
    """The kernel forward; a backward in PyTorch operations that recomputes
    the f32 softmax from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return attention_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(dout, q, k, v, ctx.scale), None)


def attention_backward(dout, q, k, v, scale: float):
    """(dq, dk, dv) of softmax(q·kᵀ·scale)·v, in f32 and cast back to the
    dtypes of q, k and v; the shapes are theirs ([B, H, N, d])."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    do = dout.to(torch.float32)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _head_major(out_bhnd: torch.Tensor, dtype) -> torch.Tensor:
    """[B,H,N,d] values stored as [B,N,H,d], returned as the [B,H,N,d] view."""
    b, h, n, d = out_bhnd.shape
    stored = torch.empty((b, n, h, d), dtype=dtype, device=out_bhnd.device)
    stored.copy_(out_bhnd.transpose(1, 2))
    return stored.transpose(1, 2)


def attention_reference(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Plain version: mirrors tpucdc/ops/attention.py::attention_reference."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(q.dtype).to(torch.float32),
                       v.to(torch.float32))
    return _head_major(out, q.dtype)


def attention_tiled_reference(q, k, v, scale: float | None = None,
                              tile: int = 64, splits: int = 4) -> torch.Tensor:
    """Plain mirror of the kernel's arithmetic, for the tests.

    Keys are taken in tiles of ``tile``; tile i goes to split ``i % splits``.
    Each split keeps a running max m, a running sum l and an accumulator:
    per tile the f32 scores raise m, l and the accumulator are rescaled by
    exp(m_old − m_new), P = exp(s − m_new) is rounded to the V dtype (against
    the running max, not the final one) before P·V, and l sums the unrounded
    P. The last tile may be ragged. The splits are merged by their maxima at
    the end, and the result is divided by the merged l.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.to(torch.float32)
    nk = k.shape[2]
    lead = q.shape[:3]
    state = [(qf.new_full((*lead, 1), float("-inf")), qf.new_zeros((*lead, 1)),
              torch.zeros_like(qf)) for _ in range(splits)]
    for i, j0 in enumerate(range(0, nk, tile)):
        m, l, acc = state[i % splits]
        kt = k[:, :, j0:j0 + tile].to(torch.float32)
        vt = v[:, :, j0:j0 + tile].to(torch.float32)
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).to(torch.float32), vt)
        state[i % splits] = (m_new, l, acc)
    m, l, acc = state[0]           # split 0 saw key 0: its m is finite
    for m_s, l_s, acc_s in state[1:]:
        m_tot = torch.maximum(m, m_s)
        a, b = torch.exp(m - m_tot), torch.exp(m_s - m_tot)
        l, acc, m = l * a + l_s * b, acc * a + acc_s * b, m_tot
    return _head_major(acc / l, q.dtype)


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Launch the attention kernel on [B,H,N,d] CUDA tensors or views."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention_cuda takes CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B,H,Nq,d] and k, v the same [B,H,Nk,d]")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if not 1 <= d <= _MAX_HEAD_DIM or nq < 1 or nk < 1:
        raise ValueError(f"attention kernel takes 1 <= d <= {_MAX_HEAD_DIM} "
                         f"and at least one query and one key")
    if b * h * -(-nq // 16) > _MAX_BLOCKS:
        raise ValueError("attention kernel: too many row tiles for one grid")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if d > 1 and not (q.stride(3) == k.stride(3) == v.stride(3) == 1):
        raise ValueError("attention_cuda takes a contiguous last dimension")
    dtype = _kernels.dtype_code(q.dtype)
    out = torch.empty((b, nq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _kernels.library()
    rc = lib.tpucdc_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, nq,
        nk, d, strides, float(scale), dtype,
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(rc, "attention")
    _kernels.LAUNCHES["attention"] += 1
    return out
