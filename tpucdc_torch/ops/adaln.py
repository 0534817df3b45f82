"""The DiT block's adaLN norm chain: the gated residual add, LayerNorm, the
adaLN modulation and the rounding to the compute dtype, in one pass.

``adaln(x, shift, scale, dtype, gate=g, y=y)`` returns ``(x', h)``::

    x' = x + g · y                                   (x itself without y)
    h  = (LN(x') · (1 + scale) + shift).to(dtype)    (None without shift)

``x`` is the f32 residual stream [B, N, C]; ``shift``, ``scale`` and
``gate`` are f32 modulation rows [B, 1, C] (views of one adaLN projection
will do); ``y`` is a product's output [B, N, C], f32 or bf16. LayerNorm
has no affine; its statistics and the modulation are f32, and h is rounded
to ``dtype`` once. A DiT block makes three calls (entry: h; mid: x' and h;
exit: x'), the final layer one.

On a CUDA tensor ``adaln`` launches the hand-written kernel of
``csrc/dit_adaln.cu`` (no TPU kernel corresponds to it: the JAX package has
no DiT), one launch a call. On a CPU tensor it runs the plain version
beside it, the PyTorch expressions the DiT block ran before the kernel, so
CPU results are what they were. There is no fallback: a CUDA tensor the
kernel does not take raises. On the card x' is bit-equal to the plain
version's; h differs from PyTorch's LayerNorm by the order of its sums.

Where autograd records (grad enabled and an input that requires grad), the
kernel is the forward of ``_AdaLN``, an autograd.Function whose backward
recomputes the plain version (and its f32 statistics) from the saved inputs
in PyTorch operations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpucdc_torch.ops import _kernels

_MAX_HIDDEN = 1152     # 9 runs of 4 channels a lane of a warp: DiT-XL/2
_MAX_BATCH = 65535     # grid.y of the launch


def adaln(x: torch.Tensor, shift: torch.Tensor | None = None,
          scale: torch.Tensor | None = None, dtype: torch.dtype | None = None,
          *, gate: torch.Tensor | None = None, y: torch.Tensor | None = None,
          eps: float = 1e-6):
    """(x + gate·y, cast(LN(x')·(1 + scale) + shift)); see the module."""
    if (shift is None) != (scale is None) or (gate is None) != (y is None):
        raise ValueError("adaln takes shift with scale and gate with y")
    if shift is None and y is None:
        raise ValueError("adaln: neither a residual nor a norm was asked for")
    if shift is not None and dtype is None:
        raise ValueError("adaln: the norm's output needs a dtype")
    if not x.is_cuda:
        return adaln_reference(x, shift, scale, dtype, gate=gate, y=y, eps=eps)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, shift, scale, gate, y)):
        outs = iter(_AdaLN.apply(x, shift, scale, gate, y, dtype, eps))
        return (x if y is None else next(outs),
                None if shift is None else next(outs))
    return adaln_cuda(x, shift, scale, dtype, gate=gate, y=y, eps=eps)


def adaln_reference(x, shift=None, scale=None, dtype=None, *, gate=None,
                    y=None, eps: float = 1e-6):
    """Plain version: ``x + gate * y``, then ``F.layer_norm`` and
    ``addcmul`` in f32 and the cast, as the DiT block wrote them."""
    if y is not None:
        x = x + gate * y
    h = None
    if shift is not None:
        h = torch.addcmul(shift, F.layer_norm(x, (x.shape[-1],), eps=eps),
                          1.0 + scale).to(dtype)
    return x, h


class _AdaLN(torch.autograd.Function):
    """The kernel forward; a backward through the plain version, recomputed
    from the saved inputs. Returns the outputs asked for: x' with a
    residual, then h with a norm."""

    @staticmethod
    def forward(ctx, x, shift, scale, gate, y, dtype, eps: float):
        ctx.save_for_backward(x, shift, scale, gate, y)
        ctx.dtype, ctx.eps = dtype, eps
        x_new, h = adaln_cuda(x, shift, scale, dtype, gate=gate, y=y, eps=eps)
        return tuple(t for t in (None if y is None else x_new, h)
                     if t is not None)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[:5]
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        x, shift, scale, gate, y = inputs
        with torch.enable_grad():
            x_new, h = adaln_reference(x, shift, scale, ctx.dtype, gate=gate,
                                       y=y, eps=ctx.eps)
            outs = [t for t in (None if y is None else x_new, h)
                    if t is not None]
            wanted = [t for t, need in zip(inputs, needs) if need]
            found = iter(torch.autograd.grad(outs, wanted, grads,
                                             allow_unused=True))
        return (*(next(found) if need else None for need in needs), None,
                None)


def _check_rows(name: str, t: torch.Tensor, b: int, c: int, device) -> None:
    if t.shape != (b, 1, c) or t.dtype != torch.float32:
        raise ValueError(f"adaln: {name} must be [{b}, 1, {c}] float32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.stride(2) != 1 or t.device != device:
        raise ValueError(f"adaln: {name} must have a contiguous last "
                         f"dimension on the input's device")


def check_inputs(x, shift=None, scale=None, dtype=None, *, gate=None,
                 y=None) -> tuple[int, int]:
    """What the kernel takes, on any device; raises on anything else.
    Returns (the kernel's y dtype code, its h dtype code), -1 for none."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"adaln kernel takes x [B, N, C] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("adaln kernel takes a contiguous, 16-byte aligned x")
    b, n, c = x.shape
    if c % 8 or not 8 <= c <= _MAX_HIDDEN or n < 1 or not 1 <= b <= _MAX_BATCH:
        raise ValueError(f"adaln kernel takes C a multiple of 8 up to "
                         f"{_MAX_HIDDEN}, 1 to {_MAX_BATCH} images and a "
                         f"token, got {tuple(x.shape)}")
    for name, t in (("gate", gate), ("shift", shift), ("scale", scale)):
        if t is not None:
            _check_rows(name, t, b, c, x.device)
    y_code = h_code = -1
    if y is not None:
        if y.shape != x.shape or y.device != x.device:
            raise ValueError(f"adaln: y {tuple(y.shape)} is not x's shape "
                             f"{tuple(x.shape)} on its device")
        if not y.is_contiguous() or y.data_ptr() % 16:
            raise ValueError("adaln kernel takes a contiguous, 16-byte "
                             "aligned y")
        y_code = _kernels.dtype_code(y.dtype)
    if shift is not None:
        h_code = _kernels.dtype_code(dtype)
    return y_code, h_code


def adaln_cuda(x: torch.Tensor, shift=None, scale=None, dtype=None, *,
               gate=None, y=None, eps: float = 1e-6):
    """Launch the adaLN kernel on CUDA tensors; returns ``(x', h)``."""
    y_code, h_code = check_inputs(x, shift, scale, dtype, gate=gate, y=y)
    if not x.is_cuda:
        raise ValueError("adaln_cuda takes CUDA tensors")
    b, n, c = x.shape
    x_out = None if y is None else torch.empty_like(x)
    h = None if shift is None else torch.empty(x.shape, dtype=dtype,
                                               device=x.device)
    rows = (gate, shift, scale)
    ptrs = [0 if t is None else t.data_ptr() for t in rows]
    strides = [0 if t is None else t.stride(0) for t in rows]
    lib = _kernels.library()
    rc = lib.tpucdc_dit_adaln(
        x.data_ptr(), 0 if y is None else y.data_ptr(), *ptrs, *strides,
        0 if x_out is None else x_out.data_ptr(),
        0 if h is None else h.data_ptr(), b, n, c, float(eps), y_code,
        h_code, torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(rc, "adaln")
    _kernels.LAUNCHES["adaln"] += 1
    return (x if x_out is None else x_out), h
