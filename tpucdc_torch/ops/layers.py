"""NHWC convolution and dense layers with flax's padding and weight layout.

The port keeps the JAX package's NHWC layout at every module boundary. A
convolution sees its input as the NCHW view ``x.permute(0, 3, 1, 2)`` of an
NHWC tensor, which is NCHW in the channels_last memory format: cuDNN takes it
without a copy, and permuting the channels_last result back gives a
contiguous NHWC tensor again.

Padding follows flax ``"SAME"``, which is asymmetric for even inputs with a
stride: a 3×3 stride-2 conv pads (0, 1), not (1, 1). flax's
``ConvTranspose(padding="SAME")`` is a conv over the stride-dilated input with
the kernel as stored, padded (k+s-2) split ceil/floor; PyTorch's transposed
conv flips the kernel and pads symmetrically, so the weight is stored
flipped and the extra trailing rows and columns are cropped.

Weights are kept in the parameter dtype and cast to the compute dtype of the
caller's policy at each call, as flax does with ``dtype=``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _transpose_pads(k: int, s: int) -> tuple[int, int]:
    """flax/lax conv_transpose "SAME" padding of the dilated input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return pad_a, pad_len - pad_a


class Conv(nn.Module):
    """2-D convolution over NHWC with flax "SAME" padding.

    ``weight`` is OIHW (PyTorch's layout); ``utils.weights`` maps flax's HWIO
    kernels onto it.
    """

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.k, self.stride = k, stride

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype).permute(0, 3, 1, 2)
        ph = _same_pads(x.shape[2], self.k, self.stride)
        pw = _same_pads(x.shape[3], self.k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = 0
        y = F.conv2d(x, self.weight.to(dtype), self.bias.to(dtype),
                     stride=self.stride, padding=padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax ``ConvTranspose(k, stride, padding="SAME")`` over NHWC.

    ``weight`` is PyTorch's transposed-conv layout [in, out, k, k], holding
    the flax HWIO kernel flipped in both spatial axes.
    """

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int):
        super().__init__()
        pad_a, pad_b = _transpose_pads(k, stride)
        if pad_a < pad_b or pad_a > k - 1:
            raise ValueError(f"unsupported transposed conv k={k} s={stride}")
        self.weight = nn.Parameter(torch.zeros(in_ch, out_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride = stride
        self.padding = k - 1 - pad_a
        self.crop = pad_a - pad_b

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2),
                               self.weight.to(dtype), self.bias.to(dtype),
                               stride=self.stride, padding=self.padding)
        if self.crop:
            y = y[:, :, :y.shape[2] - self.crop, :y.shape[3] - self.crop]
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``Dense`` over the last axis; ``weight`` is [out, in]."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC ×2 nearest upsampling (``jnp.repeat`` on H then W)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)
