# Frozen copy of the port's reference/dit.py, the benchmark's reference of
# the DiT refiner: nothing of the port imported; under ``fp8_products()``
# (``ops.layers``) its products, which the port runs in bf16, round their
# operands to float8 e4m3 (the lower-precision control); TF32 is the
# caller's to pin (``codec_ref.pin_f32``).
"""The DiT refiner written out in plain PyTorch, float32: the reference that
the port's ``diffusion.dit`` is held to.

It follows ``DiT_XL_2`` of facebookresearch/DiT ``models.py`` (Peebles &
Xie, "Scalable Diffusion Models with Transformers", arXiv:2212.09748) with
no kernel, cache or graph: every product is a ``torch.matmul``, LayerNorm,
GELU and SiLU are written as equations. Its parameters carry the port's
names and shapes (``DiT.state_dict()`` loads as it is). The block::

    (s1, b1, g1, s2, b2, g2) = Linear(SiLU(c))
    x += g1 · Attn(LN(x) · (1 + b1) + s1)
    x += g2 · MLP(LN(x) · (1 + b2) + s2)

LN at eps 1e-6 without affine; Attn a qkv Linear with bias, softmax(q·kᵀ/√d)
·v per head and a proj Linear; MLP Linear → GELU(tanh) → Linear. The final
layer: LN · (1 + scale) + shift, then a Linear to patch² · 2 · C.

Departures from DiT, each forced by the codec:

* pixel space through space-to-depth: the tokens are patches of the
  space-to-depth-4 grid of [x_t ‖ x̄] (96 channels for 3-channel images),
  not of a VAE latent;
* the conditioning head's features are concatenated on that grid before the
  patch embed (96 + 32 = 128 input channels);
* the codec has no classes: c = t_emb + one learned vector, the null-label
  row that DiT keeps for classifier-free guidance;
* the position grid is rectangular, built for the (rows, cols) of the input;
* the learned σ half of the output is dropped: DDIM at η = 0 reads the mean
  alone, as DiT's own DDIM sampling does;
* weights are drawn (the benchmark's ``draw_dit``) where DiT initialises to
  zero (every adaLN modulation and the final Linear): the repo has no trained
  DiT, and with zeros every block would be the identity.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from cdcbench.reference.ops.layers import fp8_on, fp8_round


def _product(a, b):
    """a·b in f32, or, under the control, of the operands in fp8 (bf16
    result, returned in f32)."""
    if fp8_on():
        return torch.matmul(fp8_round(a), fp8_round(b)).to(torch.float32)
    return torch.matmul(a, b)


class Linear(nn.Module):
    """``weight`` [out, in], ``bias`` [out]."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _product(x, self.weight.t()) + self.bias


class PatchEmbed(nn.Module):
    """A p×p stride-p convolution as a product: ``weight`` [out, in, p, p]."""

    def __init__(self, n_in: int, n_out: int, p: int):
        super().__init__()
        self.p = p
        self.weight = nn.Parameter(torch.zeros(n_out, n_in, p, p))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] → [B, H/p, W/p, out]."""
        b, h, w, c = x.shape
        p = self.p
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, h // p, w // p, c * p * p)
        return (_product(x, self.weight.reshape(self.weight.shape[0], -1)
                         .t()) + self.bias)


def silu(x):
    return x * torch.sigmoid(x)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def layer_norm(x, eps: float = 1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def modulate(x, shift, scale):
    return x * (1.0 + scale) + shift


def attention(q, k, v):
    """softmax(q·kᵀ/√d)·v over [B, H, N, d] (under the control, P in bf16
    as the port's kernel takes it)."""
    logits = _product(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    p = torch.softmax(logits, dim=-1)
    if fp8_on():
        return torch.matmul(p.to(torch.bfloat16).to(torch.float32),
                            fp8_round(v).to(torch.float32))
    return torch.matmul(p, v)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """DiT's ``TimestepEmbedder.timestep_embedding``: [cos ‖ sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def pos_embed(dim: int, rows: int, cols: int) -> np.ndarray:
    """DiT's ``get_2d_sincos_pos_embed`` on a rows×cols grid, float64
    [rows·cols, dim]."""
    grid = np.meshgrid(np.arange(cols, dtype=np.float64),
                       np.arange(rows, dtype=np.float64))
    grid = np.stack(grid, axis=0).reshape(2, 1, rows, cols)

    def one_axis(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64)
                                / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    return np.concatenate([one_axis(dim // 2, grid[0]),
                           one_axis(dim // 2, grid[1])], axis=1)


def space_to_depth(x, s: int):
    """NHWC, channels ordered (py, px, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // s, w // s, s * s * c)


def depth_to_space(x, s: int):
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, s, s, c // (s * s)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * s, w * s, c // (s * s))


class Block(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_hidden: int):
        super().__init__()
        self.heads = heads
        self.adaLN = Linear(hidden, 6 * hidden)
        self.qkv = Linear(hidden, 3 * hidden)
        self.proj = Linear(hidden, hidden)
        self.fc1 = Linear(hidden, mlp_hidden)
        self.fc2 = Linear(mlp_hidden, hidden)

    def forward(self, x, c):
        s1, b1, g1, s2, b2, g2 = self.adaLN(silu(c))[:, None].chunk(6, -1)
        h = modulate(layer_norm(x), s1, b1)
        b, n, d = h.shape
        q, k, v = self.qkv(h).reshape(b, n, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4)
        a = attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        x = x + g1 * self.proj(a)
        h = modulate(layer_norm(x), s2, b2)
        return x + g2 * self.fc2(gelu_tanh(self.fc1(h)))


class DiTReference(nn.Module):
    """``forward(x, t, cond_features)`` → [B, H, W, out_channels] f32, the
    call of the port's ``DiT``. The shape arguments are ``DiTConfig``'s,
    and DiT's 256 timestep frequencies."""

    def __init__(self, hidden: int, depth: int, heads: int, patch: int,
                 mlp_ratio: float, learn_sigma: bool, space_to_depth: int,
                 in_channels: int, cond_channels: int,
                 out_channels: int = 3, frequency_dim: int = 256):
        super().__init__()
        self.s, self.patch, self.hidden = space_to_depth, patch, hidden
        self.out_channels, self.frequency_dim = out_channels, frequency_dim
        s2 = space_to_depth ** 2
        self.x_embedder = PatchEmbed(in_channels * s2 + cond_channels,
                                     hidden, patch)
        self.temb_dense1 = Linear(frequency_dim, hidden)
        self.temb_dense2 = Linear(hidden, hidden)
        self.null_class = nn.Parameter(torch.zeros(hidden))
        self.blocks = nn.ModuleList(
            Block(hidden, heads, int(hidden * mlp_ratio))
            for _ in range(depth))
        self.final_adaLN = Linear(hidden, 2 * hidden)
        self.final_linear = Linear(
            hidden, patch ** 2 * out_channels * s2 * (2 if learn_sigma else 1))

    @classmethod
    def from_config(cls, dit: dict) -> "DiTReference":
        """From a ``DiTConfig``'s fields as a dict (``dataclasses.asdict``
        or a configuration file's ``model.dit``)."""
        keys = ("hidden", "depth", "heads", "patch", "mlp_ratio",
                "learn_sigma", "space_to_depth", "in_channels",
                "cond_channels")
        return cls(**{k: dit[k] for k in keys})

    def forward(self, x, t, cond_features=None, cond_tokens=None):
        h = space_to_depth(x.to(torch.float32), self.s)
        if cond_features is not None:
            h = torch.cat([h, cond_features.to(torch.float32)], dim=-1)
        h = self.x_embedder(h)
        b, rows, cols, d = h.shape
        pos = torch.from_numpy(pos_embed(d, rows, cols)).to(torch.float32)
        h = h.reshape(b, rows * cols, d) + pos.to(h.device)
        c = self.temb_dense2(silu(self.temb_dense1(
            timestep_embedding(t, self.frequency_dim)))) + self.null_class
        for block in self.blocks:
            h = block(h, c)
        shift, scale = self.final_adaLN(silu(c))[:, None].chunk(2, -1)
        out = self.final_linear(modulate(layer_norm(h), shift, scale))
        p = self.patch
        out = out.reshape(b, rows, cols, p, p, -1).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, rows * p, cols * p, -1)
        return depth_to_space(out[..., :self.out_channels * self.s ** 2],
                              self.s)
