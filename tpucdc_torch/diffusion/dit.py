"""Diffusion transformer refiner: DiT (Peebles & Xie, "Scalable Diffusion
Models with Transformers", arXiv:2212.09748), as ``DiT_XL_2`` of
facebookresearch/DiT builds it, on the codec's pixel grid.

The input [x_t ‖ x̄] goes through the UNet's space-to-depth (factor
``space_to_depth``), the conditioning features are concatenated on that
grid, and a ``patch``×``patch`` stride-``patch`` convolution embeds the
tokens; a fixed 2-D sin-cos position embedding is built for the grid of the
input, so tiles and other sizes work. The timestep embedder is DiT's (256
frequencies → Dense → SiLU → Dense); the codec has no classes, so the
conditioning vector is c = t_emb + ``null_class``, the one learned row that
DiT keeps for classifier-free guidance. Each block is adaLN-Zero::

    (s1, b1, g1, s2, b2, g2) = Dense(SiLU(c))
    x += g1 · Attn(LN(x) · (1 + b1) + s1)
    x += g2 · MLP(LN(x) · (1 + b2) + s2)

with LayerNorm at eps 1e-6 and no affine, a qkv Dense with bias, softmax(q·kᵀ
/ √d)·v through ``ops.attention`` (the hand-written kernel on the card),
a proj Dense, and MLP = Dense → GELU(tanh) → Dense. The final layer is
adaLN (shift, scale) and a Dense to ``patch``² · 2 · C channels (C the
space-to-depth grid's image channels); the tokens are unpatchified, the
learned-σ half is dropped (DDIM at η = 0 does not read it, as DiT's own
DDIM sampling does not) and the grid goes back to pixels by depth-to-space.
The cross-attention tokens of the conditioning head are not read.

The residual stream, the norms and the modulation are f32; the products run
in the policy's compute dtype. The chain between two products (the gated
residual add, LayerNorm, the modulation and the rounding to the compute
dtype) is one ``ops.adaln`` call, one hand-written kernel on the card: three
a block (entry, mid-block, exit) and one in the final layer. The eager
forward opens the spans ``dit.embed`` [tokens], ``dit.block`` (one a block)
and ``dit.final``; the served decode replays it as a CUDA graph
(``sampling.graphed``), whose spans are ``unet.capture`` and
``unet.replay``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpucdc_torch.config import DiTConfig
from tpucdc_torch.diffusion.unet import _depth_to_space, _space_to_depth
from tpucdc_torch.ops import adaln, attention, sinusoidal_time_embed
from tpucdc_torch.ops.layers import Conv, Dense
from tpucdc_torch.runtime import DEFAULT_POLICY, Policy
from tpucdc_torch.utils.profiling import span

LN_EPS = 1e-6
FREQUENCY_DIM = 256     # sinusoidal frequencies of DiT's timestep embedder
IMAGE_CHANNELS = 3      # of the net output


def pos_embed_2d(dim: int, rows: int, cols: int,
                 device=None) -> torch.Tensor:
    """DiT's fixed 2-D sin-cos position embedding of a ``rows``×``cols``
    token grid, [rows·cols, dim] f32 in row-major token order: the first
    half of the channels encodes each token's column, the second its row,
    each as [sin ‖ cos] of ``dim``/4 frequencies (computed in float64)."""
    f64 = torch.float64
    omega = torch.arange(dim // 4, dtype=f64, device=device) / (dim / 4.0)
    omega = 1.0 / 10000.0 ** omega

    def one_axis(pos):
        out = pos[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)
    col = torch.arange(cols, dtype=f64, device=device).repeat(rows)
    row = torch.arange(rows, dtype=f64, device=device).repeat_interleave(cols)
    return torch.cat([one_axis(col), one_axis(row)], dim=1).to(torch.float32)


class DiTBlock(nn.Module):
    """One adaLN-Zero transformer block over [B, N, hidden] f32 tokens."""

    def __init__(self, hidden: int, heads: int, mlp_hidden: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.heads = heads
        self.adaLN = Dense(hidden, 6 * hidden)
        self.qkv = Dense(hidden, 3 * hidden)
        self.proj = Dense(hidden, hidden)
        self.fc1 = Dense(hidden, mlp_hidden)
        self.fc2 = Dense(mlp_hidden, hidden)

    def _attend(self, h: torch.Tensor, dt) -> torch.Tensor:
        b, n, d = h.shape
        qkv = self.qkv(h, dt).reshape(b, n, 3, self.heads, d // self.heads)
        # [B, H, N, d] views of the projection, read in place by the kernel.
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, d), dt)

    def forward(self, x: torch.Tensor, c_act: torch.Tensor) -> torch.Tensor:
        """``x`` [B, N, hidden] f32, ``c_act`` = SiLU(c) [B, hidden]."""
        dt = self.policy.compute_dtype
        mod = self.adaLN(c_act, dt).to(torch.float32)[:, None, :]
        s1, b1, g1, s2, b2, g2 = mod.chunk(6, dim=-1)
        _, h = adaln(x, s1, b1, dt, eps=LN_EPS)
        x, h = adaln(x, s2, b2, dt, gate=g1, y=self._attend(h, dt), eps=LN_EPS)
        h = F.gelu(self.fc1(h, dt), approximate="tanh")
        x, _ = adaln(x, gate=g2, y=self.fc2(h, dt))
        return x


class DiT(nn.Module):
    """``DiT(x, t, cond_features, cond_tokens) -> net output`` (f32, NHWC),
    the call of ``UNet.forward``: ``x`` is [x_t ‖ x̄] (or x_t), ``t`` [B]
    timesteps, ``cond_features`` the conditioning head's map on the
    space-to-depth grid; ``cond_tokens`` is accepted and not read."""

    def __init__(self, config: DiTConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = self.config = config
        self.policy = policy
        s2 = cfg.space_to_depth ** 2
        self.x_embedder = Conv(cfg.in_channels * s2 + cfg.cond_channels,
                               cfg.hidden, cfg.patch, stride=cfg.patch)
        self.temb_dense1 = Dense(FREQUENCY_DIM, cfg.hidden)
        self.temb_dense2 = Dense(cfg.hidden, cfg.hidden)
        self.null_class = nn.Parameter(torch.zeros(cfg.hidden))
        self.blocks = nn.ModuleList(
            DiTBlock(cfg.hidden, cfg.heads, cfg.mlp_hidden, policy)
            for _ in range(cfg.depth))
        self.final_adaLN = Dense(cfg.hidden, 2 * cfg.hidden)
        out = IMAGE_CHANNELS * s2 * (2 if cfg.learn_sigma else 1)
        self.final_linear = Dense(cfg.hidden, cfg.patch ** 2 * out)
        # Position embeddings by (rows, cols, device): constants, made at a
        # shape's first (eager) call, so that a captured graph reads them.
        self._pos: dict = {}

    def _pos_embed(self, rows: int, cols: int, device) -> torch.Tensor:
        key = (rows, cols, device)
        if key not in self._pos:
            with torch.inference_mode(False):
                self._pos[key] = pos_embed_2d(self.config.hidden, rows, cols,
                                              device)
        return self._pos[key]

    def _embed(self, x, t, cond_features):
        cfg, pol = self.config, self.policy
        dt = pol.compute_dtype
        h = _space_to_depth(pol.cast_to_compute(x), cfg.space_to_depth)
        if cond_features is not None:
            if cond_features.shape[1:3] != h.shape[1:3]:
                raise ValueError(
                    f"cond_features grid {tuple(cond_features.shape[1:3])} is "
                    f"not the space-to-depth grid {tuple(h.shape[1:3])}")
            h = torch.cat([h, pol.cast_to_compute(cond_features)], dim=-1)
        h = self.x_embedder(h, dt)
        b, rows, cols, d = h.shape
        tokens = (h.reshape(b, rows * cols, d).to(torch.float32)
                  + self._pos_embed(rows, cols, h.device))
        temb = sinusoidal_time_embed(t, FREQUENCY_DIM)
        c = self.temb_dense2(F.silu(self.temb_dense1(temb, dt)), dt)
        c = c.to(torch.float32) + self.null_class
        return tokens, F.silu(c), (rows, cols)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond_features: Optional[torch.Tensor] = None,
                cond_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        if (cfg.cond_channels > 0) != (cond_features is not None):
            raise ValueError("cond_features must match config.cond_channels")
        with span("dit.embed") as s:
            h, c_act, (rows, cols) = self._embed(x, t, cond_features)
            s.add("tokens", h.shape[0] * h.shape[1])
        for block in self.blocks:
            with span("dit.block"):
                h = block(h, c_act)
        with span("dit.final"):
            dt = self.policy.compute_dtype
            mod = self.final_adaLN(c_act, dt).to(torch.float32)[:, None, :]
            shift, scale = mod.chunk(2, dim=-1)
            _, h = adaln(h, shift, scale, dt, eps=LN_EPS)
            out = self.final_linear(h, dt)
            p = cfg.patch
            b = out.shape[0]
            out = out.reshape(b, rows, cols, p, p, -1).permute(0, 1, 3, 2, 4, 5)
            out = out.reshape(b, rows * p, cols * p, -1)
            # DiT's learned σ is the second half of the channels.
            out = out[..., :IMAGE_CHANNELS * cfg.space_to_depth ** 2]
            return _depth_to_space(out.to(torch.float32), cfg.space_to_depth)
