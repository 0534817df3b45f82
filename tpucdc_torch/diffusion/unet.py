"""Conditional UNet denoiser, mirroring tpucdc/diffusion/unet.py.

Down/up path of ResBlocks (GN+SiLU on the fused kernel), self- and
cross-attention at the configured levels and at mid, a sinusoidal timestep
embedding, and latent conditioning by channel concat (features at the
post-patch grid) and by cross-attention (tokens as K/V). An input
space-to-depth "patch" and an output depth-to-space put the network on a
coarser grid. The forward pass is cut at ``config.split_level`` into a shallow
and a deep segment, so that block-cached sampling can reuse the deep
segment's output (``deep_cache`` / ``return_cache``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpucdc_torch.config import UNetConfig
from tpucdc_torch.diffusion.blocks import (AttentionBlock, Downsample, GNSiLU,
                                           ResBlock, Upsample)
from tpucdc_torch.ops import sinusoidal_time_embed
from tpucdc_torch.ops.layers import Conv, Dense
from tpucdc_torch.runtime import DEFAULT_POLICY, Policy
from tpucdc_torch.utils.profiling import span


def _space_to_depth(x: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC space-to-depth with channels ordered (py, px, c) — not
    ``F.pixel_unshuffle``'s (c, py, px)."""
    if p == 1:
        return x
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // p, w // p, p * p * c)


def _depth_to_space(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`_space_to_depth` (channels read as (py, px, c))."""
    if p == 1:
        return x
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, p, p, c // (p * p))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * p, w * p, c // (p * p))


class UNet(nn.Module):
    """``UNet(x_t, t, cond_features, cond_tokens) -> net output`` (f32, NHWC).

    Call once with ``return_cache=True`` for (output, cache), then pass
    ``deep_cache=cache`` on later steps to skip the deep segment.
    """

    def __init__(self, config: UNetConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = self.config = config
        self.policy = policy
        levels = cfg.level_channels
        temb_dim = cfg.base_channels * 4
        ctx = cfg.cond_token_dim or None

        self.temb_dense1 = Dense(cfg.base_channels, temb_dim)
        self.temb_dense2 = Dense(temb_dim, temb_dim)
        stem_in = cfg.in_channels * cfg.patch_size ** 2 + cfg.cond_channels
        self.conv_in = Conv(stem_in, cfg.base_channels, 3)

        def attn_list(li, ch, n, context_dim):
            if li not in cfg.attn_levels:
                return nn.ModuleList()
            return nn.ModuleList(
                AttentionBlock(ch, context_dim, cfg.num_heads, cfg.groups,
                               policy) for _ in range(n))

        # Channel bookkeeping follows the skip stack of the forward pass.
        skip_ch = [cfg.base_channels]
        ch = cfg.base_channels
        self.down_res, self.down_attn, self.down_xattn = (
            nn.ModuleList(), nn.ModuleList(), nn.ModuleList())
        self.downsamplers = nn.ModuleList()
        for li, lc in enumerate(levels):
            res = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                res.append(ResBlock(ch, lc, temb_dim, cfg.groups, policy))
                ch = lc
                skip_ch.append(ch)
            self.down_res.append(res)
            self.down_attn.append(attn_list(li, lc, cfg.num_res_blocks, None))
            self.down_xattn.append(
                attn_list(li, lc, cfg.num_res_blocks, ctx) if ctx
                else nn.ModuleList())
            if li != len(levels) - 1:
                self.downsamplers.append(Downsample(lc, policy))
                skip_ch.append(lc)

        self.mid_res1 = ResBlock(ch, levels[-1], temb_dim, cfg.groups, policy)
        self.mid_attn = AttentionBlock(levels[-1], None, cfg.num_heads,
                                       cfg.groups, policy)
        self.mid_xattn = (AttentionBlock(levels[-1], ctx, cfg.num_heads,
                                         cfg.groups, policy) if ctx else None)
        self.mid_res2 = ResBlock(levels[-1], levels[-1], temb_dim, cfg.groups,
                                 policy)
        ch = levels[-1]

        self.up_res, self.up_attn, self.up_xattn = (
            nn.ModuleList(), nn.ModuleList(), nn.ModuleList())
        self.upsamplers = nn.ModuleList()
        up_res = {}
        for li in reversed(range(len(levels))):
            lc = levels[li]
            res = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                res.append(ResBlock(ch + skip_ch.pop(), lc, temb_dim,
                                    cfg.groups, policy))
                ch = lc
            up_res[li] = res
        # Registered in level order so the indexes match flax's up_res_{li}_*.
        for li, lc in enumerate(levels):
            self.up_res.append(up_res[li])
            n = cfg.num_res_blocks + 1
            self.up_attn.append(attn_list(li, lc, n, None))
            self.up_xattn.append(attn_list(li, lc, n, ctx) if ctx
                                 else nn.ModuleList())
            if li != 0:
                self.upsamplers.append(Upsample(lc, policy))

        self.norm_out = GNSiLU(cfg.base_channels, cfg.groups, policy)
        self.conv_out = Conv(cfg.base_channels,
                             cfg.out_channels * cfg.patch_size ** 2, 3)

    def _temb(self, t: torch.Tensor) -> torch.Tensor:
        dt = self.policy.compute_dtype
        temb = sinusoidal_time_embed(t, self.config.base_channels)
        return self.temb_dense2(F.silu(self.temb_dense1(temb, dt)), dt)

    def _stem(self, x_t, cond_features):
        cfg, pol = self.config, self.policy
        p = cfg.patch_size
        h = _space_to_depth(pol.cast_to_compute(x_t), p)
        if cond_features is not None:
            cf = pol.cast_to_compute(cond_features)
            if cf.shape[1] == x_t.shape[1]:
                cf = _space_to_depth(cf, p)
            elif cf.shape[1] != h.shape[1]:
                raise ValueError(
                    f"cond_features height {cf.shape[1]} matches neither the "
                    f"image ({x_t.shape[1]}) nor the patch grid ({h.shape[1]})")
            h = torch.cat([h, cf], dim=-1)
        return self.conv_in(h, pol.compute_dtype)

    def _attend(self, li, bi, h, cond_tokens, attn, xattn):
        if li in self.config.attn_levels:
            with span("unet.attn"):
                h = attn[li][bi](h)
                if cond_tokens is not None:
                    h = xattn[li][bi](h, cond_tokens)
        return h

    def _down_level(self, li, h, temb, cond_tokens, skips):
        for bi in range(self.config.num_res_blocks):
            with span("unet.res"):
                h = self.down_res[li][bi](h, temb)
            h = self._attend(li, bi, h, cond_tokens, self.down_attn,
                             self.down_xattn)
            skips.append(h)
        if li != len(self.config.channel_mult) - 1:
            with span("unet.resample"):
                h = self.downsamplers[li](h)
            skips.append(h)
        return h

    def _up_level(self, li, h, temb, cond_tokens, skips):
        for bi in range(self.config.num_res_blocks + 1):
            with span("unet.res"):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = self.up_res[li][bi](h, temb)
            h = self._attend(li, bi, h, cond_tokens, self.up_attn,
                             self.up_xattn)
        if li != 0:
            with span("unet.resample"):
                h = self.upsamplers[li - 1](h)
        return h

    def _deep(self, h, temb, cond_tokens):
        """Levels ≥ split_level down + mid + up, with skips of their own.

        Input and output live at the split boundary: the input is level
        split-1's downsample output, the output is the upsampled tensor the
        shallow up path consumes.
        """
        split = self.config.split_level
        n_levels = len(self.config.channel_mult)
        # The boundary tensor is both the deep input and the first deep skip
        # (popped by up-level split's last res block).
        skips = [h]
        for li in range(split, n_levels):
            h = self._down_level(li, h, temb, cond_tokens, skips)
        with span("unet.res"):
            h = self.mid_res1(h, temb)
        with span("unet.attn"):
            h = self.mid_attn(h)
            if cond_tokens is not None:
                h = self.mid_xattn(h, cond_tokens)
        with span("unet.res"):
            h = self.mid_res2(h, temb)
        for li in reversed(range(split, n_levels)):
            h = self._up_level(li, h, temb, cond_tokens, skips)
        if skips:
            raise RuntimeError("UNet deep skip stack not consumed")
        return h

    def forward(self, x_t: torch.Tensor, t: torch.Tensor,
                cond_features: Optional[torch.Tensor] = None,
                cond_tokens: Optional[torch.Tensor] = None,
                deep_cache: Optional[torch.Tensor] = None,
                return_cache: bool = False):
        """The net output; with ``return_cache`` (output, deep cache in f32).

        ``deep_cache`` (from an earlier ``return_cache`` call) stands in for
        the deep segment, which is then not run.
        """
        cfg, pol = self.config, self.policy
        if (cfg.cond_channels > 0) != (cond_features is not None):
            raise ValueError("cond_features must match config.cond_channels")
        if (cfg.cond_token_dim > 0) != (cond_tokens is not None):
            raise ValueError("cond_tokens must match config.cond_token_dim")
        if cond_tokens is not None:
            cond_tokens = pol.cast_to_compute(cond_tokens)

        with span("unet.stem"):
            temb = self._temb(t)
            h = self._stem(x_t, cond_features)

        split = cfg.split_level
        skips = [h]                  # the conv_in skip: up level 0's last pop
        for li in range(split):
            h = self._down_level(li, h, temb, cond_tokens, skips)
        # The boundary skip (level split-1's downsample output, which is h)
        # belongs to the deep segment, which pushes it again itself.
        skips.pop()

        if deep_cache is not None:
            deep_out = pol.cast_to_compute(deep_cache)
        else:
            deep_out = self._deep(h, temb, cond_tokens)

        h = deep_out
        for li in reversed(range(split)):
            h = self._up_level(li, h, temb, cond_tokens, skips)
        if skips:
            raise RuntimeError("UNet skip stack not consumed")

        with span("unet.out"):
            h = self.norm_out(h)
            h = self.conv_out(h, pol.compute_dtype)
            out = _depth_to_space(h, cfg.patch_size).to(torch.float32)
        if return_cache:
            return out, deep_out.to(torch.float32)
        return out
