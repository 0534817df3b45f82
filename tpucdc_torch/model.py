"""Decode half of the flagship model: h_s, the z prior, the conditioning head,
g_s and the conditional UNet, mirroring tpucdc/model.py's decode methods.

One ``nn.Module`` holding every decode-side submodule under the JAX
package's names, so a flax checkpoint maps onto it key for key
(``utils.weights``). The encoder (g_a, h_a) waits for the encode slice.
Images are NHWC in [-1, 1].
"""

from __future__ import annotations

import torch
from torch import nn

from tpucdc_torch.codec import (FactorizedPrior, HyperSynthesis,
                                SynthesisTransform)
from tpucdc_torch.config import ModelConfig
from tpucdc_torch.diffusion import ConditioningHead, UNet
from tpucdc_torch.runtime import DEFAULT_POLICY, Policy


class CDCModel(nn.Module):
    def __init__(self, config: ModelConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = self.config = config.validated()
        codec = cfg.codec
        if codec.context != "hyperprior" or codec.num_qualities != 1:
            raise NotImplementedError(
                f"context {codec.context!r} / num_qualities "
                f"{codec.num_qualities} are not ported yet; see ROADMAP.md")
        self.h_s = HyperSynthesis(codec, policy)
        self.factorized = FactorizedPrior(codec.hyper_channels)
        self.g_s = SynthesisTransform(codec, policy) if codec.synthesis else None
        self.cond_head = ConditioningHead(cfg.cond, codec.latent_channels,
                                          policy)
        self.unet = UNet(cfg.unet, policy)

    def z_medians(self) -> torch.Tensor:
        return self.factorized.medians()

    def factorized_tables(self, max_symbols: int = 64) -> dict:
        return self.factorized.cdf_tables(max_symbols)

    def hyper_decode(self, z_hat: torch.Tensor):
        """ẑ → (μ, σ) for the Gaussian conditional."""
        return self.h_s(z_hat)

    def cond_signal(self, y_hat: torch.Tensor):
        """Decoded ŷ → (concat features, cross-attn tokens)."""
        return self.cond_head(y_hat)

    def synthesize(self, y_hat: torch.Tensor) -> torch.Tensor:
        """Deterministic decode ŷ → x̄ (codec.synthesis; unclipped f32)."""
        if self.g_s is None:
            raise ValueError("model has no synthesis transform")
        return self.g_s(y_hat)

    def _with_bar(self, x_t, x_bar):
        """UNet input: [x_t ‖ x̄] when the synthesis path is on."""
        if self.config.codec.synthesis:
            if x_bar is None:
                raise ValueError("codec.synthesis model: denoise needs x_bar")
            return torch.cat([x_t, x_bar.to(x_t.dtype)], dim=-1)
        if x_bar is not None:
            raise ValueError("x_bar passed to a model without codec.synthesis")
        return x_t

    def denoise(self, x_t, t, cond_f, cond_t, x_bar=None) -> torch.Tensor:
        return self.unet(self._with_bar(x_t, x_bar), t, cond_f, cond_t)
