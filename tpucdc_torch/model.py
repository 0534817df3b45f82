"""The model: codec front end (g_a, h_a, h_s, the z prior, the context entropy
model, the variable-rate gains), the conditioning head, g_s and the
conditional UNet, mirroring tpucdc/model.py's coding methods.

One ``nn.Module`` holding every submodule under the JAX package's names, so
a flax checkpoint maps onto it key for key (``utils.weights``). The training
forward and the analytic rate estimate wait for the training slice. Images
are NHWC in [-1, 1]; the latent y is 16× downsampled, z a further 4×.
"""

from __future__ import annotations

import torch
from torch import nn

from tpucdc_torch.codec import (AnalysisTransform, ChannelARContext,
                                CheckerboardContext, FactorizedPrior,
                                HyperAnalysis, HyperSynthesis,
                                SpaceChannelContext, SynthesisTransform)
from tpucdc_torch.config import ModelConfig
from tpucdc_torch.diffusion import ConditioningHead, UNet
from tpucdc_torch.runtime import DEFAULT_POLICY, Policy


class CDCModel(nn.Module):
    def __init__(self, config: ModelConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = self.config = config.validated()
        codec = cfg.codec
        self.g_a = AnalysisTransform(codec, policy)
        self.h_a = HyperAnalysis(codec, policy)
        self.h_s = HyperSynthesis(codec, policy)
        self.factorized = FactorizedPrior(codec.hyper_channels)
        self.g_s = SynthesisTransform(codec, policy) if codec.synthesis else None
        self.cond_head = ConditioningHead(cfg.cond, codec.latent_channels,
                                          policy)
        self.unet = UNet(cfg.unet, policy)
        n, m = codec.hidden_channels, codec.latent_channels
        if codec.context == "checkerboard":
            self.context = CheckerboardContext(n, m, codec.scale_min, policy)
        elif codec.context == "channel-ar":
            self.context = ChannelARContext(n, m, codec.context_groups,
                                            codec.scale_min, policy)
        elif codec.context == "space-channel":
            self.context = SpaceChannelContext(n, m, codec.context_groups,
                                               codec.scale_min, policy)
        if codec.num_qualities > 1:
            # Variable-rate gain units: y is scaled per quality before the
            # hyper/entropy path and inversely rescaled for conditioning.
            self.gains = nn.Parameter(torch.ones(codec.num_qualities, m))
            self.inv_gains = nn.Parameter(torch.ones(codec.num_qualities, m))

    # ---- encode side ----

    def encode(self, x: torch.Tensor, gain: torch.Tensor | None = None):
        """Image → (y, z) continuous latents.

        ``gain`` is a per-channel [C] vector (a trained row of
        ``gain_tables`` or an interpolation of two): it scales y before
        h_a, so the whole entropy path works in the gained domain.
        """
        y = self.g_a(x)
        if gain is not None:
            y = y * gain
        return y, self.h_a(y)

    def inv_gain(self, y_hat: torch.Tensor, inv_gain: torch.Tensor):
        """ŷ (gained domain) → conditioning domain, by a [C] vector."""
        return y_hat * inv_gain

    def gain_tables(self):
        """(gains, inv_gains) [Q, C], the source of quality interpolation."""
        return self.gains.detach(), self.inv_gains.detach()

    # ---- entropy parameters ----

    def z_medians(self) -> torch.Tensor:
        return self.factorized.medians()

    def factorized_tables(self, max_symbols: int = 64) -> dict:
        return self.factorized.cdf_tables(max_symbols)

    def hyper_decode(self, z_hat: torch.Tensor):
        """ẑ → (μ, σ) for the Gaussian conditional."""
        return self.h_s(z_hat)

    def hyper_features(self, z_hat: torch.Tensor) -> torch.Tensor:
        """ẑ → the context models' feature trunk."""
        return self.h_s(z_hat, features=True)

    def ctx_anchor_params(self, feats):
        return self.context.anchor_params(feats)

    def ctx_nonanchor_params(self, feats, y_anchor_masked):
        return self.context.nonanchor_params(feats, y_anchor_masked)

    def ctx_group_params(self, group: int, feats, y_prev):
        """Channel-AR: (μ, σ) of channel group ``group`` given prior groups."""
        return self.context.group_params(group, feats, y_prev)

    def sc_anchor_params(self, group: int, feats, y_prev):
        """Space-channel: group anchors from hyper + prior groups."""
        return self.context.anchor_params(group, feats, y_prev)

    def sc_nonanchor_params(self, group: int, feats, y_prev, y_g_anchor):
        """Space-channel: group non-anchors (+ masked same-group anchors)."""
        return self.context.nonanchor_params(group, feats, y_prev, y_g_anchor)

    # ---- decode side ----

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
