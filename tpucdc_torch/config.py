"""Typed dataclass configs, mirroring tpucdc/config.py field for field.

The codec, conditioning and UNet configs live beside their modules in the
JAX package; the port keeps them all here. Of the training settings only the
ones a preset names are here; the rest wait for the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


CONTEXTS = ("hyperprior", "checkerboard", "channel-ar", "space-channel")


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    hidden_channels: int = 128     # N: width of g_a / h_a / h_s stacks
    latent_channels: int = 192     # M: channels of y
    hyper_channels: int = 128      # channels of z
    # Lower bound on predicted scales (matches GaussianConditional).
    scale_min: float = 0.11
    # Entropy model over y: "hyperprior" (μ, σ from ẑ only), "checkerboard"
    # (two-pass spatial context), "channel-ar" (channel-group conditioning)
    # or "space-channel" (both).
    context: str = "hyperprior"
    # Channel groups of "channel-ar" and "space-channel".
    context_groups: int = 4
    # Variable-rate gain units: learned per-channel gains on y, one row per
    # rate point (1 = single-rate). The bitstream header selects the row.
    num_qualities: int = 1
    # Deterministic synthesis transform g_s: ŷ → x̄, the refiner's anchor.
    synthesis: bool = False

    @property
    def latent_factor(self) -> int:
        return 16                  # four stride-2 stages in g_a

    def validated(self) -> "CodecConfig":
        if self.context not in CONTEXTS:
            raise ValueError(f"unknown context {self.context!r}; "
                             f"expected one of {CONTEXTS}")
        if (self.context in ("channel-ar", "space-channel")
                and (self.context_groups < 1
                     or self.latent_channels % self.context_groups)):
            raise ValueError("latent_channels must divide into "
                             f"context_groups: {self.latent_channels} / "
                             f"{self.context_groups}")
        if self.num_qualities < 1:
            raise ValueError(f"num_qualities must be >= 1: "
                             f"{self.num_qualities}")
        return self


@dataclasses.dataclass(frozen=True)
class ConditioningConfig:
    latent_factor: int = 16
    feature_channels: int = 32     # channels of the concat feature map
    token_dim: int = 128           # dim of the cross-attn token sequence
    hidden_channels: int = 128
    # Resolution of the emitted feature map relative to the image
    # (p = the UNet's post-patch grid).
    output_stride: int = 1
    # Upsampling stage kind; the port implements "repeat" so far.
    upsample: str = "repeat"


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 3
    out_channels: int = 3
    base_channels: int = 64
    channel_mult: tuple[int, ...] = (1, 2, 3, 4)
    num_res_blocks: int = 2
    # Levels (0-indexed, by downsample depth) that get self-attention.
    attn_levels: tuple[int, ...] = (2, 3)
    num_heads: int = 4
    # Space-to-depth factor applied at the input (1 = off).
    patch_size: int = 2
    # Channel count of the concat-conditioning feature map (0 = off).
    cond_channels: int = 0
    # Token dim of the cross-attention conditioning sequence (0 = off).
    cond_token_dim: int = 0
    groups: int = 32
    # First level considered "deep" for block caching (None → the first
    # attention level, or the last level when there is no attention).
    cache_split: Optional[int] = None

    @property
    def level_channels(self) -> tuple[int, ...]:
        return tuple(self.base_channels * m for m in self.channel_mult)

    @property
    def split_level(self) -> int:
        if self.cache_split is not None:
            return self.cache_split
        if self.attn_levels:
            return max(1, min(self.attn_levels))
        return len(self.channel_mult) - 1

    def cache_shape(self, batch: int, height: int, width: int
                    ) -> tuple[int, int, int, int]:
        """Shape of the deep-segment cache for an image of (height, width)."""
        split = self.split_level
        down = self.patch_size * 2 ** (split - 1)
        return (batch, height // down, width // down,
                self.level_channels[split])


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "cosine"
    num_steps: int = 1000


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    codec: CodecConfig = CodecConfig()
    cond: ConditioningConfig = ConditioningConfig()
    unet: UNetConfig = UNetConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    cond_dropout_prob: float = 0.1
    # UNet output parameterization: "eps", "x0" or "residual"
    # (x₀ = x̄ + net output; codec.synthesis only).
    prediction: str = "eps"
    t_low_frac: float = 0.0
    t_low_prob: float = 0.0

    def validated(self) -> "ModelConfig":
        """Rewrite the UNet conditioning dims to match the conditioning head."""
        if self.prediction not in ("eps", "x0", "residual"):
            raise ValueError(f"unknown prediction mode {self.prediction!r}")
        if self.prediction == "residual" and not self.codec.synthesis:
            raise ValueError(
                "prediction='residual' refines the synthesis reconstruction "
                "x̄ — it requires codec.synthesis=True")
        if not (0.0 <= self.t_low_prob <= 1.0):
            raise ValueError(f"t_low_prob must be in [0,1]: {self.t_low_prob}")
        if self.t_low_prob > 0.0 and not (0.0 < self.t_low_frac <= 1.0):
            raise ValueError(
                f"t_low_frac must be in (0,1] when t_low_prob > 0: "
                f"{self.t_low_frac}")
        unet = dataclasses.replace(
            self.unet,
            # With a synthesis transform the UNet input is [x_t ‖ x̄].
            in_channels=6 if self.codec.synthesis else 3,
            cond_channels=self.cond.feature_channels,
            cond_token_dim=self.cond.token_dim)
        cond = dataclasses.replace(
            self.cond, latent_factor=self.codec.latent_factor,
            # Emit conditioning features at the UNet's post-patch grid.
            output_stride=self.unet.patch_size)
        return dataclasses.replace(self, codec=self.codec.validated(),
                                   unet=unet, cond=cond)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training settings the presets name; the rest of the JAX package's
    TrainConfig waits for the training slice."""
    batch_size: int = 32
    crop_size: int = 256
    # R-D tradeoff: loss = rate_bpp + lambda * distortion.
    rd_lambda: float = 1.0


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    steps: int = 100
    eta: float = 0.0
    guidance: float = 1.0
    sampler: str = "ddim"           # "ddim" | "ddpm"
    cache_period: int = 1
    # Truncated refinement decode (codec.synthesis only): sampling starts at
    # t_start = round(truncate_frac · (T-1)) from the noised x̄.
    truncate_frac: float = 0.0
    # Distortion-perception blend: x̂ = x̄ + γ·(x_refined − x̄).
    blend_gamma: float = 1.0


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    sample: SampleConfig = SampleConfig()

    def validated(self) -> "Config":
        return dataclasses.replace(self, model=self.model.validated())
