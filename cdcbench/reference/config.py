# Frozen copy of the port's config.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Typed dataclass configs, mirroring tpucdc/config.py field for field.

The codec, conditioning and UNet configs live beside their modules in the
JAX package; the port keeps them all here. ``apply_overrides`` is the CLI's
``--set a.b.c=value``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Optional


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
    # Upsampling stage kind: "repeat" (nearest ×2, then a conv) or "shuffle"
    # (a conv to 4·ch at the low resolution, then depth-to-space ×2).
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
    batch_size: int = 32
    crop_size: int = 256
    steps: int = 1_000_000
    lr: float = 1e-4
    warmup_steps: int = 5_000
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    ema_decay: float = 0.9999
    # R-D tradeoff: loss = rate_bpp + lambda * distortion.
    rd_lambda: float = 1.0
    # Variable-rate training: a λ per quality (len == codec.num_qualities);
    # empty = single-rate with rd_lambda.
    rd_lambdas: tuple[float, ...] = ()
    # Distortion term: "eps" | "x0" | "both".
    distortion: str = "eps"
    # Weight of the diffusion (ε/x₀) terms when codec.synthesis splits them
    # off the λ-weighted distortion (pipelines.train.loss_fn).
    diff_weight: float = 1.0
    # LPIPS(-proxy) term on the clipped one-step x₀ prediction (the
    # refiner's output), never on x̄.
    lpips_weight: float = 0.0
    # Adam learning rate of the factorized prior's quantiles.
    aux_lr: float = 1e-2
    # Optimizer steps per loop iteration (K): logging, checkpoints and fault
    # injection fall on K-step boundaries.
    steps_per_dispatch: int = 1
    log_every: int = 100
    checkpoint_every: int = 5_000
    seed: int = 0
    # Debug fault injection: exit the process with code 42 at this step.
    fault_inject_step: int = -1
    # Parameter placement over a mesh: "replicated", or "tensor" (the EMA
    # and the optimizer moments sharded over the model axis,
    # parallel/tp_rules.py).
    param_sharding: str = "replicated"


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
    # Where the CLI's eval verbs write metrics.jsonl without --workdir: a
    # "tpucdc" directory in the temporary directory (TMPDIR).
    workdir: str = os.path.join(tempfile.gettempdir(), "tpucdc")

    def validated(self) -> "Config":
        return dataclasses.replace(self, model=self.model.validated())


def apply_overrides(cfg: Any, overrides: dict[str, str]) -> Any:
    """Apply ``{"sample.steps": "5", ...}`` dot-overrides to a dataclass tree."""
    for key, raw in overrides.items():
        cfg = _set_path(cfg, key.split("."), raw)
    return cfg


def _set_path(node, parts, raw):
    field_name = parts[0]
    if not dataclasses.is_dataclass(node):
        raise TypeError(f"cannot override into non-dataclass {type(node)}")
    fields = {f.name for f in dataclasses.fields(node)}
    if field_name not in fields:
        raise KeyError(
            f"no config field {field_name!r} on {type(node).__name__}")
    current = getattr(node, field_name)
    if len(parts) > 1:
        new_val = _set_path(current, parts[1:], raw)
    else:
        new_val = _coerce(raw, current)
    return dataclasses.replace(node, **{field_name: new_val})


def _coerce(raw: str, current):
    """``raw`` as the type of the value it replaces; a tuple is
    comma-separated, and an empty tuple default is inferred per element."""
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        if current:
            elem_t = type(current[0])
            return tuple(elem_t(v) for v in raw.split(",") if v)
        return tuple(_coerce_scalar(v) for v in raw.split(",") if v)
    return raw


def _coerce_scalar(v: str):
    """int if it parses, else float, else the string."""
    for t in (int, float):
        try:
            return t(v)
        except ValueError:
            continue
    return v
