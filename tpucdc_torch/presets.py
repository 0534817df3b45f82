"""Config presets: the CPU-test ``tiny`` model and the two trained models."""

from __future__ import annotations

import dataclasses

from tpucdc_torch.config import (CodecConfig, ConditioningConfig, Config,
                                 ModelConfig, SampleConfig, ScheduleConfig,
                                 UNetConfig)


def tiny() -> Config:
    """CPU-feasible tiny model, the same as tpucdc.presets.tiny()."""
    return Config(
        model=ModelConfig(
            codec=CodecConfig(hidden_channels=16, latent_channels=32,
                              hyper_channels=16, synthesis=True),
            cond=ConditioningConfig(feature_channels=8, token_dim=32,
                                    hidden_channels=32),
            unet=UNetConfig(base_channels=16, channel_mult=(1, 2),
                            num_res_blocks=1, attn_levels=(1,), num_heads=2,
                            patch_size=2, groups=8),
            schedule=ScheduleConfig(kind="cosine", num_steps=256),
        ),
        sample=SampleConfig(steps=50),
    ).validated()


def flagship_serving() -> Config:
    """The served flagship of ``artifacts/flagship.json``.

    The model is ``scripts/train_rd_sweep.py::build_eval_config(wide=True,
    unet="medium", prediction="residual")``: the medium base of
    ``scripts/train_tpu_demo.py::medium`` with the wide codec (N=128,
    M=192). The sample block is the spec's ``serving`` dial: 5 DDIM steps
    from truncate_frac 0.15, blend γ 0.5.
    """
    return Config(
        model=ModelConfig(
            codec=CodecConfig(hidden_channels=128, latent_channels=192,
                              hyper_channels=128, synthesis=True),
            cond=ConditioningConfig(feature_channels=32, token_dim=96,
                                    hidden_channels=96),
            unet=UNetConfig(base_channels=32, channel_mult=(1, 2, 3),
                            num_res_blocks=2, attn_levels=(2,), num_heads=4,
                            patch_size=4, groups=16),
            schedule=ScheduleConfig(kind="cosine", num_steps=1000),
            prediction="residual",
        ),
        sample=SampleConfig(steps=5, truncate_frac=0.15, blend_gamma=0.5),
    ).validated()


def vr_wide_serving() -> Config:
    """The variable-rate model of ``artifacts/vr.json``.

    ``scripts/train_vr_sweep.py::vr_sc_config(wide=True,
    prediction="residual")``: the flagship's widths with three gain rows
    (λ = 16, 128, 1024) and the space-channel context in four groups. The
    sample block is the spec's ``serving`` dial, the flagship's.
    """
    cfg = flagship_serving()
    codec = dataclasses.replace(cfg.model.codec, context="space-channel",
                                context_groups=4, num_qualities=3)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, codec=codec)).validated()
