"""Config presets: the CPU-test ``tiny`` model, the large ``flagship`` with its
sweep axes, the two trained models, and the served flagship with a DiT-XL/2
refiner."""

from __future__ import annotations

import dataclasses

from tpucdc_torch.config import (CodecConfig, ConditioningConfig, Config,
                                 DiTConfig, ModelConfig, SampleConfig,
                                 ScheduleConfig, TrainConfig, UNetConfig)


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
        train=TrainConfig(batch_size=8, crop_size=64, lr=3e-4,
                          warmup_steps=100, rd_lambda=8.0),
        sample=SampleConfig(steps=50),
    ).validated()


def flagship() -> Config:
    """The full-size model, the same as tpucdc.presets.flagship(): Kodak
    768×512, DDIM-100 decode, ε-prediction.

    patch_size 4 (space-to-depth at the input, depth-to-space at the output)
    puts the UNet on a 192×128 grid for 768×512 inputs, with attention at
    1536 and 384 tokens (head widths 48 and 64). Conditioning features are
    emitted at the post-patch grid.
    """
    return Config(
        model=ModelConfig(
            codec=CodecConfig(hidden_channels=128, latent_channels=192,
                              hyper_channels=128, synthesis=True),
            cond=ConditioningConfig(feature_channels=64, token_dim=192,
                                    hidden_channels=192),
            unet=UNetConfig(base_channels=64, channel_mult=(1, 2, 3, 4),
                            num_res_blocks=2, attn_levels=(2, 3), num_heads=4,
                            patch_size=4, groups=32),
            schedule=ScheduleConfig(kind="cosine", num_steps=1000),
        ),
        train=TrainConfig(batch_size=32, crop_size=256, rd_lambda=32.0),
        sample=SampleConfig(steps=100),
    ).validated()


# λ grid of the rate-distortion sweep.
RD_LAMBDA_GRID: tuple[float, ...] = (4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def rd_sweep(base: Config | None = None) -> list[Config]:
    base = base or flagship()
    return [
        dataclasses.replace(
            base, train=dataclasses.replace(base.train, rd_lambda=lam))
        for lam in RD_LAMBDA_GRID
    ]


# Guidance and step-count sweep axes of the perceptual evaluation.
GUIDANCE_GRID: tuple[float, ...] = (1.0, 1.5, 2.0, 3.0)
STEP_GRID: tuple[int, ...] = (10, 25, 50, 100)


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


# The dot-overrides that turn ``flagship()`` into ``flagship_serving()``'s
# model and sample blocks: how the CLI reaches the trained flagship
# (``--preset flagship --set k=v ...``), as the JAX package's CLI would.
SERVING_OVERRIDES: dict[str, str] = {
    "model.cond.feature_channels": "32",
    "model.cond.token_dim": "96",
    "model.cond.hidden_channels": "96",
    "model.unet.base_channels": "32",
    "model.unet.channel_mult": "1,2,3",
    "model.unet.attn_levels": "2",
    "model.unet.groups": "16",
    "model.prediction": "residual",
    "sample.steps": "5",
    "sample.truncate_frac": "0.15",
    "sample.blend_gamma": "0.5",
}

# The three codec overrides that, on top of SERVING_OVERRIDES, give
# ``vr_wide_serving()``'s model.
VR_WIDE_OVERRIDES: dict[str, str] = {
    "model.codec.context": "space-channel",
    "model.codec.context_groups": "4",
    "model.codec.num_qualities": "3",
}


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


def dit_xl2_serving() -> Config:
    """``flagship_serving()``'s codec, conditioning head and sample block
    with a DiT-XL/2 refiner at its published widths (Peebles & Xie,
    arXiv:2212.09748; ``DiT_XL_2`` in facebookresearch/DiT): 28 blocks,
    hidden 1152, 16 heads of 72, patch 2, MLP 4608, the learned σ half,
    adaLN-Zero. It runs on the flagship's space-to-depth-4 grid: a 768×512
    image is 96×64 = 6144 tokens. The repo holds no trained DiT: serve it
    with the flagship's weights for the codec and head and the refiner
    drawn (``api.load_model``)."""
    cfg = flagship_serving()
    model = dataclasses.replace(
        cfg.model, refiner="dit",
        dit=DiTConfig(hidden=1152, depth=28, heads=16, patch=2,
                      mlp_ratio=4.0, learn_sigma=True))
    return dataclasses.replace(cfg, model=model).validated()
