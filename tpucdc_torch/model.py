"""The model: codec front end (g_a, h_a, h_s, the z prior, the context entropy
model, the variable-rate gains), the conditioning head, g_s and the
conditional refiner, mirroring tpucdc/model.py. The refiner is the UNet
(``unet``), or with ``config.refiner == "dit"`` a diffusion transformer
(``dit``, ``diffusion.dit``), which the JAX package does not have.

One ``nn.Module`` holding every submodule under the JAX package's names, so
a flax checkpoint maps onto it key for key (``utils.weights``). ``forward``
is the training forward (the rate and diffusion loss ingredients),
``rate_estimate`` the analytic rate probe, and the other methods the coding
pieces the runtime calls. Images are NHWC in [-1, 1]; the latent y is 16×
downsampled, z a further 4×.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from tpucdc_torch.codec import (AnalysisTransform, ChannelARContext,
                                CheckerboardContext, FactorizedPrior,
                                GaussianConditional, HyperAnalysis,
                                HyperSynthesis, SpaceChannelContext,
                                SynthesisTransform, passes)
from tpucdc_torch.codec.quantization import quantize_dequantize, ste_round
from tpucdc_torch.config import ModelConfig
from tpucdc_torch.diffusion import ConditioningHead, DiT, UNet
from tpucdc_torch.runtime import DEFAULT_POLICY, Policy
from tpucdc_torch.utils.profiling import span


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
        if cfg.refiner == "dit":
            self.dit = DiT(cfg.dit, policy)
        else:
            self.unet = UNet(cfg.unet, policy)
        n, m = codec.hidden_channels, codec.latent_channels
        self.context = None     # the hyperprior's one pass is h_s itself
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

    # ---- training forward ----

    def forward(self, x: torch.Tensor, schedule_tables: dict,
                train: bool = True, quality: Optional[torch.Tensor] = None,
                draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """Joint rate-distortion + diffusion forward pass.

        x: [B,H,W,3] in [-1,1]; schedule_tables: dict with 'sqrt_ab' and
        'sqrt_1mab' [T] tensors on x's device. With num_qualities > 1,
        ``quality`` is a [B] int tensor of gain indices (drawn uniformly when
        None). Returns the loss ingredients under the JAX package's keys.

        Every random draw can be injected through ``draws``: "quality" [B],
        "u_z" and "u_y" (the additive U(-½, ½) noise, shaped as z and y),
        "keep" [B] bool (conditioning dropout: True keeps), "t" [B] int and
        "eps" (x's shape). A draw left out is made from ``generator``, in
        that order, on x's device.
        """
        draws = dict(draws or {})
        cfg = self.config
        b = x.shape[0]

        def draw(name, make):
            if name not in draws:
                draws[name] = make()
            return draws[name].to(x.device)

        def uniform(shape):
            return torch.rand(shape, generator=generator, device=x.device)

        nq = cfg.codec.num_qualities
        with span("model.analysis"):
            if nq > 1 and quality is None:
                quality = draw("quality", lambda: torch.randint(
                    0, nq, (b,), generator=generator, device=x.device))
            y = self.g_a(x)
            if nq > 1:
                y = y * self.gains[quality.long()][:, None, None, :]
            z = self.h_a(y)
        with span("model.entropy"):
            if train:
                z_tilde = z + draw("u_z", lambda: uniform(z.shape) - 0.5)
                u_y = draw("u_y", lambda: uniform(y.shape) - 0.5)
            else:
                med = self.factorized.medians().reshape(1, 1, 1, -1)
                z_tilde = ste_round(z - med) + med
                u_y = None
            lik_z = self.factorized(z_tilde)
            y_tilde, means, scales = self._entropy_params(y, z_tilde, u_y)
            lik_y = GaussianConditional().likelihood(y_tilde, means, scales)

        with span("model.synthesis"):
            y_for_cond = y_tilde
            if nq > 1:
                inv = self.inv_gains[quality.long()]
                y_for_cond = y_tilde * inv[:, None, None, :]
            x_bar = self.g_s(y_for_cond) if cfg.codec.synthesis else None
            cond_f, cond_t = self.cond_head(y_for_cond)
            x_bar_in = x_bar
            if train and cfg.cond_dropout_prob > 0:
                # Classifier-free guidance training: zero the conditioning
                # of a random subset, so the UNet learns an unconditional
                # branch.
                keep = draw("keep", lambda: uniform((b,))
                            >= cfg.cond_dropout_prob)
                keep4 = keep[:, None, None, None]
                cond_f = cond_f * keep4.to(cond_f.dtype)
                cond_t = cond_t * keep[:, None, None].to(cond_t.dtype)
                if x_bar is not None:
                    x_bar_in = x_bar * keep4.to(x_bar.dtype)

        with span("model.unet"):
            T = schedule_tables["sqrt_ab"].shape[0]

            def draw_t():
                t = torch.randint(0, T, (b,), generator=generator,
                                  device=x.device)
                if cfg.t_low_prob > 0.0:
                    # Low-t bias: concentrate refiner training on the noise
                    # range that truncated serving visits.
                    t_low = torch.randint(0, max(int(cfg.t_low_frac * T), 1),
                                          (b,), generator=generator,
                                          device=x.device)
                    t = torch.where(uniform((b,)) < cfg.t_low_prob, t_low, t)
                return t
            t = draw("t", draw_t)
            eps = draw("eps", lambda: torch.randn(
                x.shape, generator=generator, device=x.device))
            sab = schedule_tables["sqrt_ab"][t.long()].reshape(-1, 1, 1, 1)
            s1mab = schedule_tables["sqrt_1mab"][t.long()].reshape(-1, 1, 1, 1)
            x_t = sab * x + s1mab * eps
            unet_in = (x_t if x_bar_in is None
                       else torch.cat([x_t, x_bar_in.to(x_t.dtype)], dim=-1))
            net_out = self.refiner(unet_in, t, cond_f, cond_t)

        with span("model.rate"):
            bpp_y, bpp_z = self._bpp(x, lik_y, lik_z)
            if cfg.prediction in ("x0", "residual"):
                # x₀ is the net output, or x̄ plus it ("residual"); x̄ is
                # detached there, so the refiner's terms do not reach g_s,
                # g_a and the entropy models. ε is derived for the metric
                # only, with √(1−ᾱ) floored, and detached.
                if cfg.prediction == "residual":
                    x0_pred = x_bar.detach() + net_out
                else:
                    x0_pred = net_out
                eps_hat = ((x_t - sab * x0_pred)
                           / torch.clamp_min(s1mab, 5e-2)).detach()
            else:
                eps_hat = net_out
                x0_pred = (x_t - s1mab * eps_hat) / torch.clamp_min(sab, 1e-3)
        return {"eps": eps, "eps_hat": eps_hat, "t": t,
                "bpp_y": bpp_y, "bpp_z": bpp_z,
                "x0_pred": x0_pred, "x0": x, "x_bar": x_bar,
                "y": y, "y_tilde": y_tilde, "z": z, "quality": quality}

    def training_draws(self, x_shape, num_timesteps: int, train: bool = True,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> dict:
        """Every draw ``forward(x, train=train, generator=generator)`` makes
        for an x of ``x_shape``, made up front in ``forward``'s order and at
        its shapes (y and z from g_a's 16× and h_a's further 4× "SAME"
        downsampling): quality, u_z, u_y, keep, t (then the t-low randint
        and uniform), ε. From the same generator the values are
        ``forward``'s own, so a data-parallel rank that slices the global
        batch's draws trains the trajectory of the whole batch."""
        cfg = self.config
        codec = cfg.codec
        b, h, w, _ = x_shape
        down = lambda n, f: -(-n // f)
        y_shape = (b, down(h, 16), down(w, 16), codec.latent_channels)
        z_shape = (b, down(y_shape[1], 4), down(y_shape[2], 4),
                   codec.hyper_channels)

        def uniform(shape):
            return torch.rand(shape, generator=generator, device=device)

        def randint(high):
            return torch.randint(0, high, (b,), generator=generator,
                                 device=device)

        draws = {}
        if codec.num_qualities > 1:
            draws["quality"] = randint(codec.num_qualities)
        if train:
            draws["u_z"] = uniform(z_shape) - 0.5
            draws["u_y"] = uniform(y_shape) - 0.5
            if cfg.cond_dropout_prob > 0:
                draws["keep"] = uniform((b,)) >= cfg.cond_dropout_prob
        t = randint(num_timesteps)
        if cfg.t_low_prob > 0.0:
            t_low = randint(max(int(cfg.t_low_frac * num_timesteps), 1))
            t = torch.where(uniform((b,)) < cfg.t_low_prob, t_low, t)
        draws["t"] = t
        draws["eps"] = torch.randn(tuple(x_shape), generator=generator,
                                   device=device)
        return draws

    def _entropy_params(self, y: torch.Tensor, z_tilde: torch.Tensor,
                        u_y: Optional[torch.Tensor]):
        """(ỹ, μ, σ): ỹ = y + u_y in training (``u_y`` given), else y
        quantized pass by pass against each pass's μ, as the coder rounds
        it."""
        if u_y is not None:
            y_tilde = y + u_y
            _, means, scales = self.y_schedule().walk(z_tilde,
                                                      passes.given(y_tilde))
            return y_tilde, means, scales
        return self.y_schedule().walk(
            z_tilde, lambda p, mask, mean, scale: (
                quantize_dequantize(y[..., p.channels], mean), mean, scale))

    @staticmethod
    def _bpp(x: torch.Tensor, lik_y: torch.Tensor, lik_z: torch.Tensor):
        n = x.shape[0] * x.shape[1] * x.shape[2]
        return (torch.sum(-torch.log2(lik_y)) / n,
                torch.sum(-torch.log2(lik_z)) / n)

    def aux_loss(self) -> torch.Tensor:
        return self.factorized.aux_loss()

    def rate_estimate(self, x: torch.Tensor,
                      gain: Optional[torch.Tensor] = None):
        """Analytic (bpp_y, bpp_z) for x under eval-mode quantization, the
        rate probe behind ``CodecRuntime.estimate_bpp``: the entropy half of
        ``forward(train=False)`` without the diffusion half. ``gain`` is a
        [C] vector (None = single-rate); the bpps are per padded pixel."""
        y, z = self.encode(x, gain)
        med = self.factorized.medians().reshape(1, 1, 1, -1)
        z_tilde = ste_round(z - med) + med
        lik_z = self.factorized(z_tilde)
        y_tilde, means, scales = self._entropy_params(y, z_tilde, None)
        lik_y = GaussianConditional().likelihood(y_tilde, means, scales)
        return self._bpp(x, lik_y, lik_z)

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

    def y_schedule(self, stage=contextlib.nullcontext) -> passes.Schedule:
        """The passes over y of h_s and the context module
        (``codec.passes``); ``stage`` opens the spans of a coder."""
        return passes.y_schedule(self.h_s, self.context, stage)

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

    @property
    def refiner(self) -> nn.Module:
        """The denoiser: the UNet or the DiT."""
        return self.dit if self.config.refiner == "dit" else self.unet

    def denoise(self, x_t, t, cond_f, cond_t, x_bar=None) -> torch.Tensor:
        return self.refiner(self._with_bar(x_t, x_bar), t, cond_f, cond_t)

    def denoise_fresh(self, x_t, t, cond_f, cond_t, x_bar=None):
        """Full forward → (net output, deep-block cache) for cached sampling."""
        return self.unet(self._with_bar(x_t, x_bar), t, cond_f, cond_t,
                         return_cache=True)

    def denoise_cached(self, x_t, t, cond_f, cond_t, deep_cache, x_bar=None):
        """Shallow-only forward that reuses the deep cache."""
        return self.unet(self._with_bar(x_t, x_bar), t, cond_f, cond_t,
                         deep_cache=deep_cache)
