"""Serving decode: bitstream → uint8 image, mirroring tpucdc/pipelines/codec_runtime.py.

``CodecRuntime(config, model).decompress(blob)`` runs the flagship's served
decode for the hyperprior context at a single rate:

  1. host: container parse + z rANS decode (``_host_z_stage``);
  2. hyper stage: ẑ = z_sym + medians → h_s → (μ, σ) → uint8 Gaussian row
     indexes (``_hyper_stage``; the equivalent of JAX's ``_hyper_decode_fn``);
  3. host: y rANS decode with those indexes;
  4. device stage (``_device_stage``, JAX's ``_sample_fn``): ŷ = y_sym + μ,
     the conditioning head, g_s → x̄, the truncated DDIM refine
     (``steps=0`` is the mean decode x̄), the γ blend, uint8.

The hyper stage always runs under F32_POLICY with TF32 off: one σ that lands
in a different scale-table row than the encoder's desyncs rANS, and a bf16
convolution here cannot reproduce the encoder's bf16 rounding. The device
stage runs under the runtime's ``policy`` (bf16 compute by default, as JAX
serves). Other contexts, variable rate, classifier-free guidance, DDPM,
block caching and tiled/batched decode raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpucdc_torch.codec.entropy_models import GaussianConditional
from tpucdc_torch.config import Config
from tpucdc_torch.entropy import RansCodec, read_bitstream
from tpucdc_torch.model import CDCModel
from tpucdc_torch.ops import make_schedule
from tpucdc_torch.runtime import (DEFAULT_POLICY, F32_POLICY, Policy,
                                  disable_tf32, resolve_device, set_policy)
from tpucdc_torch.sampling import ddim_sample, ddim_step_tables

PAD_MULTIPLE = 64  # g_a 16× · h_a 4×


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x + 1.0) * 127.5 + 0.5, 0, 255).to(torch.uint8)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md")


class CodecRuntime:
    """Bind (config, model) to the card and serve ``decompress()`` calls."""

    def __init__(self, config: Config, model: CDCModel, device="cuda",
                 policy: Policy = DEFAULT_POLICY):
        self.config = config.validated()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.model = model.to(self.device).eval()
        set_policy(self.model, policy)
        set_policy(self.model.h_s, F32_POLICY)
        self.policy = policy
        self.schedule = make_schedule(self.config.model.schedule.kind,
                                      self.config.model.schedule.num_steps)
        self.gaussian = GaussianConditional()
        # The served decode codes with the C++ coder only; RansCodec raises
        # if it does not build.
        self.z_codec = RansCodec(model.factorized_tables(), use_native=True)
        self.y_codec = RansCodec(self.gaussian.cdf_tables(), use_native=True)
        self._z_medians = model.z_medians().to(self.device)
        cf = self.config.model.codec
        self._hyper_c = cf.hyper_channels
        self._synth = cf.synthesis

    # ---- stages ----

    def _t_start(self) -> int | None:
        frac = self.config.sample.truncate_frac
        if not self._synth or frac <= 0.0:
            return None
        T = self.config.model.schedule.num_steps
        return max(1, int(round(frac * (T - 1))))

    def _decode_tables(self, steps: int, eta: float) -> dict:
        """DDIM step tables; synthesis models always start from q_sample(x̄)."""
        t_start = self._t_start()
        if self._synth and t_start is None:
            t_start = self.config.model.schedule.num_steps - 1
        return ddim_step_tables(self.schedule, steps, eta, t_start)

    def _host_z_stage(self, blob: bytes):
        """Host-only part of decode: container parse + z rANS decode."""
        hdr, streams = read_bitstream(blob)
        if len(streams) != 2:
            raise _not_ported(f"a {len(streams)}-stream (context) bitstream")
        z_bytes, y_bytes = streams
        ph = hdr.height + ((-hdr.height) % PAD_MULTIPLE)
        pw = hdr.width + ((-hdr.width) % PAD_MULTIPLE)
        z_shape = (1, ph // PAD_MULTIPLE, pw // PAD_MULTIPLE, self._hyper_c)
        z_rows = np.broadcast_to(
            np.arange(self._hyper_c, dtype=np.int32), z_shape)
        z_sym = self.z_codec.decode(z_bytes, z_rows)
        return hdr, z_sym, y_bytes, (ph, pw)

    @torch.inference_mode()
    def _hyper_stage(self, z_sym: np.ndarray):
        """z symbols → (μ on the device, uint8 row indexes on the host)."""
        z = torch.from_numpy(np.ascontiguousarray(z_sym)).to(self.device)
        z_hat = z.to(torch.float32) + self._z_medians
        means, scales = self.model.hyper_decode(z_hat)
        idx = self.gaussian.build_indexes(scales).to(torch.uint8)
        return means, idx.cpu().numpy()

    def _decode_symbols(self, blob: bytes):
        """Bitstream → (header, ŷ symbols [device], μ [device], padded hw)."""
        hdr, z_sym, y_bytes, (ph, pw) = self._host_z_stage(blob)
        means, indexes = self._hyper_stage(z_sym)
        y_sym = self.y_codec.decode(y_bytes, indexes)
        return hdr, torch.from_numpy(y_sym).to(self.device), means, (ph, pw)

    @torch.inference_mode()
    def _device_stage(self, y_sym: torch.Tensor, means: torch.Tensor,
                      steps: int, eta: float, gamma, ph: int, pw: int,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """(ŷ symbols, μ) → uint8 [1, ph, pw, 3] on the device."""
        y_hat = y_sym.to(torch.float32) + means
        cond_f, cond_t = self.model.cond_signal(y_hat)
        x_bar = None
        if self._synth:
            x_bar = self.model.synthesize(y_hat)
            if steps == 0:
                return _to_uint8(x_bar)
        shape = (y_hat.shape[0], ph, pw, 3)
        if generator is None and noise is None:
            generator = torch.Generator(self.device).manual_seed(0)

        def net_fn(x_t, t):
            return self.model.denoise(x_t, t, cond_f, cond_t, x_bar)

        x0 = ddim_sample(net_fn, self.schedule, shape, num_steps=steps,
                         noise=noise, generator=generator, device=self.device,
                         x_ref=x_bar, tables=self._decode_tables(steps, eta),
                         prediction=self.config.model.prediction)
        if x_bar is not None:
            if np.ndim(gamma) == 2:
                # Per-tile γ grid (v5), bilinearly upsampled to the padded
                # canvas as jax.image.resize(..., "bilinear") does.
                g = torch.as_tensor(np.asarray(gamma, np.float32),
                                    device=self.device)
                g = F.interpolate(g[None, None], size=(ph, pw),
                                  mode="bilinear", align_corners=False)
                g = g[0, 0][None, :, :, None]
            else:
                g = float(np.float32(gamma))
            x0 = x_bar + g * (x0 - x_bar)
        return _to_uint8(x0)

    # ---- public API ----

    def decompress(self, blob: bytes, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   steps: int | None = None, eta: float | None = None,
                   gamma=None) -> np.ndarray:
        """Bitstream → HWC uint8 reconstruction.

        ``noise`` is the sampler's initial ε, NHWC [1, H_pad, W_pad, 3]; it is
        drawn from ``generator`` (seed 0 on the runtime's device when both are
        None). ``gamma`` resolves as: the explicit argument (scalar or a
        [gh, gw] grid), then the v5 header grid, then the header scalar, then
        ``SampleConfig.blend_gamma``.
        """
        sample = self.config.sample
        if sample.sampler != "ddim":
            raise _not_ported(f"sampler {sample.sampler!r}")
        if sample.cache_period > 1:
            raise _not_ported("block-cached sampling")
        hdr, y_sym, means, (ph, pw) = self._decode_symbols(blob)
        if steps is None:
            steps = hdr.steps or sample.steps
        if steps == 0 and not self._synth:
            raise ValueError("steps=0 (mean decode) needs codec.synthesis")
        if float(hdr.guidance or sample.guidance) != 1.0:
            raise _not_ported("classifier-free guidance")
        eta = sample.eta if eta is None else eta
        if gamma is None:
            if hdr.gamma_grid is not None and steps != 0:
                gamma = hdr.gamma_grid_f
            else:
                gamma = (hdr.gamma_or_none if hdr.gamma_or_none is not None
                         else sample.blend_gamma)
        img = self._device_stage(y_sym, means, steps, eta, gamma, ph, pw,
                                 noise, generator)
        return img.cpu().numpy()[0][:hdr.height, :hdr.width]
