"""Compress and decompress, mirroring tpucdc/pipelines/codec_runtime.py.

``CodecRuntime(config, model)`` binds a model to the card and the host rANS
coders once, then serves ``compress()`` / ``decompress()`` calls for the
four entropy models over y ("hyperprior", "checkerboard", "channel-ar",
"space-channel"), single-rate or with variable-rate gains.

Encode (``compress``):
  1. analysis (``_analysis``): x → g_a → (× gain) → y, h_a → z,
     z symbols = round(z − medians); under the runtime's ``policy``;
  2. the y passes (``_y_passes``, the model's schedule of ``codec.passes``):
     per pass, (μ, σ) from h_s / the context model → uint8 Gaussian row
     indexes, symbols = round(y − μ) on the device, fetched as int32 and
     rANS-coded on the host. 1, 2, G or 2·G passes; a pass's decoded ŷ
     feeds the next pass's context;
  3. host: z rANS encode, container write;
  4. optionally the in-band γ search (``_optimize_gamma``): the served
     decode of the fresh bitstream at each candidate γ, the PSNR argmax
     written into the header (scalar, or a per-tile grid).

Decode (``decompress``):
  1. host: container parse + z rANS decode (``_host_z_stage``);
  2. the same ``_y_passes``, reading streams instead of writing them;
  3. device stage (``_device_stage``, JAX's ``_sample_fn``): ŷ = y_sym + μ,
     × the inverse gain of the header's quality, the conditioning head,
     g_s → x̄, the sampler (``steps=0`` is the mean decode x̄), the γ
     blend, uint8. The sampler is the truncated DDIM refine; with
     ``guidance`` ≠ 1 its net call is batch-doubled classifier-free
     guidance, with ``sample.cache_period`` > 1 it is block-cached DDIM,
     with ``sample.sampler == "ddpm"`` the ancestral sampler over all T
     steps. On the card the plain DDIM and DDPM loops replay the refiner's
     step (the UNet's or the DiT's) as a CUDA graph (``sampling.graphed``).

``decompress_tiled`` decodes a large image as one batch of overlapping tiles
and blends them on the host. ``compress_many`` / ``decompress_many`` are the
batch forms, the same bytes and pixels as the one-by-one calls: the encode is
the loop of ``compress``, the decode queues image i's sampler, lets its uint8
leave unwaited and decodes image i+1's symbols while the card works.

The encoder and the decoder get every row index from the same function
called on tensors of the same shape: ``_y_passes`` is the only place that
evaluates h_s and the context model, and it always runs them under
F32_POLICY with TF32 off (``runtime.pin_numerics``), on the runtime's
device. One σ that lands in a different scale-table row on the two sides
desyncs rANS, and a bf16 convolution cannot reproduce another side's bf16
rounding. g_a, h_a and the device stage run under the runtime's ``policy``
(bf16 compute by default, as JAX serves).

The coder tables are built from the model, or injected (``cdf_tables=``)
from a sidecar that ``save_cdf_tables`` wrote, in the JAX package's format.
``estimate_bpp`` is the analytic rate (``CDCModel.rate_estimate`` plus the
container's fixed bytes) without running the coder; ``compress_to_bpp(
probe="estimate")`` bisects on it. ``decompress_tiled(mesh=)`` shards the
tile batch over the mesh's data axis (``parallel.sharded_sample``); every
rank of the mesh calls it and gets the image.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpucdc_torch.codec import GaussianConditional
from tpucdc_torch.config import PAD_MULTIPLE, Config
from tpucdc_torch.entropy import (BitstreamHeader, RansCodec, read_bitstream,
                                  with_header_gamma, with_header_gamma_grid,
                                  write_bitstream)
from tpucdc_torch.model import CDCModel
from tpucdc_torch.ops import make_schedule
from tpucdc_torch.parallel import (blend_tiles, make_tile_plan,
                                   sharded_sample, split_tiles)
from tpucdc_torch.runtime import (DEFAULT_POLICY, F32_POLICY, Policy,
                                  pin_numerics, resolve_device, set_policy)
from tpucdc_torch.runtime.mesh import DATA_AXIS, axis_size
from tpucdc_torch.sampling import (ddim_sample, ddim_sample_blockcached,
                                   ddim_step_tables, ddpm_sample,
                                   make_batched_cfg_eps_fn)
from tpucdc_torch.sampling.graphed import GraphedDenoiser
from tpucdc_torch.utils.profiling import span


def padded_hw(h: int, w: int, multiple: int = PAD_MULTIPLE):
    """The (h, w) of an h×w image padded to a multiple."""
    return h + (-h) % multiple, w + (-w) % multiple


def pad_image(img: np.ndarray, multiple: int = PAD_MULTIPLE):
    """Reflect-pad an HWC image to a multiple; returns (padded, (h, w))."""
    h, w = img.shape[:2]
    ph, pw = padded_hw(h, w, multiple)
    padded = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode="reflect")
    return padded, (h, w)


def to_model_range(img_u8: np.ndarray) -> np.ndarray:
    return img_u8.astype(np.float32) / 127.5 - 1.0


def from_model_range(x: np.ndarray) -> np.ndarray:
    return np.clip((x + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x + 1.0) * 127.5 + 0.5, 0, 255).to(torch.uint8)


def _mse(a: np.ndarray, ref64: np.ndarray) -> float:
    return float(np.mean((a.astype(np.float64) - ref64) ** 2))


class CodecRuntime:
    """Bind (config, model) to the card; serve compress/decompress calls."""

    _GAMMA_GRID = (0.0, 0.25, 0.5, 0.75, 1.0)
    # Spatial dial: one γ grid node per 128-px tile of the padded canvas.
    GAMMA_TILE = 128

    def __init__(self, config: Config, model: CDCModel, device="cuda",
                 policy: Policy = DEFAULT_POLICY,
                 cdf_tables: Optional[dict] = None):
        """``cdf_tables`` ({"z": {...}, "y": {...}}, as ``load_cdf_tables``
        returns) injects the coder tables in place of building them from the
        model, so that a decode does not rest on the float table build being
        reproducible where the bitstream was made."""
        self.config = config.validated()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            pin_numerics()
        self.model = model.to(self.device).eval()
        cf = self.config.model.codec
        set_policy(self.model, policy)
        set_policy(self.model.h_s, F32_POLICY)
        if self.model.context is not None:
            set_policy(self.model.context, F32_POLICY)
        self._schedule = self.model.y_schedule(span)
        # z, then one stream a pass over y.
        self._n_streams = 1 + len(self._schedule.passes)
        self.policy = policy
        self.schedule = make_schedule(self.config.model.schedule.kind,
                                      self.config.model.schedule.num_steps)
        self.gaussian = GaussianConditional()
        if cdf_tables is not None:
            self._z_tables = dict(cdf_tables["z"])
            self._y_tables = dict(cdf_tables["y"])
        else:
            self._z_tables = model.factorized_tables()
            self._y_tables = self.gaussian.cdf_tables()
        # Coding runs on the C++ coder only; RansCodec raises if it does
        # not build.
        self.z_codec = RansCodec(self._z_tables, use_native=True)
        self.y_codec = RansCodec(self._y_tables, use_native=True)
        self._z_medians = model.z_medians().to(self.device)
        self._latent_c = cf.latent_channels
        self._hyper_c = cf.hyper_channels
        self._nq = cf.num_qualities
        self._synth = cf.synthesis
        self._denoiser = GraphedDenoiser()
        if self._nq > 1:
            # The trained gain ladder, fetched once: quality_gains
            # interpolates on the host.
            self._gain_tables_np = tuple(
                t.cpu().numpy() for t in self.model.gain_tables())

    # ---- the coder-table sidecar ----

    def export_cdf_tables(self) -> dict:
        """The quantized coder tables as numpy arrays, keyed z_*/y_*."""
        out = {}
        for prefix, t in (("z", self._z_tables), ("y", self._y_tables)):
            for k, v in t.items():
                out[f"{prefix}_{k}"] = np.asarray(v)
        return out

    def save_cdf_tables(self, path) -> None:
        """Write the tables to an .npz that ``load_cdf_tables`` reads, in the
        JAX package's format: either package reads the other's file."""
        np.savez(path, **self.export_cdf_tables())

    @staticmethod
    def load_cdf_tables(path) -> dict:
        with np.load(path) as d:
            return {"z": {k[2:]: d[k] for k in d.files if k.startswith("z_")},
                    "y": {k[2:]: d[k] for k in d.files if k.startswith("y_")}}

    # ---- small pieces ----

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

    def _z_rows(self, shape) -> np.ndarray:
        return np.broadcast_to(np.arange(self._hyper_c, dtype=np.int32), shape)

    @staticmethod
    def _fetch(t: torch.Tensor) -> np.ndarray:
        """Device → host; every transfer of the coding path goes through here."""
        with span("codec.fetch", bytes=t.numel() * t.element_size()):
            return t.cpu().numpy()

    def _fetch_later(self, *tensors: torch.Tensor):
        """Start device → host copies without waiting; returns ``wait()``,
        which gives the numpy arrays once these copies (and nothing queued
        after them) are done. On the card the copies go to pinned memory and
        an event marks their end, so work queued behind them is not waited
        for."""
        if self.device.type != "cuda":
            arrays = [self._fetch(t) for t in tensors]
            return lambda: arrays
        pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
            t, non_blocking=True) for t in tensors]
        done = torch.cuda.Event()
        done.record()

        def wait():
            with span("codec.fetch", bytes=sum(
                    b.numel() * b.element_size() for b in pinned)):
                done.synchronize()
                return [b.numpy() for b in pinned]
        return wait

    def quality_gains(self, quality: float):
        """Continuous quality ∈ [0, num_qualities-1] → (gain, inv_gain) [C].

        Integral qualities return the trained ladder rows bitwise;
        fractional q interpolates the adjacent rows in the log domain (rate
        is about log-linear in the gain). Magnitudes are floored at 1e-9
        for the log, and the lower row's sign is carried onto the
        interpolated magnitude.
        """
        if self._nq < 2:
            raise ValueError("continuous quality needs num_qualities > 1")
        q = float(np.clip(quality, 0.0, self._nq - 1))
        gains, inv_gains = self._gain_tables_np
        lo = int(np.floor(q))
        f = q - lo
        if f == 0.0:
            return (gains[lo].astype(np.float32),
                    inv_gains[lo].astype(np.float32))

        def interp(rows):
            lg = np.log(np.maximum(np.abs(rows[lo]), 1e-9))
            hg = np.log(np.maximum(np.abs(rows[lo + 1]), 1e-9))
            mag = np.exp((1.0 - f) * lg + f * hg)
            return np.copysign(mag, rows[lo]).astype(np.float32)
        return interp(gains), interp(inv_gains)

    def _make_header(self, h: int, w: int, quality) -> BitstreamHeader:
        """Header for ``quality`` (ladder index or continuous float).

        A fractional quality sets the v4 ``quality_f`` field and the nearest
        integer ``quality_id``: floor(q+0.5), since banker's rounding would
        bucket the .5 midpoints inconsistently.
        """
        qf = float(quality)
        fractional = qf != int(qf)
        return BitstreamHeader(
            height=h, width=w, quality_id=int(np.floor(qf + 0.5)),
            steps=self.config.sample.steps,
            guidance=self.config.sample.guidance,
            quality_f=qf if fractional else float("nan"))

    def _resolve_quality(self, quality_id: int, quality: float | None):
        """The quality to code at: ``quality`` (continuous, clipped to the
        ladder; an int where integral) if given, else ``quality_id``."""
        if quality is None:
            return int(quality_id)
        if self._nq < 2:
            raise ValueError("continuous quality needs a variable-rate "
                             "model (codec.num_qualities > 1)")
        q = float(np.clip(quality, 0.0, self._nq - 1))
        return int(q) if q == int(q) else q

    # ---- encoder-only stage ----

    @torch.inference_mode()
    def _analysis(self, x: torch.Tensor, quality=0):
        """x → (y, z symbols), both on the device, in the gained domain.

        With gains the gain scales y before h_a, so the whole entropy path
        works in the gained domain; decode applies the inverse gain only at
        the conditioning boundary (``_device_stage``).
        """
        gain = None
        if self._nq > 1:
            gain = torch.from_numpy(self.quality_gains(quality)[0]).to(
                self.device)
        y, z = self.model.encode(x, gain)
        return y, torch.round(z - self._z_medians).to(torch.int32)

    # ---- stages shared by both sides ----

    def _host_z_stage(self, blob: bytes):
        """Host-only part of decode: container parse + z rANS decode.

        Returns (header, z symbols, the y streams, padded (h, w)).
        """
        with span("codec.parse", bytes=len(blob)):
            hdr, streams = read_bitstream(blob)
        if len(streams) != self._n_streams:
            raise ValueError(
                f"a {self.config.model.codec.context} bitstream holds "
                f"{self._n_streams} streams, this one {len(streams)}")
        ph, pw = padded_hw(hdr.height, hdr.width)
        z_shape = (1, ph // PAD_MULTIPLE, pw // PAD_MULTIPLE, self._hyper_c)
        z_sym = self.z_codec.decode(streams[0], self._z_rows(z_shape))
        return hdr, z_sym, streams[1:], (ph, pw)

    def _z_hat(self, z_sym: np.ndarray) -> torch.Tensor:
        z = torch.from_numpy(np.ascontiguousarray(z_sym)).to(self.device)
        return z.to(torch.float32) + self._z_medians

    @torch.inference_mode()
    def _y_passes(self, z_sym: np.ndarray, y: Optional[torch.Tensor] = None,
                  streams=None):
        """The Gaussian-coded passes over y, for both sides: the model's
        schedule (``codec.passes``) walked pass by pass.

        Encoder (``y`` given): each pass rounds y against its μ and codes
        the symbols; returns the streams written. Decoder (``streams``
        given): each pass decodes its stream. Either way every pass's
        (μ, σ) come from the same calls on the same shapes, so both sides
        see the same row indexes. A masked pass codes ``sym[:, mask]``:
        position-major, channel-minor.

        Returns (y symbols int32, μ f32, streams), tensors on the device.
        """
        encoding = y is not None
        src = iter(() if encoding else streams)
        out = []

        def code(p, mask, means, scales):
            idx = self.gaussian.build_indexes(scales).to(torch.uint8)
            idx_np = self._fetch(idx if mask is None else idx[:, mask])
            if encoding:
                sym = torch.round(y[..., p.channels] - means).to(torch.int32)
                out.append(self.y_codec.encode(
                    self._fetch(sym if mask is None else sym[:, mask]),
                    idx_np))
            else:
                dec = torch.from_numpy(
                    self.y_codec.decode(next(src), idx_np)).to(self.device)
                if mask is None:
                    sym = dec.reshape(means.shape)
                else:
                    sym = torch.zeros(means.shape, dtype=torch.int32,
                                      device=self.device)
                    sym[:, mask] = dec
            return sym, means

        # ŷ = symbols + μ, int32 + f32 in f32: the sum of a small integer
        # and an f32 rounds as the f64 sum cast back to f32 does.
        y_sym, means = self._schedule.walk(
            self._z_hat(z_sym), code,
            lambda outs: outs[0].to(torch.float32) + outs[1])
        return y_sym, means, out

    def _decode_symbols(self, blob: bytes):
        """Bitstream → (header, ŷ symbols [device], μ [device], padded hw)."""
        with span("codec.decode_symbols"):
            hdr, z_sym, y_streams, (ph, pw) = self._host_z_stage(blob)
            y_sym, means, _ = self._y_passes(z_sym, streams=y_streams)
        return hdr, y_sym, means, (ph, pw)

    @torch.inference_mode()
    def _device_stage(self, y_sym: torch.Tensor, means: torch.Tensor,
                      steps: int, eta: float, gamma, ph: int, pw: int,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      inv_gain: Optional[np.ndarray] = None,
                      guidance: float = 1.0, cache_period: int = 1,
                      step_noise: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
        """(ŷ symbols, μ) → uint8 [B, ph, pw, 3] on the device; B is ŷ's
        batch (one image, or the tiles of one).

        ``inv_gain`` ([C], variable-rate models) takes ŷ from the gained
        coding domain to the conditioning domain. ``guidance`` ≠ 1 doubles
        the net's batch: the second half carries zeroed conditioning
        (features, tokens and x̄), while the chain's reference stays the real
        x̄. ``cache_period`` > 1 (without guidance) is block-cached DDIM.
        ``noise`` is the initial ε and ``step_noise`` the per-step z (DDPM;
        DDIM with η > 0); what is not given is drawn from ``generator``
        (seed 0 on the runtime's device when None).
        """
        with span("codec.device_stage"):
            with span("codec.cond"):
                y_hat = y_sym.to(torch.float32) + means
                if inv_gain is not None:
                    y_hat = self.model.inv_gain(
                        y_hat, torch.from_numpy(inv_gain).to(self.device))
                cond_f, cond_t = self.model.cond_signal(y_hat)
            x_bar = None
            if self._synth:
                with span("codec.synth"):
                    x_bar = self.model.synthesize(y_hat)
                if steps == 0:
                    with span("codec.blend"):
                        return _to_uint8(x_bar)
            shape = (y_hat.shape[0], ph, pw, 3)
            x0 = self._sample(cond_f, cond_t, x_bar, shape, steps, eta, noise,
                              generator, guidance, cache_period, step_noise)
            with span("codec.blend"):
                if x_bar is not None:
                    if np.ndim(gamma) == 2:
                        # Per-tile γ grid (v5), bilinearly upsampled to the
                        # padded canvas as jax.image.resize(..., "bilinear")
                        # does.
                        g = torch.as_tensor(np.asarray(gamma, np.float32),
                                            device=self.device)
                        g = F.interpolate(g[None, None], size=(ph, pw),
                                          mode="bilinear",
                                          align_corners=False)
                        g = g[0, 0][None, :, :, None]
                    else:
                        g = float(np.float32(gamma))
                    x0 = x_bar + g * (x0 - x_bar)
                return _to_uint8(x0)

    def _sample(self, cond_f, cond_t, x_bar, shape, steps: int, eta: float,
                noise, generator, guidance: float, cache_period: int,
                step_noise) -> torch.Tensor:
        """The sampler of ``_device_stage``: x₀ [B, ph, pw, 3] in f32.

        The plain DDIM and the DDPM loops call the refiner (the UNet or the
        DiT, ``CDCModel.denoise``) through the runtime's
        ``GraphedDenoiser`` (a CUDA graph a shape on the card); block-cached
        DDIM, UNet-only, calls it eagerly."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        model = self.model
        use_cfg = float(guidance) != 1.0
        if use_cfg:
            cond_f2 = torch.cat([cond_f, torch.zeros_like(cond_f)], dim=0)
            cond_t2 = torch.cat([cond_t, torch.zeros_like(cond_t)], dim=0)
            x_bar2 = (None if x_bar is None else
                      torch.cat([x_bar, torch.zeros_like(x_bar)], dim=0))
            net_fn = make_batched_cfg_eps_fn(
                lambda x2, t2: self._denoiser(model.denoise, x2, t2, cond_f2,
                                              cond_t2, x_bar2),
                float(guidance))
        else:
            def net_fn(x_t, t):
                return self._denoiser(model.denoise, x_t, t, cond_f, cond_t,
                                      x_bar)

        pred = self.config.model.prediction
        draws = dict(noise=noise, step_noise=step_noise, generator=generator,
                     device=self.device)
        if self.config.sample.sampler == "ddpm":
            if pred != "eps":
                raise ValueError("ddpm sampler supports eps-prediction only")
            return ddpm_sample(net_fn, self.schedule, shape, **draws)
        if cache_period > 1 and not use_cfg:
            return ddim_sample_blockcached(
                lambda x_t, t: model.denoise_fresh(x_t, t, cond_f, cond_t,
                                                   x_bar),
                lambda x_t, t, cache: model.denoise_cached(
                    x_t, t, cond_f, cond_t, cache, x_bar),
                self.schedule, shape, num_steps=steps,
                cache_period=cache_period, x_ref=x_bar,
                tables=self._decode_tables(steps, eta), prediction=pred,
                **draws)
        return ddim_sample(net_fn, self.schedule, shape, num_steps=steps,
                           x_ref=x_bar, tables=self._decode_tables(steps, eta),
                           prediction=pred, **draws)

    def _header_gamma(self, hdr: BitstreamHeader, steps: int, grid=True):
        """The blend dial a bitstream asks for: the v5 grid (a refined decode
        only, and only where ``grid``), else the header's scalar, else
        ``SampleConfig.blend_gamma``."""
        if grid and hdr.gamma_grid is not None and steps != 0:
            return hdr.gamma_grid_f
        return (hdr.gamma_or_none if hdr.gamma_or_none is not None
                else self.config.sample.blend_gamma)

    def _header_inv_gain(self, hdr: BitstreamHeader):
        """The inverse gain of the header's quality: the v4 ``quality_f``
        (interpolated) when set, else the ``quality_id`` row; None for a
        single-rate model."""
        if self._nq < 2:
            return None
        qf = hdr.quality_f_or_none
        return self.quality_gains(hdr.quality_id if qf is None else qf)[1]

    def _serving_decode(self, hdr: BitstreamHeader, steps: int, y_sym, means,
                        guidance, gamma, ph: int, pw: int, eta=None,
                        **draws) -> torch.Tensor:
        """One image's device stage as its header and the sample config ask;
        shared by ``decompress`` and ``decompress_many``."""
        sample = self.config.sample
        cache_period = sample.cache_period
        if (self._nq > 1 and hdr.quality_f_or_none is not None
                and cache_period > 1):
            # As in the JAX package, whose continuous-quality program has no
            # block-cached variant.
            warnings.warn(
                "continuous-quality (v4) decode uses the plain DDIM "
                "scan; sample.cache_period is ignored on this path",
                stacklevel=3)
            cache_period = 1
        return self._device_stage(
            y_sym, means, steps, sample.eta if eta is None else eta, gamma,
            ph, pw, inv_gain=self._header_inv_gain(hdr), guidance=guidance,
            cache_period=cache_period, **draws)

    # ---- public API ----

    @torch.inference_mode()
    def compress(self, img_u8: np.ndarray, quality_id: int = 0,
                 optimize_gamma=False, quality: float | None = None,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> bytes:
        """HWC uint8 image → bitstream.

        ``quality``: continuous variable-rate quality ∈ [0,
        num_qualities-1] (overrides ``quality_id``). Fractional values
        interpolate the trained gain ladder (``quality_gains``) and are
        carried in the v4 header; integral values give the bitstream of
        ``quality_id=int(quality)``.

        ``optimize_gamma``: encode-time search of the per-image serving
        dial. True sweeps γ ∈ {0, 0.25, 0.5, 0.75, 1}, a sequence sweeps
        its values, ``"spatial"`` also fits a per-tile γ grid. The encoder
        decodes the fresh bitstream at each candidate under the runtime's
        sample config, scores it against the original, and writes the
        winner into the header. Needs ``codec.synthesis``. ``noise`` /
        ``generator`` give the candidates' initial ε; by default it is what
        ``decompress`` draws by default, so a later served decode on the
        same kind of device reproduces the scored reconstruction.
        """
        with span("codec.compress"):
            q = self._resolve_quality(quality_id, quality)
            with span("codec.analysis"):
                padded, (h, w) = pad_image(img_u8)
                x = torch.from_numpy(to_model_range(padded))[None].to(
                    self.device)
                y, z_sym = self._analysis(x, q)
            z_sym = self._fetch(z_sym)
            _, _, y_streams = self._y_passes(z_sym, y=y)
            z_bytes = self.z_codec.encode(z_sym, self._z_rows(z_sym.shape))
            with span("codec.container"):
                blob = write_bitstream(self._make_header(h, w, q),
                                       [z_bytes] + y_streams)
            if optimize_gamma:
                blob = self._optimize_gamma(blob, img_u8, optimize_gamma,
                                            noise, generator)
            return blob

    def compress_to_bpp(self, img_u8: np.ndarray, target_bpp: float, *,
                        tol: float = 0.03, max_iters: int = 8,
                        optimize_gamma=False, probe: str = "encode"
                        ) -> tuple[bytes, float, float]:
        """Rate control: encode to an actual bits-per-pixel target
        (container bytes / original pixels) by bisecting the continuous
        quality dial. Returns (bitstream, quality, bpp).

        The endpoints are measured rather than assumed, so a reversed or
        flat gain ladder degrades to the closest endpoint; a target outside
        the reachable span clamps to the nearest endpoint (the returned bpp
        says what was achieved).

        ``probe="encode"``: every probe is a full encode. ``probe="estimate"``:
        the probes are ``estimate_bpp`` on the device (no host coding), then
        one encode at the chosen quality; the returned bpp is the real
        container's, so the estimate's bias only moves which quality the
        search settles on.
        """
        if self._nq < 2:
            raise ValueError("compress_to_bpp needs a variable-rate model "
                             "(codec.num_qualities > 1)")
        if probe not in ("encode", "estimate"):
            raise ValueError(f"unknown probe mode {probe!r}")
        npix = img_u8.shape[0] * img_u8.shape[1]

        def encode_at(q):
            blob = self.compress(img_u8, quality=q)
            return len(blob) * 8.0 / npix, blob

        with span("codec.compress_to_bpp"):
            if probe == "encode":
                q, bpp, blob = self._bisect_quality(encode_at, target_bpp,
                                                    tol, max_iters)
            else:
                # Bisect on the analytic rate; the padded image is uploaded
                # once for every probe, and the coder runs once, at the end.
                padded, (h, w) = pad_image(img_u8)
                x = torch.from_numpy(to_model_range(padded))[None].to(
                    self.device)
                q, _, _ = self._bisect_quality(
                    lambda q: (self._estimate_bpp_device(x, (h, w), q), None),
                    target_bpp, tol, max_iters)
                bpp, blob = encode_at(q)
            if optimize_gamma:
                blob = self._optimize_gamma(blob, img_u8, optimize_gamma)
            return blob, q, bpp

    def _bisect_quality(self, measure, target_bpp: float, tol: float,
                        max_iters: int):
        """(quality, bpp, payload) of the probe nearest ``target_bpp``:
        ``measure(q)`` gives (bpp, payload) at the endpoints, then at
        midpoints until one is within ``tol`` (relative) or ``max_iters``
        are spent. A target outside the endpoints' span gives the nearer
        endpoint."""
        lo = (0.0, *measure(0.0))
        hi = (float(self._nq - 1), *measure(float(self._nq - 1)))
        if hi[1] < lo[1]:       # descending ladder: swap so bpp rises with q
            lo, hi = hi, lo
        if target_bpp <= lo[1]:
            return lo
        if target_bpp >= hi[1]:
            return hi
        best = min((lo, hi), key=lambda r: abs(r[1] - target_bpp))
        lo_q, hi_q = lo[0], hi[0]
        for _ in range(max_iters):
            if abs(best[1] - target_bpp) / target_bpp <= tol:
                break
            mid_q = 0.5 * (lo_q + hi_q)
            mid = (mid_q, *measure(mid_q))
            if abs(mid[1] - target_bpp) < abs(best[1] - target_bpp):
                best = mid
            if mid[1] < target_bpp:
                lo_q = mid_q
            else:
                hi_q = mid_q
        return best

    def _container_overhead_bits(self, quality: float = 0) -> int:
        """The container's bits on top of the entropy payload: magic and
        version (5 B), the header (16 B in v3, 20 B in the v4 container a
        fractional quality needs), and per stream its framing (length and
        crc32, 8 B) and the rANS state flush (4 B)."""
        prefix = 25 if float(quality) != int(quality) else 21
        return (prefix + 12 * self._n_streams) * 8

    def estimate_bpp(self, img_u8: np.ndarray, quality: float = 0) -> float:
        """Analytic bits per original pixel: the entropy models' rate the
        coder would realise plus the container's fixed bits, without running
        the coder. What remains to the real container is rANS's escape
        coding (data-dependent, about 1 %)."""
        with span("codec.estimate_bpp"):
            padded, (h, w) = pad_image(img_u8)
            x = torch.from_numpy(to_model_range(padded))[None].to(self.device)
            return self._estimate_bpp_device(x, (h, w), quality)

    @torch.inference_mode()
    def _estimate_bpp_device(self, x: torch.Tensor, orig_hw, quality) -> float:
        """``estimate_bpp`` of a padded [1,H,W,3] image already on the
        device (the rate-control loop uploads it once)."""
        h, w = orig_hw
        if self._nq > 1:
            gain = torch.from_numpy(self.quality_gains(float(quality))[0])
        else:
            gain = torch.ones(self._latent_c)
        bpp_y, bpp_z = self.model.rate_estimate(x, gain.to(self.device))
        payload_bits = float(bpp_y + bpp_z) * x.shape[1] * x.shape[2]
        return (payload_bits
                + self._container_overhead_bits(quality)) / (h * w)

    def compress_many(self, imgs: Sequence[np.ndarray], quality_id: int = 0,
                      quality: float | None = None) -> list[bytes]:
        """Batch encode: ``compress`` on each image, in order.

        An encode without the γ search is a few milliseconds of device work
        between fetches that its own rANS coding waits for, so the images
        go one by one through the one encode path there is. ``optimize_gamma``
        is serial per image by construction: use ``compress``.
        """
        with span("codec.compress_many"):
            return [self.compress(im, quality_id, quality=quality)
                    for im in imgs]

    def decompress_many(self, blobs: Sequence[bytes],
                        noise: Optional[Sequence[torch.Tensor]] = None,
                        generator: Optional[torch.Generator] = None,
                        steps: int | None = None) -> list[np.ndarray]:
        """Software-pipelined batch decode: the pixels of ``decompress`` on
        each bitstream, given the same per-image noise.

        ``noise`` is a list with one initial ε per image ([1, H_pad, W_pad,
        3] each; the images may differ in size). Without it each image's ε is
        drawn from ``generator`` in image order (seed 0 on the runtime's
        device when None), so image 0 gets what a default ``decompress``
        draws and the later images the draws that follow. Steps, γ and the
        γ grid come from each image's own header; guidance is 1.

        For every entropy model the loop is the same, on one thread and one
        stream: image i's sampler is queued, its uint8 leaves through pinned
        memory without being waited for, and image i+1's symbol decode (host
        rANS and its entropy-parameter passes) runs while the card works on
        image i.
        """
        if not blobs:
            return []
        if steps == 0 and not self._synth:
            raise ValueError("steps=0 (mean decode) needs codec.synthesis")
        if noise is not None and len(noise) != len(blobs):
            raise ValueError(f"{len(noise)} noise tensors for {len(blobs)} "
                             f"bitstreams")
        with span("codec.decompress_many"):
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            out, pending = [], None
            current = self._decode_symbols(blobs[0])
            for i in range(len(blobs)):
                hdr, y_sym, means, (ph, pw) = current
                isteps = (hdr.steps or self.config.sample.steps
                          if steps is None else steps)
                # Queued, not waited for.
                fetch = self._fetch_later(self._serving_decode(
                    hdr, isteps, y_sym, means, 1.0,
                    self._header_gamma(hdr, isteps), ph, pw,
                    noise=None if noise is None else noise[i],
                    generator=generator))
                if pending is not None:
                    out.append(pending())
                pending = (lambda fetch=fetch, hdr=hdr:
                           fetch()[0][0][:hdr.height, :hdr.width])
                if i + 1 < len(blobs):
                    current = self._decode_symbols(blobs[i + 1])
            out.append(pending())
            return out

    def _optimize_gamma(self, blob: bytes, img_u8: np.ndarray, candidates,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> bytes:
        """Pick the serving γ by decoding ``blob`` at each candidate and
        rewrite the header with the PSNR argmax (include γ=0, the mean
        decode, and the search can only match or beat it).

        Every candidate is scored with the same initial ε: ``noise``, or one
        draw from ``generator``, or the draw ``decompress`` makes by default.

        ``candidates="spatial"``: also fit a per-tile γ grid in closed form
        (``_fit_gamma_grid``) from the γ=0 and γ=1 candidates, verify it by
        decoding the v5 candidate, and keep the grid only if it beats the
        scalar pick.
        """
        if not self._synth:
            raise ValueError("optimize_gamma needs codec.synthesis "
                             "(the blend dial is x̄-anchored)")
        spatial = isinstance(candidates, str) and candidates == "spatial"
        grid = (self._GAMMA_GRID if (candidates is True or spatial)
                else tuple(float(g) for g in candidates))
        if not grid:
            raise ValueError("optimize_gamma: empty candidate grid")
        with span("gamma.search"):
            if noise is None:
                if generator is None:
                    generator = torch.Generator(self.device).manual_seed(0)
                ph, pw = padded_hw(*img_u8.shape[:2])
                noise = torch.randn((1, ph, pw, 3), generator=generator,
                                    dtype=torch.float32, device=self.device)
            ref = img_u8.astype(np.float64)
            best_g, best_err = None, np.inf
            recs = {}
            for g in grid:
                with span("gamma.candidate"):
                    rec = self.decompress(blob, noise=noise, gamma=g)
                    if spatial and g in (0.0, 1.0):
                        recs[g] = rec
                    with span("gamma.score"):
                        err = _mse(rec, ref)
                if err < best_err:
                    best_g, best_err = g, err
            if spatial:
                with span("gamma.grid_fit"):
                    grid_u8 = self._fit_gamma_grid(ref, recs[0.0], recs[1.0])
                with span("gamma.verify"):
                    cand = with_header_gamma_grid(blob, grid_u8, best_g)
                    rec = self.decompress(cand, noise=noise)
                    with span("gamma.score"):
                        err = _mse(rec, ref)
                if err < best_err:
                    return cand
            return with_header_gamma(blob, best_g)

    def _fit_gamma_grid(self, ref, mean_u8, refined_u8) -> np.ndarray:
        """Closed-form per-tile γ fit.

        The blend x̂(γ) = x̄ + γ·d is linear in γ, so a tile's MSE argmin is
        γ* = Σ d·r / Σ d·d (d = x_refined − x̄, r = x_orig − x̄), clamped to
        [0, 1]. Tiles span the padded canvas (decode upsamples the grid to
        the padded resolution), pixels go to the nearest grid node under
        half-pixel-center geometry, and nodes with no image pixels or a
        degenerate denominator fall back to γ=0.
        """
        h, w = ref.shape[:2]
        ph, pw = padded_hw(h, w)
        t = self.GAMMA_TILE
        gh, gw = -(-ph // t), -(-pw // t)
        d = refined_u8.astype(np.float64) - mean_u8.astype(np.float64)
        r = ref - mean_u8.astype(np.float64)
        iy = np.clip(np.round((np.arange(h) + 0.5) * gh / ph - 0.5),
                     0, gh - 1).astype(np.int64)
        ix = np.clip(np.round((np.arange(w) + 0.5) * gw / pw - 0.5),
                     0, gw - 1).astype(np.int64)
        node = (iy[:, None] * gw + ix[None, :]).ravel()
        num = np.bincount(node, weights=(d * r).sum(-1).ravel(),
                          minlength=gh * gw)
        den = np.bincount(node, weights=(d * d).sum(-1).ravel(),
                          minlength=gh * gw)
        gam = np.where(den > 1e-6, num / np.maximum(den, 1e-6), 0.0)
        gam = np.clip(gam, 0.0, 1.0).reshape(gh, gw)
        return np.round(gam * 255.0).astype(np.uint8)

    def decode_latent(self, blob: bytes):
        """Bitstream → (ŷ in the coding domain [device], header)."""
        with span("codec.decode_latent"):
            hdr, y_sym, means, _ = self._decode_symbols(blob)
            return y_sym.to(torch.float32) + means, hdr

    def decompress(self, blob: bytes, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   steps: int | None = None, eta: float | None = None,
                   gamma=None, guidance: float | None = None,
                   step_noise: Optional[Sequence[torch.Tensor]] = None
                   ) -> np.ndarray:
        """Bitstream → HWC uint8 reconstruction.

        ``noise`` is the sampler's initial ε, NHWC [1, H_pad, W_pad, 3], and
        ``step_noise`` the per-step z of DDPM (or DDIM with η > 0); what is
        not given is drawn from ``generator`` (seed 0 on the runtime's device
        when None). ``guidance`` resolves as: the argument, the header's,
        ``SampleConfig.guidance``; a value other than 1 runs batch-doubled
        classifier-free guidance. ``gamma`` resolves as: the explicit
        argument (scalar or a [gh, gw] grid), then the v5 header grid, then
        the header scalar, then ``SampleConfig.blend_gamma``. A variable-rate
        model applies the inverse gain of the header's quality.
        """
        with span("codec.decompress"):
            sample = self.config.sample
            hdr, y_sym, means, (ph, pw) = self._decode_symbols(blob)
            if steps is None:
                steps = hdr.steps or sample.steps
            if steps == 0 and not self._synth:
                raise ValueError("steps=0 (mean decode) needs "
                                 "codec.synthesis")
            if guidance is None:
                guidance = hdr.guidance or sample.guidance
            if gamma is None:
                gamma = self._header_gamma(hdr, steps)
            img = self._serving_decode(hdr, steps, y_sym, means, guidance,
                                       gamma, ph, pw, eta=eta, noise=noise,
                                       generator=generator,
                                       step_noise=step_noise)
            return self._fetch(img)[0][:hdr.height, :hdr.width]

    def decompress_tiled(self, blob: bytes,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         tile: int = 256, halo: int = 32, mesh=None,
                         steps: int | None = None) -> np.ndarray:
        """High-resolution tiled decode: ŷ is split into overlapping tiles
        (core ``tile``, ``halo`` on each side), all tiles go through one
        batched device stage, and the halos are blended on the host.

        ``noise`` is one [tiles, e, e, 3] tensor (e = tile + 2·halo), drawn in
        one piece from ``generator`` (seed 0 on the runtime's device) when
        None. Guidance is 1 and the blend dial is the header's scalar γ (a v5
        grid is laid out for the whole canvas and is not used here).

        With ``mesh`` every rank calls it: the tiles are padded with repeats
        of the last (and its ε) to a multiple of the data axis and decoded
        by ``sharded_sample``, as the JAX package's mesh branch does: the
        inverse gain first, the config's η and truncation, no block cache.
        """
        with span("codec.decompress_tiled"):
            sample = self.config.sample
            y_hat, hdr = self.decode_latent(blob)
            ph, pw = padded_hw(hdr.height, hdr.width)
            if steps is None:
                steps = hdr.steps or sample.steps
            if steps == 0 and not self._synth:
                raise ValueError("steps=0 (mean decode) needs codec.synthesis")
            divisor = self.config.model.grid_divisor
            extent = tile + 2 * halo
            if extent % divisor:
                raise ValueError(
                    f"tile+2*halo={extent} must be divisible by {divisor} "
                    f"for the refiner's down and up path (the UNet's "
                    f"patch_size * 2^(levels-1), the DiT's space_to_depth * "
                    f"patch)")
            plan = make_tile_plan(ph, pw, tile=tile, halo=halo)
            y_np = self._fetch(y_hat)
            with span("codec.tile_split"):
                y_tiles = torch.from_numpy(
                    split_tiles(y_np, plan, scale=16)).to(self.device)
            gamma = self._header_gamma(hdr, steps, grid=False)
            if mesh is not None:
                with span("codec.device_stage"):
                    x_tiles = self._sharded_tiles(
                        y_tiles, hdr, steps, gamma, extent, mesh, noise,
                        generator)
                x_tiles = self._fetch(x_tiles)
            else:
                # The continuous-quality path has no block-cached variant (as
                # in the JAX package).
                cache_period = (1 if hdr.quality_f_or_none is not None
                                else sample.cache_period)
                x_tiles = self._fetch(self._device_stage(
                    y_tiles, torch.zeros((), device=self.device), steps,
                    sample.eta, gamma, extent, extent, noise=noise,
                    generator=generator, inv_gain=self._header_inv_gain(hdr),
                    cache_period=cache_period))
            with span("codec.tile_blend"):
                # Blend the halos in float, then back to uint8.
                blended = blend_tiles(x_tiles.astype(np.float32), plan)
                out = np.clip(blended + 0.5, 0, 255).astype(np.uint8)
            return out[:hdr.height, :hdr.width]

    @torch.inference_mode()
    def _sharded_tiles(self, y_tiles: torch.Tensor, hdr: BitstreamHeader,
                       steps: int, gamma, extent: int, mesh,
                       noise: Optional[torch.Tensor],
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """The mesh branch of ``decompress_tiled``: uint8 [n, e, e, 3] on
        every rank."""
        inv_gain = self._header_inv_gain(hdr)
        if inv_gain is not None:
            # The sharded chain conditions on the tiles as given.
            y_tiles = self.model.inv_gain(
                y_tiles, torch.from_numpy(inv_gain).to(self.device))
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        n = y_tiles.shape[0]
        if noise is None:
            noise = torch.randn((n, extent, extent, 3), generator=generator,
                                dtype=torch.float32, device=self.device)
        noise = noise.to(self.device, torch.float32)
        pad = (-n) % axis_size(mesh, DATA_AXIS)
        if pad:
            y_tiles = torch.cat([y_tiles, y_tiles[-1:].expand(
                pad, *y_tiles.shape[1:])])
            noise = torch.cat([noise, noise[-1:].expand(
                pad, *noise.shape[1:])])
        model = self.model
        cond = {}

        def model_apply(m, y_shard, x_t, t, x_bar=None):
            # The conditioning of a shard is the same at every step: it is
            # computed once, as XLA hoists it out of the JAX package's scan.
            if cond.get("y") is not y_shard:
                cond.update(y=y_shard, signal=m.cond_signal(y_shard))
            cond_f, cond_t = cond["signal"]
            return m.denoise(x_t, t, cond_f, cond_t, x_bar)

        x_ref_fn = None
        if self._synth:
            x_ref_fn = lambda m, y_shard: m.synthesize(y_shard)
        x0 = sharded_sample(
            model_apply, model, self.schedule, mesh, y_tiles, noise,
            (extent, extent), num_steps=steps, eta=self.config.sample.eta,
            x_ref_fn=x_ref_fn, t_start=self._t_start(), blend_gamma=gamma,
            prediction=self.config.model.prediction, generator=generator)
        return _to_uint8(x0[:n])
