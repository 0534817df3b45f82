"""The reference codec: what the port's ``CodecRuntime`` computes, worked out
again in plain PyTorch and numpy from the image, the weights file and the
initial ε, in float32 with TF32 off.

rANS is lossless, so the symbols a decoder reads back are the ones the
encoder quantized: the reference takes ŷ = round(y − μ) + μ pass by pass.
With its own coder tables and the pure-Python coder it writes the
bitstreams that the decode cells hand to the port (``write_blob``), and
reads the ones that the port's encoder wrote, to judge them
(``read_blob``).

Under ``fp8_products()`` (``ops.layers``) the products that the port's
policy runs in bf16 round their operands to float8: the lower-precision
control.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from cdcbench.reference.codec.context_model import checkerboard_mask
from cdcbench.reference.codec.entropy_models import GaussianConditional
from cdcbench.reference.config import Config
from cdcbench.reference.entropy import rans_py
from cdcbench.reference.entropy.bitstream import (BitstreamHeader,
                                                  read_bitstream,
                                                  write_bitstream)
from cdcbench.reference.model import CDCModel
from cdcbench.reference.ops.schedules import make_schedule
from cdcbench.reference.runtime import BF16_POLICY, F32_POLICY, set_policy
from cdcbench.reference.sampling.ddim import ddim_sample, ddim_step_tables
from cdcbench.reference.utils.weights import load_params_npz

PAD_MULTIPLE = 64
GAMMA_GRID = (0.0, 0.25, 0.5, 0.75, 1.0)
GAMMA_TILE = 128
_STREAMS = {"hyperprior": 1, "checkerboard": 2}


def from_dict(cls, values: dict):
    """A config dataclass from a nested dict; nested configs and tuples are
    rebuilt from the fields' defaults."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        default = (f.default if f.default is not dataclasses.MISSING
                   else None)
        if dataclasses.is_dataclass(default):
            v = from_dict(type(default), v)
        elif isinstance(default, tuple) or isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def build_config(values: dict) -> Config:
    return from_dict(Config, values).validated()


def pad_image(img: np.ndarray):
    h, w = img.shape[:2]
    return np.pad(img, ((0, (-h) % PAD_MULTIPLE), (0, (-w) % PAD_MULTIPLE),
                        (0, 0)), mode="reflect")


def to_uint8(x: torch.Tensor) -> np.ndarray:
    return torch.clamp((x + 1.0) * 127.5 + 0.5, 0, 255).to(
        torch.uint8).cpu().numpy()


def pin_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


class RefCodec:
    """The model of ``config`` carrying the weights of ``weights``, on
    ``device``, every product in f32."""

    def __init__(self, config: Config, weights, device):
        self.cfg = config
        self.device = torch.device(device)
        pin_f32()
        model = CDCModel(config.model)
        state, unused = load_params_npz(weights)
        if unused:
            raise ValueError(f"{weights}: {len(unused)} arrays map onto "
                             f"nothing")
        model.load_state_dict(state, strict=True)
        self.model = model.to(self.device).eval()
        self.set_control(False)
        cf = config.model.codec
        self.context, self.groups = cf.context, cf.context_groups
        self.nq, self.latent_c = cf.num_qualities, cf.latent_channels
        self.schedule = make_schedule(config.model.schedule.kind,
                                      config.model.schedule.num_steps)
        self.gaussian = GaussianConditional()
        self.medians = self.model.z_medians().detach().to(self.device)
        self._tables = None

    def set_control(self, on: bool) -> None:
        """f32 everywhere; or, for the control, the port's policy (bf16
        products, h_s and the context models in f32), which
        ``fp8_products()`` then takes down to fp8."""
        set_policy(self.model, BF16_POLICY if on else F32_POLICY)
        set_policy(self.model.h_s, F32_POLICY)
        if hasattr(self.model, "context"):
            set_policy(self.model.context, F32_POLICY)

    # ---- quality ----

    def gains(self, quality):
        """(gain, inv_gain) numpy [C] of a ladder index or continuous q."""
        if self.nq < 2:
            return None, None
        g = self.model.gains.detach().cpu().numpy()
        ig = self.model.inv_gains.detach().cpu().numpy()
        q = float(np.clip(quality, 0.0, self.nq - 1))
        lo = int(np.floor(q))
        f = q - lo
        if f == 0.0:
            return g[lo].astype(np.float32), ig[lo].astype(np.float32)

        def interp(rows):
            lg = np.log(np.maximum(np.abs(rows[lo]), 1e-9))
            hg = np.log(np.maximum(np.abs(rows[lo + 1]), 1e-9))
            return np.copysign(np.exp((1.0 - f) * lg + f * hg),
                               rows[lo]).astype(np.float32)
        return interp(g), interp(ig)

    # ---- encode: image → symbols, ŷ ----

    @torch.inference_mode()
    def analyse(self, img_u8: np.ndarray, quality=0, write=None):
        """(z symbols [1,h,w,C] int32, y symbols int32, ŷ f32), the last two
        on the device, in the gained domain; ``write(symbols, indexes)`` gets
        each y pass's coded symbols and row indexes."""
        x = torch.from_numpy(pad_image(img_u8).astype(np.float32) / 127.5
                             - 1.0)[None].to(self.device)
        y = self.model.g_a(x)
        gain = self.gains(quality)[0]
        if gain is not None:
            y = y * torch.from_numpy(gain).to(self.device)
        z = self.model.h_a(y)
        z_sym = torch.round(z - self.medians).to(torch.int32)
        y_sym, means = self.passes(z_sym, y=y, write=write)
        return z_sym, y_sym, y_sym.to(torch.float32) + means

    @torch.inference_mode()
    def passes(self, z_sym: torch.Tensor, y=None, read=None, write=None):
        """The Gaussian passes over y: (y symbols int32, μ). The encoder
        (``y``) rounds y against each pass's μ and hands the pass to
        ``write(symbols, indexes)``; a reader (``read(means, idx, mask)`` →
        symbols of the pass) decodes them. A pass's ŷ feeds the next pass's
        context as the port's ``_y_passes`` does. A masked pass codes
        ``sym[:, mask]``: position-major, channel-minor."""
        model = self.model
        z_hat = z_sym.to(torch.float32) + self.medians
        hy, wy = 4 * z_sym.shape[1], 4 * z_sym.shape[2]

        def code(y_part, means, scales, mask=None):
            idx = self.gaussian.build_indexes(scales).to(torch.uint8)
            if read is None:
                sym = torch.round(y_part - means).to(torch.int32)
                if write is not None:
                    write(sym if mask is None else sym[:, mask],
                          idx if mask is None else idx[:, mask])
                return sym
            return read(means, idx, mask)

        if self.context == "hyperprior":
            means, scales = model.hyper_decode(z_hat)
            return code(y, means, scales), means
        feats = model.hyper_features(z_hat)
        am = torch.from_numpy(checkerboard_mask(hy, wy, anchor=True)[..., 0]
                              > 0).to(self.device)
        amf = am[None, :, :, None].to(torch.float32)
        ami = am[None, :, :, None].to(torch.int32)

        def parity(y_part, anchor_fn, nonanchor_fn):
            m_a, s_a = anchor_fn()
            sym_a = code(y_part, m_a, s_a, am)
            y_anchor = (sym_a.to(torch.float32) + m_a) * amf
            m_na, s_na = nonanchor_fn(y_anchor)
            sym_na = code(y_part, m_na, s_na, ~am)
            return (sym_a * ami + sym_na * (1 - ami),
                    m_a * amf + m_na * (1 - amf))

        if self.context == "checkerboard":
            return parity(y, lambda: model.ctx_anchor_params(feats),
                          lambda ya: model.ctx_nonanchor_params(feats, ya))
        mg = self.latent_c // self.groups
        syms, means_all, dec = [], [], []
        for g in range(self.groups):
            y_prev = (torch.cat(dec, -1) if dec
                      else feats.new_zeros((1, hy, wy, 0)))
            y_g = None if y is None else y[..., g * mg:(g + 1) * mg]
            if self.context == "channel-ar":
                m_g, s_g = model.ctx_group_params(g, feats, y_prev)
                sym_g = code(y_g, m_g, s_g)
            else:
                sym_g, m_g = parity(
                    y_g, lambda: model.sc_anchor_params(g, feats, y_prev),
                    lambda ya: model.sc_nonanchor_params(g, feats, y_prev, ya))
            syms.append(sym_g)
            means_all.append(m_g)
            dec.append(sym_g.to(torch.float32) + m_g)
        return torch.cat(syms, -1), torch.cat(means_all, -1)

    # ---- decode: ŷ → uint8 ----

    def _t_start(self):
        frac = self.cfg.sample.truncate_frac
        T = self.cfg.model.schedule.num_steps
        if frac <= 0.0:
            return T - 1
        return max(1, int(round(frac * (T - 1))))

    @torch.inference_mode()
    def refine(self, y_hat: torch.Tensor, noise: torch.Tensor, quality=0,
               steps=None):
        """ŷ (coding domain) → (x̄, the chain's x₀), both f32 NHWC."""
        inv = self.gains(quality)[1]
        if inv is not None:
            y_hat = y_hat * torch.from_numpy(inv).to(self.device)
        model = self.model
        cond_f, cond_t = model.cond_signal(y_hat)
        x_bar = model.synthesize(y_hat)
        steps = self.cfg.sample.steps if steps is None else steps
        if steps == 0:
            return x_bar, x_bar
        x0 = ddim_sample(
            lambda x_t, t: model.denoise(x_t, t, cond_f, cond_t, x_bar),
            self.schedule, tuple(noise.shape), num_steps=steps,
            noise=noise.to(self.device), device=self.device, x_ref=x_bar,
            tables=ddim_step_tables(self.schedule, steps,
                                    self.cfg.sample.eta, self._t_start()),
            prediction=self.cfg.model.prediction)
        return x_bar, x0

    def blend(self, x_bar, x0, gamma) -> np.ndarray:
        """The γ blend (scalar, or a [gh, gw] grid upsampled bilinearly) →
        uint8 [H_pad, W_pad, 3]."""
        ph, pw = x_bar.shape[1:3]
        if np.ndim(gamma) == 2:
            g = torch.as_tensor(np.asarray(gamma, np.float32),
                                device=self.device)
            g = F.interpolate(g[None, None], size=(ph, pw), mode="bilinear",
                              align_corners=False)[0, 0][None, :, :, None]
        else:
            g = float(np.float32(gamma))
        return to_uint8(x_bar + g * (x0 - x_bar))[0]

    def serve(self, y_hat, noise, quality, gamma, h, w) -> np.ndarray:
        """The served decode of ŷ: uint8 [h, w, 3]."""
        x_bar, x0 = self.refine(y_hat, noise, quality)
        return self.blend(x_bar, x0, gamma)[:h, :w]

    # ---- the γ search of an encode ----

    def gamma_search(self, img_u8, y_hat, noise, quality=0):
        """The spatial search: (scalar γ, uint8 grid or None). Five scalar
        candidates, then the closed-form grid kept only where its decode
        beats the best scalar, as the port's ``_optimize_gamma`` does."""
        h, w = img_u8.shape[:2]
        ref = img_u8.astype(np.float64)
        x_bar, x0 = self.refine(y_hat, noise, quality)
        recs, best_g, best_err = {}, None, np.inf
        for g in GAMMA_GRID:
            rec = self.blend(x_bar, x0, g)[:h, :w]
            recs[g] = rec
            err = float(np.mean((rec.astype(np.float64) - ref) ** 2))
            if err < best_err:
                best_g, best_err = g, err
        grid = fit_gamma_grid(ref, recs[0.0], recs[1.0])
        rec = self.blend(x_bar, x0, grid.astype(np.float32) / 255.0)[:h, :w]
        if float(np.mean((rec.astype(np.float64) - ref) ** 2)) < best_err:
            return best_g, grid
        return best_g, None

    # ---- reading a bitstream the port wrote ----

    def tables(self):
        if self._tables is None:
            self._tables = (self.model.factorized_tables(),
                            self.gaussian.cdf_tables())
        return self._tables

    def write_blob(self, img_u8: np.ndarray, quality=None):
        """The bitstream of ``img_u8`` (at a ladder row or a continuous
        quality), written with the reference's tables and the pure-Python
        coder in the port's container, and its ŷ (on the host)."""
        zt, yt = self.tables()
        streams = []

        def write(sym, idx):
            streams.append(rans_py.encode_fast(
                sym.cpu().numpy(), idx.cpu().numpy(), yt["cdfs"],
                yt["cdf_lengths"], yt["offsets"]))
        q = 0 if quality is None else float(quality)
        z_sym, _, y_hat = self.analyse(img_u8, q, write=write)
        z = z_sym.cpu().numpy()
        rows = np.broadcast_to(np.arange(z.shape[-1]), z.shape)
        z_bytes = rans_py.encode_fast(z, rows, zt["cdfs"], zt["cdf_lengths"],
                                      zt["offsets"])
        h, w = img_u8.shape[:2]
        fractional = q != int(q)
        header = BitstreamHeader(
            height=h, width=w, quality_id=int(np.floor(q + 0.5)),
            steps=self.cfg.sample.steps, guidance=self.cfg.sample.guidance,
            quality_f=q if fractional else float("nan"))
        return write_bitstream(header, [z_bytes] + streams), y_hat.cpu()

    @torch.inference_mode()
    def read_blob(self, blob: bytes):
        """(header, z symbols, y symbols) of a bitstream, decoded with the
        reference's own tables and the pure-Python coder."""
        hdr, streams = read_bitstream(blob)
        want = 1 + _STREAMS.get(self.context, self.groups * (
            2 if self.context == "space-channel" else 1))
        if len(streams) != want:
            raise ValueError(f"{len(streams)} streams, want {want}")
        ph = hdr.height + (-hdr.height) % PAD_MULTIPLE
        pw = hdr.width + (-hdr.width) % PAD_MULTIPLE
        zt, yt = self.tables()
        shape = (1, ph // PAD_MULTIPLE, pw // PAD_MULTIPLE,
                 self.cfg.model.codec.hyper_channels)
        rows = np.broadcast_to(np.arange(shape[-1]), shape).ravel()
        z = rans_py.decode(streams[0], rows, zt["cdfs"], zt["cdf_lengths"],
                           zt["offsets"]).reshape(shape)
        z_sym = torch.from_numpy(z).to(self.device)
        src = iter(streams[1:])

        def read(means, idx, mask):
            idx = (idx if mask is None else idx[:, mask]).cpu().numpy()
            vals = rans_py.decode(next(src), idx.ravel(), yt["cdfs"],
                                  yt["cdf_lengths"], yt["offsets"])
            vals = torch.from_numpy(vals.reshape(idx.shape)).to(self.device)
            if mask is None:
                return vals.reshape(means.shape)
            sym = torch.zeros(means.shape, dtype=torch.int32,
                              device=self.device)
            sym[:, mask] = vals
            return sym
        y_sym, means = self.passes(z_sym, read=read)
        return hdr, z_sym, y_sym, y_sym.to(torch.float32) + means


def fit_gamma_grid(ref, mean_u8, refined_u8) -> np.ndarray:
    """Closed-form per-tile γ over the padded canvas (the port's
    ``_fit_gamma_grid``)."""
    h, w = ref.shape[:2]
    ph, pw = h + (-h) % PAD_MULTIPLE, w + (-w) % PAD_MULTIPLE
    gh, gw = -(-ph // GAMMA_TILE), -(-pw // GAMMA_TILE)
    d = refined_u8.astype(np.float64) - mean_u8.astype(np.float64)
    r = ref - mean_u8.astype(np.float64)
    iy = np.clip(np.round((np.arange(h) + 0.5) * gh / ph - 0.5),
                 0, gh - 1).astype(np.int64)
    ix = np.clip(np.round((np.arange(w) + 0.5) * gw / pw - 0.5),
                 0, gw - 1).astype(np.int64)
    node = (iy[:, None] * gw + ix[None, :]).ravel()
    num = np.bincount(node, weights=(d * r).sum(-1).ravel(), minlength=gh * gw)
    den = np.bincount(node, weights=(d * d).sum(-1).ravel(), minlength=gh * gw)
    gam = np.where(den > 1e-6, num / np.maximum(den, 1e-6), 0.0)
    return np.round(np.clip(gam, 0.0, 1.0).reshape(gh, gw) * 255.0).astype(
        np.uint8)
