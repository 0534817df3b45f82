# Frozen copy of the port's codec/entropy_models.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Entropy models: FactorizedPrior and GaussianConditional.

Mirrors tpucdc/codec/entropy_models.py. Both give (a) a differentiable
per-element likelihood, the rate term of training and of the analytic rate
estimate (bpp = −log₂ likelihood), with the factorized prior's aux loss that
trains its quantiles; and (b) the coding half: the z medians and quantized z
CDF tables of the learned factorized prior, and the Gaussian conditional's
scale table, row indexes and CDF tables.

The tables must match the JAX package's bit for bit, or rANS desyncs. The
Gaussian tables are scipy-only, so they match by construction; the z tables
evaluate the density MLP in f32 on the CPU, operation for operation as the
JAX package does, and tests/test_torch_entropy.py holds both to the JAX
package's tables entry for entry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from cdcbench.reference.codec.cdf_utils import pack_cdf_rows, pmf_to_quantized_cdf
from cdcbench.reference.codec.transforms import softplus

_LIKELIHOOD_FLOOR = 1e-9


def _std_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.special.erfc(-x * (2 ** -0.5))


def bits(likelihood: torch.Tensor) -> torch.Tensor:
    """Total bits implied by per-element likelihoods."""
    return torch.sum(-torch.log2(torch.clamp_min(likelihood,
                                                 _LIKELIHOOD_FLOOR)))


class FactorizedPrior(nn.Module):
    """Learned factorized prior over the hyper-latent z's channels.

    The channel CDF c(x) = sigmoid(f_K(...f_1(x))) with
    f_k(x) = g_k(softplus(H_k) x + b_k), g_k(x) = x + tanh(a_k)⊙tanh(x);
    the likelihood of an integer-quantized value is c(x+½) − c(x−½).
    """

    def __init__(self, channels: int, filters: tuple[int, ...] = (3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = 1e-9):
        super().__init__()
        self.channels = channels
        self.init_scale = init_scale
        self.tail_mass = tail_mass
        self.dims = dims = (1,) + tuple(filters) + (1,)
        self.num_layers = len(dims) - 1
        for i in range(self.num_layers):
            self.register_parameter(
                f"matrix{i}",
                nn.Parameter(torch.zeros(channels, dims[i + 1], dims[i])))
            self.register_parameter(
                f"bias{i}", nn.Parameter(torch.zeros(channels, dims[i + 1], 1)))
            if i < self.num_layers - 1:
                self.register_parameter(
                    f"factor{i}",
                    nn.Parameter(torch.zeros(channels, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.zeros(channels, 1, 3))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """The JAX package's initialisation: each matrix the constant
        log(expm1(1 / scale / width)), biases U(−½, ½) drawn from
        ``generator``, factors 0, quantiles (−init_scale, 0, init_scale)."""
        scale = self.init_scale ** (1.0 / self.num_layers)
        for i in range(self.num_layers):
            init_m = float(np.log(np.expm1(1.0 / scale / self.dims[i + 1])))
            getattr(self, f"matrix{i}").fill_(init_m)
            bias = getattr(self, f"bias{i}")
            bias.copy_(torch.rand(bias.shape, generator=generator) - 0.5)
            if i < self.num_layers - 1:
                getattr(self, f"factor{i}").zero_()
        self.quantiles.copy_(torch.tensor(
            [-self.init_scale, 0.0, self.init_scale]).expand_as(self.quantiles))

    def medians(self) -> torch.Tensor:
        return self.quantiles.detach()[:, 0, 1]

    def _logits_cdf(self, x: torch.Tensor, sg_density: bool = False
                    ) -> torch.Tensor:
        """x: [C, 1, N] → logits of the channel CDF, same shape.

        ``sg_density`` detaches the density parameters, so that the aux
        loss trains only the quantiles (the density trains via likelihood).
        """
        sg = (lambda v: v.detach()) if sg_density else (lambda v: v)
        h = x
        for i in range(self.num_layers):
            m = sg(getattr(self, f"matrix{i}"))
            h = torch.matmul(softplus(m), h) + sg(getattr(self, f"bias{i}"))
            if i < self.num_layers - 1:
                f = sg(getattr(self, f"factor{i}"))
                h = h + torch.tanh(f) * torch.tanh(h)
        return h

    def forward(self, z_tilde: torch.Tensor) -> torch.Tensor:
        """Per-element likelihood of the (noisy or rounded) z. z: [..., C]."""
        c = z_tilde.shape[-1]
        perm = torch.movedim(z_tilde.to(torch.float32), -1, 0)    # [C, ...]
        flat = perm.reshape(c, 1, -1)
        lower = self._logits_cdf(flat - 0.5)
        upper = self._logits_cdf(flat + 0.5)
        # Numerically stable difference of sigmoids.
        sign = -torch.sign(lower + upper).detach()
        lik = torch.abs(torch.sigmoid(sign * upper)
                        - torch.sigmoid(sign * lower))
        lik = torch.movedim(lik.reshape(perm.shape), 0, -1)       # [..., C]
        return torch.clamp_min(lik, _LIKELIHOOD_FLOOR)

    def aux_loss(self) -> torch.Tensor:
        """Drives the quantiles to the (tail, median, 1−tail) CDF points."""
        logits = self._logits_cdf(self.quantiles, sg_density=True)  # [C,1,3]
        t = float(np.log(2.0 / self.tail_mass - 1.0))
        target = torch.tensor([-t, 0.0, t], dtype=torch.float32,
                              device=logits.device)
        return torch.sum(torch.abs(logits - target))

    def _logits_cdf_single(self, ch: int, x: torch.Tensor) -> torch.Tensor:
        """x [1, 1, N] f32 → channel ``ch``'s CDF logits, same shape."""
        h = x
        for i in range(self.num_layers):
            m = getattr(self, f"matrix{i}").detach().cpu()[ch]
            b = getattr(self, f"bias{i}").detach().cpu()[ch]
            h = torch.matmul(softplus(m), h[0])[None] + b[None]
            if i < self.num_layers - 1:
                f = getattr(self, f"factor{i}").detach().cpu()[ch]
                h = h + torch.tanh(f[None]) * torch.tanh(h)
        return h

    @torch.no_grad()
    def cdf_tables(self, max_symbols: int = 64) -> dict:
        """Quantized CDF rows per channel for the rANS coder.

        Returns dict(cdfs [C, L], cdf_lengths [C], offsets [C]); symbols are
        round(z − median) − offset.
        """
        medians = self.medians().cpu().numpy()
        q = self.quantiles.detach().cpu().numpy()[:, 0, :]
        minima = np.maximum(np.ceil(medians - q[:, 0]).astype(np.int64), 1)
        maxima = np.maximum(np.ceil(q[:, 2] - medians).astype(np.int64), 1)
        minima = np.minimum(minima, max_symbols)
        maxima = np.minimum(maxima, max_symbols)

        rows, offsets = [], []
        for ch in range(self.channels):
            lo, hi = -int(minima[ch]), int(maxima[ch])
            grid = medians[ch] + np.arange(lo, hi + 1, dtype=np.float64)
            flat = torch.from_numpy(grid.astype(np.float32))[None, None, :]
            upper = torch.sigmoid(self._logits_cdf_single(ch, flat + 0.5))
            lower = torch.sigmoid(self._logits_cdf_single(ch, flat - 0.5))
            pmf = np.maximum((upper - lower).numpy()[0, 0], 0.0)
            rows.append(pmf_to_quantized_cdf(pmf, self.tail_mass))
            offsets.append(lo)
        cdfs, lengths = pack_cdf_rows(rows)
        return {"cdfs": cdfs, "cdf_lengths": lengths,
                "offsets": np.asarray(offsets, np.int32)}


def default_scale_table(scale_min: float = 0.11, scale_max: float = 256.0,
                        levels: int = 64) -> np.ndarray:
    return np.exp(np.linspace(np.log(scale_min), np.log(scale_max), levels))


@dataclasses.dataclass
class GaussianConditional:
    """N(μ, σ²) conditional entropy model over y (stateless).

    Training: the differentiable likelihood at the predicted (μ, σ).
    Coding: σ snapped UP to the nearest scale-table entry; one CDF row per
    table scale.
    """
    scale_table: np.ndarray = dataclasses.field(
        default_factory=default_scale_table)
    tail_mass: float = 1e-9

    def likelihood(self, y_tilde: torch.Tensor, means: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
        v = torch.abs(y_tilde.to(torch.float32) - means)
        s = torch.clamp_min(scales, float(self.scale_table[0]))
        upper = _std_normal_cdf((0.5 - v) / s)
        lower = _std_normal_cdf((-0.5 - v) / s)
        return torch.clamp_min(upper - lower, _LIKELIHOOD_FLOOR)

    def build_indexes(self, scales: torch.Tensor) -> torch.Tensor:
        """Row index per element: smallest table scale ≥ σ (clamped).

        searchsorted-left over the f32 table, as the JAX package does.
        """
        table32 = np.asarray(self.scale_table, np.float32)
        table = torch.from_numpy(table32).to(scales.device)
        s = torch.clamp(scales, float(table32[0]), float(table32[-1]))
        return torch.searchsorted(table, s.contiguous(), right=False)

    def cdf_tables(self) -> dict:
        """One quantized CDF row per table scale, symbols centered at 0."""
        # ndtr and ndtri are what scipy.stats.norm's cdf and ppf compute,
        # without the seconds that importing scipy.stats takes.
        from scipy.special import ndtr, ndtri
        rows, offsets = [], []
        tail_q = float(ndtri(1.0 - self.tail_mass / 2.0))
        for s in self.scale_table:
            half = max(int(np.ceil(s * tail_q)), 1)
            grid = np.arange(-half, half + 1, dtype=np.float64)
            pmf = ndtr((grid + 0.5) / s) - ndtr((grid - 0.5) / s)
            rows.append(pmf_to_quantized_cdf(pmf, self.tail_mass))
            offsets.append(-half)
        cdfs, lengths = pack_cdf_rows(rows)
        return {"cdfs": cdfs, "cdf_lengths": lengths,
                "offsets": np.asarray(offsets, np.int32)}
