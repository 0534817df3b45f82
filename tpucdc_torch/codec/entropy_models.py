"""Decode-side entropy models: FactorizedPrior tables and GaussianConditional.

Mirrors the coding half of tpucdc/codec/entropy_models.py: the z medians and
quantized z CDF tables of the learned factorized prior, and the Gaussian
conditional's scale table, row indexes and CDF tables. The likelihoods and
the aux loss belong to training and are not ported yet.

The tables must match the JAX package's bit for bit, or rANS desyncs. The
Gaussian tables are scipy-only, so they match by construction; the z tables
evaluate the density MLP in f32 on the CPU, operation for operation as the
JAX package does, and tests/test_torch_entropy.py holds both to the JAX
package's tables entry for entry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from tpucdc_torch.codec.cdf_utils import pack_cdf_rows, pmf_to_quantized_cdf
from tpucdc_torch.codec.transforms import softplus


class FactorizedPrior(nn.Module):
    """Learned factorized prior over the hyper-latent z's channels.

    The channel CDF c(x) = sigmoid(f_K(...f_1(x))) with
    f_k(x) = g_k(softplus(H_k) x + b_k), g_k(x) = x + tanh(a_k)⊙tanh(x).
    """

    def __init__(self, channels: int, filters: tuple[int, ...] = (3, 3, 3),
                 tail_mass: float = 1e-9):
        super().__init__()
        self.channels = channels
        self.tail_mass = tail_mass
        dims = (1,) + tuple(filters) + (1,)
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

    def medians(self) -> torch.Tensor:
        return self.quantiles.detach()[:, 0, 1]

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

    Coding: σ snapped UP to the nearest scale-table entry; one CDF row per
    table scale.
    """
    scale_table: np.ndarray = dataclasses.field(
        default_factory=default_scale_table)
    tail_mass: float = 1e-9

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
