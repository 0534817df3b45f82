# Frozen copy of the port's codec/cdf_utils.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Quantized CDF table construction (copy of tpucdc/codec/cdf_utils.py).

THE FROZEN TABLE SPEC shared between the JAX likelihood path and the C++ rANS
coder (the port/entropy/cpp/rans.cc). A table is a set of rows; row ``r`` codes
symbols for elements whose index array says ``indexes[i] == r``:

  * ``cdfs``      int32 [R, Lmax+2]; row r uses entries 0..cdf_lengths[r]-1.
                  cdf[0] == 0, cdf[len-1] == 2^precision, strictly increasing.
  * ``cdf_lengths`` int32 [R]: number of valid cdf entries (== S_r + 2 where
                  S_r is the in-range symbol count including the escape slot).
  * ``offsets``   int32 [R]: value of the first in-range symbol; the coded
                  symbol for raw value v is ``v - offsets[r]``.

The LAST in-range symbol of every row is the ESCAPE symbol: out-of-range
values are coded as escape + Exp-Golomb-style bypass bits (see rans.cc).
Precision is 16 bits.
"""

from __future__ import annotations

import numpy as np

PRECISION = 16
TOTAL = 1 << PRECISION


def pmf_to_quantized_cdf(pmf: np.ndarray, tail_mass: float) -> np.ndarray:
    """Quantize a pmf (plus an appended escape/tail slot) to an integer CDF.

    Returns int32 [len(pmf)+2]: [0, c_1, ..., c_{L+1}=TOTAL] with every step
    >= 1 (no zero-frequency symbols — the coder requires f > 0).
    """
    pmf = np.asarray(pmf, dtype=np.float64)
    p = np.concatenate([np.maximum(pmf, 0.0), [max(tail_mass, 1e-12)]])
    p = p / p.sum()
    cdf = np.zeros(len(p) + 1, dtype=np.int64)
    cdf[1:] = np.round(np.cumsum(p) * TOTAL).astype(np.int64)
    cdf[-1] = TOTAL

    # Repair zero-width symbols by stealing from the widest step.
    freqs = np.diff(cdf)
    for i in np.where(freqs < 1)[0]:
        need = 1 - freqs[i]
        donor = int(np.argmax(freqs))
        if freqs[donor] <= need:
            raise ValueError("cannot repair quantized cdf: pmf too degenerate")
        freqs[donor] -= need
        freqs[i] += need
    cdf[1:] = np.cumsum(freqs)
    assert cdf[-1] == TOTAL and np.all(np.diff(cdf) >= 1)
    return cdf.astype(np.int32)


def pack_cdf_rows(rows: list[np.ndarray]):
    """Pack variable-length cdf rows into (cdfs, cdf_lengths) dense arrays."""
    lengths = np.array([len(r) for r in rows], dtype=np.int32)
    out = np.zeros((len(rows), int(lengths.max())), dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, lengths
