"""tpucdc_torch ops against the JAX package: GN, GN+SiLU and attention.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs the Pallas kernels' references (``_gn_reference``,
``attention_reference``), as tests/kernels/test_pallas_parity.py does. The
plain mirrors of the CUDA kernels' arithmetic (``attention_tiled_reference``,
``gn_chunked_reference``) are held against the same JAX references.
Tolerances: f32 atol 1e-5 (attention 2e-5), bf16 5e-2 — the Pallas parity
bar. The kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucdc.ops.attention import attention_reference as jax_attention
from tpucdc.ops.groupnorm import _gn_reference as jax_gn

from tpucdc_torch.ops import attention, group_norm, group_norm_silu
from tpucdc_torch.ops import _kernels
from tpucdc_torch.ops.attention import (attention_reference,
                                        attention_tiled_reference)
from tpucdc_torch.ops.groupnorm import gn_chunked_reference, gn_reference

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}

# The Pallas parity shapes, then the (C, G) pairs of the flagship decode:
# UNet GN+SiLU (groups 16) and the conditioning head (target 32 groups).
GN_CASES = [((2, 8, 8, 32), 8), ((1, 16, 16, 64), 16), ((3, 7, 5, 16), 4)] + [
    ((1, 6, 4, c), g) for c, g in
    [(32, 16), (64, 16), (96, 16), (128, 16), (160, 16), (192, 16),
     (96, 32), (48, 24), (32, 32)]]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    gamma = rng.standard_normal(shape[-1]).astype(np.float32)
    beta = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, gamma, beta


def _same_dtype_pair(x, jdt, tdt):
    """One input rounded to the test dtype, as JAX and torch arrays."""
    xj = jnp.asarray(x).astype(jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fuse_silu", [True, False])
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_matches_jax(shape, groups, fuse_silu, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    x, gamma, beta = _inputs(shape, seed=groups + shape[-1])
    xj, xt = _same_dtype_pair(x, jdt, tdt)
    want = jax_gn(xj, jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-5,
                  fuse_silu)
    fn = group_norm_silu if fuse_silu else group_norm
    got = fn(xt, torch.from_numpy(gamma), torch.from_numpy(beta), groups)
    assert got.dtype == tdt and got.shape == xt.shape
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=atol)


# Pallas parity shapes, then the decode's d=24 heads with Nq != Nk.
ATTN_CASES = [(2, 2, 256, 256, 64), (2, 2, 512, 128, 32),
              (2, 2, 256, 384, 128), (1, 4, 100, 77, 24),
              (1, 4, 96, 160, 24)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,nq,nk,d", ATTN_CASES)
def test_attention_matches_jax(b, h, nq, nk, d, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    atol = 2e-5 if dtype == "f32" else atol
    rng = np.random.default_rng(nq + nk + d)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(b, h, nq, d), (b, h, nk, d), (b, h, nk, d)])
    (qj, qt), (kj, kt), (vj, vt) = (_same_dtype_pair(a, jdt, tdt)
                                    for a in (q, k, v))
    want = jax_attention(qj, kj, vj)
    got = attention(qt, kt, vt)
    assert got.dtype == tdt and got.shape == qt.shape
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=atol)


def test_cpu_wrappers_launch_no_kernel():
    _kernels.reset_launches()
    x = torch.randn(1, 4, 4, 32)
    group_norm_silu(x, torch.ones(32), torch.zeros(32), 16)
    q = torch.randn(1, 2, 8, 16)
    attention(q, q, q)
    assert _kernels.LAUNCHES == {"gn_silu": 0, "attention": 0}


def _head_views(arrays, h, d, jdt, tdt):
    """[B, N, H·d] projections as JAX [B, H, N, d] arrays and as the torch
    head views the attention block passes (no copy)."""
    jax_side, torch_side = [], []
    for a in arrays:
        b, n, _ = a.shape
        aj, at = _same_dtype_pair(a, jdt, tdt)
        jax_side.append(aj.reshape(b, n, h, d).transpose(0, 2, 1, 3))
        torch_side.append(at.reshape(b, n, h, d).transpose(1, 2))
    return jax_side, torch_side


# Self-attention (Nq == Nk) and cross-attention shapes, the ragged one too.
VIEW_CASES = [(1, 4, 96, 96, 24), (1, 4, 100, 77, 24), (2, 2, 64, 160, 32)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,nq,nk,d", VIEW_CASES)
def test_attention_on_head_views(b, h, nq, nk, d, dtype):
    """The strided head views give the contiguous call's result bit for bit,
    match JAX, and the result reshapes to [B, N, H·d] without a copy."""
    jdt, tdt, atol = DTYPES[dtype]
    atol = 2e-5 if dtype == "f32" else atol
    rng = np.random.default_rng(nq + nk + d)
    arrays = [rng.standard_normal((b, n, h * d)).astype(np.float32)
              for n in (nq, nk, nk)]
    (qj, kj, vj), (qt, kt, vt) = _head_views(arrays, h, d, jdt, tdt)
    assert not qt.is_contiguous()
    want = np.asarray(jax_attention(qj, kj, vj), np.float32)
    for fn in (attention, attention_reference):
        got = fn(qt, kt, vt)
        same = fn(qt.contiguous(), kt.contiguous(), vt.contiguous())
        assert torch.equal(got, same)
        assert got.dtype == tdt and got.shape == qt.shape
        merged = got.transpose(1, 2).reshape(b, nq, h * d)
        assert merged.data_ptr() == got.data_ptr()
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                                   atol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tile,splits", [(64, 4), (32, 2), (16, 1), (128, 1)])
@pytest.mark.parametrize("b,h,nq,nk,d", [(1, 4, 100, 77, 24),
                                         (1, 2, 40, 300, 24),
                                         (2, 2, 33, 65, 64),
                                         (1, 2, 17, 1, 8),
                                         (1, 2, 200, 300, 72)])
def test_attention_tiled_mirror_matches_jax(b, h, nq, nk, d, tile, splits,
                                            dtype):
    """The kernel's arithmetic (key tiles, running max, P rounded against
    the running max, key splits merged at the end, ragged last tile) in plain
    PyTorch: f32 atol 2e-5; bf16 2e-2·max|reference|, the kernel's bound.
    (64, 4) is the d <= 64 design's tile and split, (128, 1) the d > 64
    design's, whose shape here is the DiT's head width with ragged rows and
    keys."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(nq + nk + d + tile)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(b, h, nq, d), (b, h, nk, d), (b, h, nk, d)])
    (qj, qt), (kj, kt), (vj, vt) = (_same_dtype_pair(a, jdt, tdt)
                                    for a in (q, k, v))
    want = np.asarray(jax_attention(qj, kj, vj), np.float32)
    got = attention_tiled_reference(qt, kt, vt, tile=tile, splits=splits)
    assert got.dtype == tdt and got.shape == qt.shape
    atol = 2e-5 if dtype == "f32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, atol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunks", [1, 3, 7])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8),
                                          ((3, 7, 5, 16), 4),
                                          ((2, 9, 5, 20), 4),
                                          ((1, 6, 4, 96), 16)])
def test_gn_chunked_mirror_matches_jax(shape, groups, chunks, dtype):
    """The kernel's statistics (per-chunk partials folded and merged by its
    rule) in plain PyTorch against the JAX reference."""
    jdt, tdt, atol = DTYPES[dtype]
    x, gamma, beta = _inputs(shape, seed=groups + shape[-1] + chunks)
    xj, xt = _same_dtype_pair(x, jdt, tdt)
    want = jax_gn(xj, jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-5,
                  True)
    got = gn_chunked_reference(xt, torch.from_numpy(gamma),
                               torch.from_numpy(beta), groups, 1e-5, chunks)
    assert got.dtype == tdt and got.shape == xt.shape
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("shape,groups,chunks", [((1, 16, 16, 64), 16, 5),
                                                 ((2, 9, 5, 20), 4, 3)])
def test_gn_chunked_mirror_large_mean(shape, groups, chunks):
    """Mean 1000, sigma 1 in f32: merging (count, mean, M2) keeps the
    variance that E[x²] − mean² would lose. Normalised output to 1e-3."""
    rng = np.random.default_rng(7)
    x = (1000.0 + rng.standard_normal(shape)).astype(np.float32)
    gamma = np.ones(shape[-1], np.float32)
    beta = np.zeros(shape[-1], np.float32)
    normed = np.asarray(jax_gn(jnp.asarray(x), jnp.asarray(gamma),
                               jnp.asarray(beta), groups, 1e-5, False))
    assert np.abs(normed).max() > 2.0   # JAX's two-pass variance survived
    xt, gt, bt = (torch.from_numpy(a) for a in (x, gamma, beta))
    got = gn_chunked_reference(xt, gt, bt, groups, 1e-5, chunks).numpy()
    np.testing.assert_allclose(got, normed / (1.0 + np.exp(-normed)),
                               atol=1e-3)
    plain = gn_reference(xt, gt, bt, groups, 1e-5, fuse_silu=True).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-3)
