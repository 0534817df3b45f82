"""tpucdc_torch ops against the JAX package: GN, GN+SiLU and attention.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs the Pallas kernels' references (``_gn_reference``,
``attention_reference``), as tests/kernels/test_pallas_parity.py does.
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
