"""tpucdc_torch's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. On a machine with a card (which need not have JAX,
hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py -q

Tolerances: f32 atol 1e-5 (attention 2e-5), GN+SiLU bf16 5e-2, the Pallas
parity bar of tests/kernels/test_pallas_parity.py. Attention in bf16 is held
to 2e-2·max|reference| (about 5 bf16 steps at the largest output): its outputs
are small (softmax over ~Nk/e keys), so a fixed 5e-2 would pass a kernel that
skipped a whole key tile.

Gradients: on the card each kernel is the forward of an autograd.Function
whose backward is PyTorch operations in f32 (the JAX package has no backward
kernel). Its outputs carry a ``grad_fn``, and its gradients agree with
autograd through the plain version in the 2-norm to 1e-5 of the plain
gradient's norm in f32, 2e-2 in bf16 (the plain attention rounds its
softmax to bf16 before P·V, the backward does not), at the shapes a
flagship-recipe training step gives them, on the attention block's head
views and at batch 1.
"""

import pytest
import torch

from tpucdc_torch.ops import _kernels
from tpucdc_torch.ops.attention import attention, attention_reference
from tpucdc_torch.ops.groupnorm import (KERNELS_PER_CALL, gn_reference,
                                        group_norm_silu)

pytestmark = pytest.mark.cuda

DTYPES = {"f32": (torch.float32, 1e-5), "bf16": (torch.bfloat16, 5e-2)}
ATTN_BF16_REL = 2e-2

# The flagship decode's GN+SiLU slabs at 768×512 ([B, H, W, C], groups),
# then the Pallas parity shapes, one of them odd.
GN_CASES = [((1, 128, 192, c), 16) for c in (32, 64, 96)] + [
    ((1, 64, 96, c), 16) for c in (32, 64, 96, 128, 160)] + [
    ((1, 32, 48, c), 16) for c in (64, 96, 160, 192)] + [
    ((1, 32, 48, 96), 32), ((1, 64, 96, 48), 24), ((1, 128, 192, 32), 32),
    ((2, 8, 8, 32), 8), ((3, 7, 5, 16), 4)] + [
    # Adversarial: C·itemsize not a multiple of 16 (the scalar path), batch
    # 3, a single row, more images than the card holds blocks, the widest C.
    ((2, 9, 5, 20), 4), ((3, 16, 24, 64), 16), ((1, 1, 1, 32), 16),
    ((2, 1, 1, 20), 4), ((600, 2, 2, 16), 4), ((1, 3, 5, 3072), 32),
    ((1, 5, 7, 2304), 32)]

# The decode's heads (self and cross are both 1536×1536, d=24), then ragged
# and wide-head shapes.
ATTN_CASES = [(1, 4, 1536, 1536, 24), (1, 4, 100, 77, 24),
              (2, 2, 256, 384, 128), (1, 2, 33, 65, 64), (1, 1, 5, 3, 7)] + [
    # Adversarial: one query, one key, one key past a tile, every padded
    # head width, a key count past one staged tile of every split.
    (1, 2, 1, 300, 24), (1, 2, 50, 1, 24), (2, 3, 40, 65, 24),
    (1, 2, 70, 130, 8), (1, 2, 70, 130, 40), (1, 2, 70, 130, 64),
    (1, 2, 70, 130, 128), (1, 1, 17, 1000, 16), (1, 2, 31, 257, 12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_gn_silu_kernel_matches_plain(cuda, shape, groups, dtype):
    tdt, atol = DTYPES[dtype]
    gen = torch.Generator(cuda).manual_seed(sum(shape) + groups)
    x = torch.randn(shape, generator=gen, device=cuda).to(tdt)
    gamma = torch.randn(shape[-1], generator=gen, device=cuda)
    beta = torch.randn(shape[-1], generator=gen, device=cuda)
    before = _kernels.LAUNCHES["gn_silu"]
    got = group_norm_silu(x, gamma, beta, groups)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["gn_silu"] == before + KERNELS_PER_CALL
    want = gn_reference(x, gamma, beta, groups, 1e-5, fuse_silu=True)
    assert got.dtype == tdt and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,nq,nk,d", ATTN_CASES)
def test_attention_kernel_matches_plain(cuda, b, h, nq, nk, d, dtype):
    tdt = DTYPES[dtype][0]
    gen = torch.Generator(cuda).manual_seed(nq + nk + d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(tdt)
               for s in [(b, h, nq, d), (b, h, nk, d), (b, h, nk, d)])
    before = _kernels.LAUNCHES["attention"]
    got = attention(q, k, v)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["attention"] == before + 1
    want = attention_reference(q, k, v)
    assert got.dtype == tdt and got.shape == q.shape
    atol = (2e-5 if dtype == "f32"
            else ATTN_BF16_REL * want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gn_silu_kernel_unaligned_pointer(cuda, dtype):
    """A slab that starts one element into its buffer: the scalar path."""
    tdt, atol = DTYPES[dtype]
    gen = torch.Generator(cuda).manual_seed(11)
    shape = (2, 6, 5, 32)
    n = 2 * 6 * 5 * 32
    flat = torch.randn(n + 1, generator=gen, device=cuda).to(tdt)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    gamma = torch.randn(32, generator=gen, device=cuda)
    beta = torch.randn(32, generator=gen, device=cuda)
    got = group_norm_silu(x, gamma, beta, 16)
    want = gn_reference(x, gamma, beta, 16, 1e-5, fuse_silu=True)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("shape,groups", [((1, 64, 96, 64), 16),
                                          ((2, 9, 5, 20), 4)])
def test_gn_silu_kernel_large_mean(cuda, shape, groups):
    """|mean| >> sigma: E[x^2] - mean^2 in f32 would lose the variance."""
    gen = torch.Generator(cuda).manual_seed(5)
    x = 1000.0 + torch.randn(shape, generator=gen, device=cuda)
    gamma = torch.ones(shape[-1], device=cuda)
    beta = torch.zeros(shape[-1], device=cuda)
    got = group_norm_silu(x, gamma, beta, groups)
    want = gn_reference(x.double(), gamma.double(), beta.double(), groups,
                        1e-5, fuse_silu=True)
    torch.testing.assert_close(got.double(), want, atol=1e-3, rtol=0)


def _attn_check(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    atol = (2e-5 if dtype == "f32"
            else ATTN_BF16_REL * want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nq,nk", [(1536, 1536), (100, 77)])
def test_attention_kernel_head_views(cuda, nq, nk, dtype):
    """q, k, v as the head views of [B, N, H*d] projections, read in place;
    the result reshapes to [B, N, H*d] without a copy."""
    tdt = DTYPES[dtype][0]
    b, h, d = 1, 4, 24
    gen = torch.Generator(cuda).manual_seed(nq + nk)
    qp, kp, vp = (torch.randn(b, n, h * d, generator=gen, device=cuda).to(tdt)
                  for n in (nq, nk, nk))
    q, k, v = (t.reshape(b, t.shape[1], h, d).transpose(1, 2)
               for t in (qp, kp, vp))
    assert not q.is_contiguous()
    got = attention(q, k, v)
    torch.cuda.synchronize()
    _attn_check(got, attention_reference(q, k, v), dtype)
    assert torch.equal(got, attention(q.contiguous(), k.contiguous(),
                                      v.contiguous()))
    merged = got.transpose(1, 2).reshape(b, nq, h * d)
    assert merged.data_ptr() == got.data_ptr()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_kernel_unaligned_strides(cuda, dtype):
    """Head slices that start off a 16-byte boundary: narrower loads."""
    tdt = DTYPES[dtype][0]
    gen = torch.Generator(cuda).manual_seed(3)
    wide = torch.randn(3, 1, 2, 90, 27, generator=gen, device=cuda).to(tdt)
    q, k, v = (wide[i][..., 3:27] for i in range(3))     # d = 24, pitch 27
    got = attention(q, k, v)
    torch.cuda.synchronize()
    _attn_check(got, attention_reference(q, k, v), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_kernel_large_scores(cuda, dtype):
    """Scores 50 times larger: the softmax must not overflow."""
    tdt = DTYPES[dtype][0]
    gen = torch.Generator(cuda).manual_seed(9)
    q, k, v = (torch.randn(1, 4, 200, 24, generator=gen, device=cuda).to(tdt)
               for _ in range(3))
    got = attention(q, k, v, scale=50.0 * 24 ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    want = attention_reference(q, k, v, scale=50.0 * 24 ** -0.5)
    if dtype == "f32":
        # 50x the scores carry 50x their rounding into the exponent.
        torch.testing.assert_close(got, want, atol=50 * 2e-5, rtol=0)
    else:
        _attn_check(got, want, dtype)


def test_kernels_raise_instead_of_falling_back(cuda):
    x = torch.randn(1, 4, 4, 32, device=cuda)
    ones, zeros = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    with pytest.raises(TypeError):
        group_norm_silu(x.half(), ones, zeros, 16)
    with pytest.raises(ValueError):
        group_norm_silu(x.transpose(1, 2), ones, zeros, 16)
    q = torch.randn(1, 2, 8, 160, device=cuda)
    with pytest.raises(ValueError):
        attention(q, q, q)
    q = torch.randn(1, 2, 8, 48, device=cuda)[..., ::2]   # last stride 2
    with pytest.raises(ValueError):
        attention(q, q, q)


GRAD_TOL = {"f32": 1e-5, "bf16": 2e-2}
# A flagship-recipe step (batch 16, crop 192): the UNet's level-0 and level-2
# slabs, a conditioning-head slab; then batch 1 and an odd slab.
GRAD_GN_CASES = [((16, 48, 48, 32), 16), ((16, 12, 12, 96), 16),
                 ((16, 24, 24, 48), 24), ((1, 48, 48, 64), 16),
                 ((3, 7, 5, 20), 4)]
# (B, H, Nq, Nk, d): level-2 self- and cross-attention of the recipe (144
# tokens, 144 conditioning tokens), batch 1, a ragged pair.
GRAD_ATTN_CASES = [(16, 4, 144, 144, 24), (1, 4, 144, 144, 24),
                   (2, 2, 100, 77, 24)]


def _rel(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,groups", GRAD_GN_CASES)
def test_gn_silu_gradients_match_plain(cuda, shape, groups, dtype):
    dt = DTYPES[dtype][0]
    gen = torch.Generator(cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda).to(dt)
    x.requires_grad_(True)
    g = torch.randn(shape[-1], generator=gen, device=cuda).requires_grad_(True)
    b = torch.randn(shape[-1], generator=gen, device=cuda).requires_grad_(True)
    before = _kernels.LAUNCHES["gn_silu"]
    out = group_norm_silu(x, g, b, groups)
    assert out.grad_fn is not None
    assert _kernels.LAUNCHES["gn_silu"] == before + KERNELS_PER_CALL
    dout = torch.randn(shape, generator=gen, device=cuda).to(dt)
    got = torch.autograd.grad(out, (x, g, b), dout)
    want = torch.autograd.grad(gn_reference(x, g, b, groups, 1e-5, True),
                               (x, g, b), dout)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert _rel(a, w) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("views", [True, False], ids=["views", "contiguous"])
@pytest.mark.parametrize("b,h,nq,nk,d", GRAD_ATTN_CASES)
def test_attention_gradients_match_plain(cuda, b, h, nq, nk, d, views,
                                         dtype):
    dt = DTYPES[dtype][0]
    gen = torch.Generator(cuda).manual_seed(4)

    def make(n):
        if views:       # the [B, H, N, d] view of a [B, N, H·d] projection
            t = torch.randn((b, n, h * d), generator=gen, device=cuda).to(dt)
            return t.requires_grad_(True), t.reshape(b, n, h, d).transpose(1, 2)
        t = torch.randn((b, h, n, d), generator=gen, device=cuda).to(dt)
        return t.requires_grad_(True), t
    (q0, q), (k0, k), (v0, v) = make(nq), make(nk), make(nk)
    before = _kernels.LAUNCHES["attention"]
    out = attention(q, k, v)
    assert out.grad_fn is not None
    assert _kernels.LAUNCHES["attention"] == before + 1
    dout = torch.randn(out.shape, generator=gen, device=cuda).to(dt)
    got = torch.autograd.grad(out, (q0, k0, v0), dout)
    want = torch.autograd.grad(attention_reference(q, k, v), (q0, k0, v0),
                               dout)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert _rel(a, w) <= GRAD_TOL[dtype]
