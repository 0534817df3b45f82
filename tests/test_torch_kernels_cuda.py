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
    ((2, 8, 8, 32), 8), ((3, 7, 5, 16), 4)]

# The decode's heads (self and cross are both 1536×1536, d=24), then ragged
# and wide-head shapes.
ATTN_CASES = [(1, 4, 1536, 1536, 24), (1, 4, 100, 77, 24),
              (2, 2, 256, 384, 128), (1, 2, 33, 65, 64), (1, 1, 5, 3, 7)]


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
