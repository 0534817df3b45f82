"""The DiT refiner on the card (``cuda``; every test skips without one).

* The attention kernel at the served DiT's shape, (1, 16, 6144, 72) read in
  place from one qkv projection as the block does, against the plain
  version, in f32 and bf16.
* A served decode of ``dit_xl2_serving()`` at 768×512 (the flagship's codec
  and head, the DiT drawn): graphed bit-equal to eager over three ε, with
  equal launch counts, one graph replay a DDIM step, no capture after the
  first decode, and 3 GN+SiLU (the conditioning head) and 140 attention
  launches (28 blocks × 5 steps) a decode.

On a machine with a card (JAX need not be there, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_dit_cuda.py -q
"""

import pathlib

import numpy as np
import pytest
import torch

from tests.test_torch_graphed_denoise import (_calls, _graphed_and_eager,
                                              _same)
from tpucdc_torch import api, presets
from tpucdc_torch.ops import _kernels
from tpucdc_torch.ops.attention import attention, attention_reference
from tpucdc_torch.pipelines import CodecRuntime
from tpucdc_torch.runtime import BF16_POLICY

ROOT = pathlib.Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_attention_at_the_dit_shape(card, dtype, rel):
    gen = torch.Generator(card).manual_seed(72)
    b, n, heads, d = 1, 6144, 16, 72
    qkv = torch.randn((b, n, 3, heads, d), generator=gen,
                      device=card).to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = _kernels.LAUNCHES["attention"]
    got = attention(q, k, v)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["attention"] == before + 1
    want = attention_reference(q, k, v)
    assert got.shape == (b, heads, n, d) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rel * want.float().abs().max().item())


@pytest.fixture(scope="module")
def dit_runtime(card):
    cfg = presets.dit_xl2_serving()
    model = api.load_model(cfg, str(ROOT / "artifacts" /
                                    "flagship_params.npz"))
    return CodecRuntime(cfg, model, device=card, policy=BF16_POLICY)


def test_graphed_dit_decode_is_the_eager_one(card, dit_runtime):
    rt = dit_runtime
    img = np.load(ROOT / "tpucdc_torch" / "fixtures" /
                  "image_768x512.npz")["image_u8"]
    blob = rt.compress(img)
    shape = (1, 512, 768, 3)
    for k in range(3):
        eps = torch.randn(shape, generator=torch.Generator(card).manual_seed(
            k), device=card)
        records, got, want = _graphed_and_eager(
            rt, lambda: rt.decompress(blob, noise=eps))
        _same(got, want)
        assert _calls(records, "ddim.step") == _calls(
            records, "unet.replay") == 5
        if k:
            # The eager forwards (the capture's warm-up and the captured
            # one) open the blocks' spans; a replay opens none.
            assert _calls(records, "unet.capture") == 0
            assert _calls(records, "dit.block") == 0
    _kernels.reset_launches()
    rt.decompress(blob)
    assert _kernels.LAUNCHES == {"gn_silu": 3, "attention": 140, "adaln": 425}
