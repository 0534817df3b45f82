"""The frozen reference against the port's plain CPU path, at the tiny
preset under F32 on both sides: the same symbols, the same bitstream read
back, the same served image."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cdcbench import core
from cdcbench.reference import codec_ref
from cdcbench.tests.helpers import tiny_config, tiny_weights


def _pair(context, tmp_path):
    from tpucdc_torch import config as port_config
    from tpucdc_torch.api import load_model
    from tpucdc_torch.pipelines.codec_runtime import CodecRuntime
    from tpucdc_torch.runtime import F32_POLICY
    conf = tiny_config(context)
    weights = tiny_weights(conf, tmp_path / "w.npz")
    cfg = codec_ref.from_dict(port_config.Config, conf).validated()
    rt = CodecRuntime(cfg, load_model(cfg, str(weights)), device="cpu",
                      policy=F32_POLICY)
    ref = codec_ref.RefCodec(codec_ref.build_config(conf), weights, "cpu")
    return rt, ref, conf


@pytest.mark.parametrize("context,quality", [("hyperprior", None),
                                             ("space-channel", 1.37)])
def test_reference_matches_the_port_on_the_cpu(context, quality, tmp_path):
    rt, ref, conf = _pair(context, tmp_path)
    img = core.seeded_image(128, 192, 7)
    q = 0 if quality is None else quality
    blob = rt.compress(img) if quality is None else rt.compress(
        img, quality=quality)
    # The reference's own quantization gives the port's symbols ...
    z, y, y_hat = ref.analyse(img, q)
    hdr, rz, ry, r_hat = ref.read_blob(blob)
    assert torch.equal(rz, z) and torch.equal(ry, y)
    assert torch.equal(r_hat, y_hat)
    # ... and the served decode of the same ε is the port's, to 1 level.
    eps = torch.randn((1, 128, 192, 3), generator=torch.Generator()
                      .manual_seed(3))
    got = rt.decompress(blob, noise=eps)
    want = ref.serve(y_hat, eps, q, conf["sample"]["blend_gamma"], 128, 192)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_reference_gamma_search_matches_the_port(tmp_path):
    rt, ref, _ = _pair("hyperprior", tmp_path)
    img = core.seeded_image(128, 192, 8)
    eps = torch.randn((1, 128, 192, 3), generator=torch.Generator()
                      .manual_seed(4))
    blob = rt.compress(img, optimize_gamma="spatial", noise=eps)
    hdr, _, _, _ = ref.read_blob(blob)
    _, _, y_hat = ref.analyse(img)
    g, grid = ref.gamma_search(img, y_hat, eps)
    assert hdr.gamma_or_none == pytest.approx(g)
    if grid is None:
        assert hdr.gamma_grid is None
    else:
        assert np.abs(hdr.gamma_grid.astype(int) - grid.astype(int)).max() <= 1


def test_fp8_control_moves_only_the_bf16_products(tmp_path):
    """The control rounds the bf16 products to fp8 and leaves the f32 ones
    (h_s, the context models): its analysis differs, its hyper stage on
    the same z does not."""
    from cdcbench.reference.ops.layers import fp8_products
    _, ref, _ = _pair("hyperprior", tmp_path)
    img = core.seeded_image(128, 128, 9)
    z, y, y_hat = ref.analyse(img)
    ref.set_control(True)
    try:
        with fp8_products():
            cz, cy, c_hat = ref.analyse(img)
            means_c = ref.passes(z, y=y_hat)[1]
    finally:
        ref.set_control(False)
    means = ref.passes(z, y=y_hat)[1]
    assert not torch.equal(c_hat, y_hat)
    assert torch.equal(means_c, means)
