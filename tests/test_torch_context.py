"""The encode-side transforms and the context entropy models of tpucdc_torch
against the JAX package's, on the same weights and the same numpy inputs.

Tolerances. F32_POLICY on both sides: max|diff| <= 1e-4·max|reference| (the
sums run in other orders in XLA and PyTorch). The bf16 policy on both sides:
max|diff| <= 2e-2·max|reference|, the bf16 bound of tests/test_torch_ops.py
(each layer rounds its output to 8 bits of mantissa, and the two packages
sum in other orders before that rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucdc.codec.context_model import checkerboard_mask as jax_mask
from tpucdc.model import CDCModel as JaxCDCModel
from tpucdc.runtime import BF16_POLICY as JAX_BF16

from tests._torch_jax_helpers import (one_torch_thread,  # noqa: F401
                                      CONTEXTS, flagship_jax, init_jax, t,
                                      tiny_config, torch_model)
from tpucdc_torch.codec import checkerboard_mask
from tpucdc_torch.codec.quantization import (additive_noise,
                                             quantize_dequantize, ste_round)
from tpucdc_torch.runtime import BF16_POLICY, F32_POLICY, set_policy

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = {"f32": 1e-4, "bf16": 2e-2}


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    bound = rel * np.abs(want).max()
    diff = np.abs(got - want).max()
    assert diff <= bound, f"max|diff| {diff:.3g} > {bound:.3g}"


@pytest.fixture(scope="module", params=CONTEXTS)
def pair(request):
    """(config, JAX model of each policy, params, the port's model)."""
    cfg = tiny_config(context=request.param, num_qualities=3)
    jmodel, params = init_jax(cfg)
    jmodels = {"f32": jmodel,
               "bf16": JaxCDCModel(cfg.model.validated(), policy=JAX_BF16)}
    return cfg, jmodels, params, torch_model(cfg, params)


def _with_policy(tm, dn):
    set_policy(tm, BF16_POLICY if dn == "bf16" else F32_POLICY)
    return tm


@pytest.mark.parametrize("hw", [(64, 64), (50, 70)])
@pytest.mark.parametrize("dn", ["f32", "bf16"])
def test_analysis_and_hyper_analysis_match_jax(pair, dn, hw):
    """g_a's four stride-2 5×5 "SAME" convs pad (1, 2) at even sizes and
    (2, 2) at odd ones; 50×70 walks through 25×35, 13×18, 7×9, 4×5."""
    cfg, jmodels, params, tm = pair
    tm = _with_policy(tm, dn)
    x = np.clip(0.5 * _randn(1, *hw, 3, seed=1), -1, 1)
    gain = np.abs(1 + 0.2 * _randn(cfg.model.codec.latent_channels, seed=2))
    want_y, want_z = jmodels[dn].apply(params, jnp.asarray(x),
                                       jnp.asarray(gain),
                                       method=JaxCDCModel.encode_gained_vec)
    got_y, got_z = tm.encode(t(x), t(gain))
    _close(got_y, want_y, REL[dn])
    _close(got_z, want_z, REL[dn])
    want_y1, _ = jmodels[dn].apply(params, jnp.asarray(x),
                                   method=JaxCDCModel.encode)
    _close(tm.encode(t(x))[0], want_y1, REL[dn])


@pytest.mark.parametrize("dn", ["f32", "bf16"])
def test_entropy_parameter_passes_match_jax(pair, dn):
    """h_s's feature trunk and every pass of the pair's context model."""
    cfg, jmodels, params, tm = pair
    tm, jm = _with_policy(tm, dn), jmodels[dn]
    codec = cfg.model.codec
    rel = REL[dn]
    z = np.round(2 * _randn(1, 2, 3, codec.hyper_channels, seed=3))
    y = np.round(3 * _randn(1, 8, 12, codec.latent_channels, seed=4))
    am = jax_mask(8, 12, anchor=True)
    if codec.context == "hyperprior":
        want = jm.apply(params, jnp.asarray(z), method=JaxCDCModel.hyper_decode)
        for g, w in zip(tm.hyper_decode(t(z)), want):
            _close(g, w, rel)
        return
    feats = jm.apply(params, jnp.asarray(z), method=JaxCDCModel.hyper_features)
    got_feats = tm.hyper_features(t(z))
    _close(got_feats, feats, rel)
    # The passes proper are compared on JAX's features, so that each pass's
    # bound is its own and not the trunk's on top.
    tf = t(np.asarray(feats, np.float32)).to(got_feats.dtype)

    def both(method, tmethod, *args):
        want = jm.apply(params, *[jnp.asarray(a) if isinstance(a, np.ndarray)
                                  else a for a in args], method=method)
        got = tmethod(*[t(a) if isinstance(a, np.ndarray) else a
                        for a in args])
        for g, w in zip(got, want):
            _close(g, w, rel)
            assert g.dtype == torch.float32

    fnp = np.asarray(feats.astype(jnp.float32))
    mg = codec.latent_channels // codec.context_groups
    if codec.context == "checkerboard":
        both(JaxCDCModel.ctx_anchor_params, tm.ctx_anchor_params, fnp)
        both(JaxCDCModel.ctx_nonanchor_params, tm.ctx_nonanchor_params,
             fnp, y * am)
    for g in range(codec.context_groups):
        y_prev, y_g = y[..., :g * mg], y[..., g * mg:(g + 1) * mg]
        if codec.context == "channel-ar":
            both(JaxCDCModel.ctx_group_params, tm.ctx_group_params,
                 g, fnp, y_prev)
        elif codec.context == "space-channel":
            both(JaxCDCModel.sc_anchor_params, tm.sc_anchor_params,
                 g, fnp, y_prev)
            both(JaxCDCModel.sc_nonanchor_params, tm.sc_nonanchor_params,
                 g, fnp, y_prev, y_g * am)
    want = jm.apply(params, feats, jnp.asarray(y),
                    method=lambda m, f, yy: m.context(f, yy))
    for g, w in zip(tm.context(tf, t(y)), want):
        _close(g, w, rel)


def test_flagship_analysis_matches_jax_at_full_width():
    cfg, jmodel, params = flagship_jax()
    tm = torch_model(cfg, params)
    x = np.clip(0.5 * _randn(1, 64, 64, 3, seed=5), -1, 1)
    want_y, want_z = jmodel.apply(params, jnp.asarray(x),
                                  method=JaxCDCModel.encode)
    got_y, got_z = tm.encode(t(x))
    _close(got_y, want_y, REL["f32"])
    _close(got_z, want_z, REL["f32"])


@pytest.mark.parametrize("hw", [(4, 6), (5, 7)])
def test_checkerboard_mask_matches_jax(hw):
    for anchor in (True, False):
        np.testing.assert_array_equal(checkerboard_mask(*hw, anchor),
                                      jax_mask(*hw, anchor))


def test_quantization_proxies():
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.3], requires_grad=True)
    r = ste_round(x)
    # Half to even, as jnp.round and np.round.
    np.testing.assert_array_equal(r.detach().numpy(),
                                  np.round(x.detach().numpy()))
    r.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(7, np.float32))
    mu = torch.full((7,), 0.25)
    np.testing.assert_array_equal(
        quantize_dequantize(x.detach(), mu).numpy(),
        np.round(x.detach().numpy() - 0.25) + np.float32(0.25))
    noisy = additive_noise(torch.zeros(1000),
                           torch.Generator().manual_seed(0))
    assert -0.5 <= noisy.min() and noisy.max() < 0.5 and noisy.std() > 0.2
