"""tpucdc_torch modules against the JAX package's, on the same weights.

Everything runs under F32_POLICY on the CPU with atol 1e-4 (the sums run in
other orders in XLA and PyTorch; f32 keeps ~7 digits of values of order 1-10).
Weights go JAX → port through ``params_from_jax``, so each case also checks
the key and layout mapping. The three layout hazards of the port have their
own cases: the (py, px, c) space-to-depth order, flax "SAME" stride-2
padding, and flax's ConvTranspose.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpucdc.codec.transforms import GDN as JaxGDN
from tpucdc.diffusion.blocks import AttentionBlock as JaxAttentionBlock
from tpucdc.diffusion.blocks import ResBlock as JaxResBlock
from tpucdc.diffusion.unet import _depth_to_space as jax_d2s
from tpucdc.diffusion.unet import _space_to_depth as jax_s2d
from tpucdc.model import CDCModel as JaxCDCModel
from tpucdc.runtime import F32_POLICY as JAX_F32

from tests._torch_jax_helpers import (flagship_jax, init_jax, maxdiff, t,
                                      tiny_config, torch_model)
from tpucdc_torch.codec.transforms import GDN
from tpucdc_torch.diffusion.unet import _depth_to_space, _space_to_depth
from tpucdc_torch.ops.layers import Conv, ConvTranspose
from tpucdc_torch.utils import params_from_jax

ATOL = 1e-4


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    jmodel, params = init_jax(cfg)
    return cfg, jmodel, params, torch_model(cfg, params)


@pytest.fixture(scope="module")
def flagship():
    cfg, jmodel, params = flagship_jax()
    return cfg, jmodel, params, torch_model(cfg, params)


def _load_layer(module, flax_params: dict, prefix: str):
    """Map one flax layer's params through params_from_jax under ``prefix``."""
    flat = {f"['params']{prefix}['{k}']": np.asarray(v)
            for k, v in flax_params.items()}
    state, _ = params_from_jax(flat)
    head = state and next(iter(state)).rsplit(".", 1)[0] + "."
    module.load_state_dict({k[len(head):]: v for k, v in state.items()})
    return module


# ---- layout hazards ----

@pytest.mark.parametrize("p", [2, 4])
def test_space_to_depth_order_matches_jax(p):
    x = _randn(2, 8, 12, 3, seed=p)
    np.testing.assert_array_equal(_space_to_depth(t(x), p).numpy(),
                                  np.asarray(jax_s2d(jnp.asarray(x), p)))
    y = _randn(2, 3, 4, 3 * p * p, seed=p + 1)
    np.testing.assert_array_equal(_depth_to_space(t(y), p).numpy(),
                                  np.asarray(jax_d2s(jnp.asarray(y), p)))
    # The hazard: pixel_unshuffle orders channels (c, py, px), not (py, px, c).
    unshuffled = F.pixel_unshuffle(t(x).permute(0, 3, 1, 2), p).permute(
        0, 2, 3, 1)
    assert not torch.equal(unshuffled, _space_to_depth(t(x), p))


@pytest.mark.parametrize("hw", [(8, 12), (7, 9)])
@pytest.mark.parametrize("k,stride", [(3, 2), (3, 1), (5, 2), (1, 1)])
def test_conv_same_padding_matches_flax(hw, k, stride):
    layer = fnn.Conv(5, (k, k), strides=(stride, stride), padding="SAME")
    x = _randn(1, *hw, 4, seed=k)
    params = layer.init(jax.random.key(k), jnp.asarray(x))["params"]
    want = layer.apply({"params": params}, jnp.asarray(x))
    conv = _load_layer(Conv(4, 5, k, stride), params,
                       "['unet']['downsamplers_0']['Conv_0']")
    got = conv(t(x), torch.float32)
    assert got.shape == want.shape
    assert maxdiff(got, want) <= 1e-5


@pytest.mark.parametrize("hw", [(2, 3), (4, 4)])
def test_conv_transpose_matches_flax(hw):
    layer = fnn.ConvTranspose(6, (5, 5), strides=(2, 2), padding="SAME")
    x = _randn(1, *hw, 4, seed=hw[0])
    params = layer.init(jax.random.key(1), jnp.asarray(x))["params"]
    want = layer.apply({"params": params}, jnp.asarray(x))
    deconv = _load_layer(ConvTranspose(4, 6, 5, 2), params,
                         "['g_s']['deconv0']")
    got = deconv(t(x), torch.float32)
    assert got.shape == want.shape == (1, 2 * hw[0], 2 * hw[1], 6)
    assert maxdiff(got, want) <= 1e-5


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_flax(inverse):
    x = _randn(1, 3, 4, 8, seed=3)
    jgdn = JaxGDN(inverse=inverse, policy=JAX_F32)
    params = jgdn.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = {"beta_r": params["beta_r"] + 0.3,
              "gamma_r": params["gamma_r"] + 0.05 * _randn(8, 8, seed=4)}
    want = jgdn.apply({"params": params}, jnp.asarray(x))
    gdn = _load_layer(GDN(8, inverse), params, "['g_s']['igdn0']")
    assert maxdiff(gdn(t(x)), want) <= 1e-5


# ---- blocks of the tiny model ----

def test_resblock_matches_jax(tiny):
    cfg, _, params, tm = tiny
    p = params["params"]["unet"]["down_res_1_0"]
    x, temb = _randn(1, 8, 8, 16, seed=5), _randn(1, 64, seed=6)
    want = JaxResBlock(32, cfg.model.unet.groups, JAX_F32).apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(temb))
    got = tm.unet.down_res[1][0](t(x), t(temb))
    assert maxdiff(got, want) <= ATOL


@pytest.mark.parametrize("name", ["down_attn_1_0", "down_xattn_1_0"])
def test_attention_block_matches_jax(tiny, name):
    cfg, _, params, tm = tiny
    p = params["params"]["unet"][name]
    x, ctx = _randn(1, 8, 8, 32, seed=7), _randn(1, 4, 32, seed=8)
    context = ctx if "xattn" in name else None
    want = JaxAttentionBlock(cfg.model.unet.num_heads, cfg.model.unet.groups,
                             JAX_F32).apply(
        {"params": p}, jnp.asarray(x),
        None if context is None else jnp.asarray(context))
    block = getattr(tm.unet, name.rsplit("_", 2)[0])[1][0]
    got = block(t(x), None if context is None else t(context))
    assert maxdiff(got, want) <= ATOL


# ---- whole modules: tiny preset, and the flagship's weights ----

def _unet_inputs(cfg, size):
    m = cfg.model.validated()
    grid = size // m.unet.patch_size
    latent = size // 16
    return (_randn(1, size, size, 3, seed=9), np.array([37], np.int32),
            _randn(1, grid, grid, m.cond.feature_channels, seed=10),
            _randn(1, latent * latent, m.cond.token_dim, seed=11),
            _randn(1, size, size, 3, seed=12))


@pytest.mark.parametrize("which,size", [("tiny", 32), ("flagship", 64)])
def test_unet_matches_jax(request, which, size):
    cfg, jmodel, params, tm = request.getfixturevalue(which)
    x, tt, cf, ct, xb = _unet_inputs(cfg, size)
    want = jmodel.apply(params, *map(jnp.asarray, (x, tt, cf, ct, xb)),
                        method=JaxCDCModel.denoise)
    got = tm.denoise(*map(t, (x, tt, cf, ct, xb)))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert maxdiff(got, want) <= ATOL


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_conditioning_head_matches_jax(request, which):
    cfg, jmodel, params, tm = request.getfixturevalue(which)
    y = 3 * _randn(1, 4, 4, cfg.model.codec.latent_channels, seed=13)
    want_f, want_t = jmodel.apply(params, jnp.asarray(y),
                                  method=JaxCDCModel.cond_signal)
    got_f, got_t = tm.cond_signal(t(y))
    assert got_f.shape == want_f.shape and got_t.shape == want_t.shape
    assert maxdiff(got_f, want_f) <= ATOL
    assert maxdiff(got_t, want_t) <= ATOL


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_synthesis_and_hyper_synthesis_match_jax(request, which):
    cfg, jmodel, params, tm = request.getfixturevalue(which)
    codec = cfg.model.codec
    y = 3 * _randn(1, 2, 3, codec.latent_channels, seed=14)
    want = jmodel.apply(params, jnp.asarray(y), method=JaxCDCModel.synthesize)
    got = tm.synthesize(t(y))
    assert got.shape == want.shape
    assert maxdiff(got, want) <= ATOL
    z = np.round(2 * _randn(1, 2, 3, codec.hyper_channels, seed=15))
    want_m, want_s = jmodel.apply(params, jnp.asarray(z),
                                  method=JaxCDCModel.hyper_decode)
    got_m, got_s = tm.hyper_decode(t(z))
    assert maxdiff(got_m, want_m) <= ATOL
    assert maxdiff(got_s, want_s) <= ATOL
