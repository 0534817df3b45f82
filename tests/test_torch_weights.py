"""Carrying the JAX package's flax weights into tpucdc_torch.

``artifacts/flagship_params.npz`` (398 arrays) loads completely: unet 330,
cond_head 16, g_s 14, g_a 14, h_s 6, h_a 6 and factorized 12.
``artifacts/vr_wide_params.npz`` (438 arrays) has h_s without its (μ, σ)
projection (4), the space-channel context (40) and the two gain tables on
top. Nothing of either file is left unused, and a JAX-initialised tiny model
of every entropy model with three gain rows maps key for key as well.
"""

import collections

import numpy as np
import pytest

from tests._torch_jax_helpers import (CONTEXTS, FLAGSHIP_NPZ, ROOT,
                                      flat_params, init_jax, tiny_config,
                                      to_torch_config)
from tpucdc_torch import CDCModel, flagship_serving
from tpucdc_torch.presets import vr_wide_serving
from tpucdc_torch.utils import load_params_npz, params_from_jax

VR_WIDE_NPZ = ROOT / "artifacts" / "vr_wide_params.npz"


@pytest.fixture(scope="module")
def loaded():
    state, unused = load_params_npz(FLAGSHIP_NPZ)
    return state, unused, CDCModel(flagship_serving().model)


def test_flagship_loads_completely(loaded):
    state, unused, model = loaded
    assert unused == [] and len(state) == 398
    counts = collections.Counter(k.split(".")[0] for k in state)
    assert counts == {"unet": 330, "cond_head": 16, "g_s": 14, "g_a": 14,
                      "h_s": 6, "h_a": 6, "factorized": 12}
    model.load_state_dict(state, strict=True)


def test_vr_wide_loads_completely():
    state, unused = load_params_npz(VR_WIDE_NPZ)
    assert unused == [] and len(state) == 438
    counts = collections.Counter(k.split(".")[0] for k in state)
    assert counts == {"unet": 330, "cond_head": 16, "g_s": 14, "g_a": 14,
                      "h_s": 4, "h_a": 6, "factorized": 12, "context": 40,
                      "gains": 1, "inv_gains": 1}
    model = CDCModel(vr_wide_serving().model)
    model.load_state_dict(state, strict=True)
    with np.load(VR_WIDE_NPZ) as flax:
        np.testing.assert_array_equal(model.gains.detach().numpy(),
                                      flax["['params']['gains']"])
        k = flax["['params']['context']['anchor_heads_3_0']['kernel']"]
    np.testing.assert_array_equal(
        model.context.anchor_heads[3][0].weight.detach().numpy(),
        k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("context", CONTEXTS)
def test_jax_initialised_model_of_each_context_loads_strictly(context):
    cfg = tiny_config(context=context, num_qualities=3)
    _, params = init_jax(cfg, perturb=0.0)
    flat = flat_params(params)
    state, unused = params_from_jax(flat)
    assert unused == [] and len(state) == len(flat)
    CDCModel(to_torch_config(cfg).model).load_state_dict(state, strict=True)


def test_every_shape_matches_the_flax_layout(loaded):
    state, _, model = loaded
    expected = model.state_dict()
    assert set(state) == set(expected)
    with np.load(FLAGSHIP_NPZ) as flax:
        for key in flax.files:
            arr = flax[key]
            shape = tuple(arr.shape)
            name = next(k for k, v in params_from_jax({key: arr})[0].items())
            assert tuple(state[name].shape) == tuple(expected[name].shape)
            if key.endswith("['kernel']") and arr.ndim == 4:
                kh, kw, cin, cout = shape
                want = ((cin, cout, kh, kw) if "deconv" in key
                        else (cout, cin, kh, kw))
                assert tuple(state[name].shape) == want, key
            elif key.endswith("['kernel']"):
                assert tuple(state[name].shape) == shape[::-1], key
            else:
                assert tuple(state[name].shape) == shape, key


def test_missing_key_raises(loaded):
    state, _, model = loaded
    partial = dict(state)
    partial.pop("unet.mid_attn.q.weight")
    with pytest.raises(RuntimeError, match="mid_attn.q.weight"):
        model.load_state_dict(partial, strict=True)


def test_conv_transpose_kernel_is_flipped():
    k = np.arange(5 * 5 * 2 * 3, dtype=np.float32).reshape(5, 5, 2, 3)
    state, _ = params_from_jax({"['params']['g_s']['deconv0']['kernel']": k,
                                "['params']['unet']['conv_in']['kernel']": k})
    np.testing.assert_array_equal(state["g_s.deconv0.weight"].numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(state["unet.conv_in.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
