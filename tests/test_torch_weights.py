"""Carrying the flagship's flax weights into tpucdc_torch.

``artifacts/flagship_params.npz`` (398 arrays) loads completely into the
decode slice: unet 330, cond_head 16, g_s 14, h_s 6 and factorized 12. The
20 encoder arrays (g_a 14, h_a 6) are left for the encode slice.
"""

import collections

import numpy as np
import pytest

from tests._torch_jax_helpers import FLAGSHIP_NPZ
from tpucdc_torch import CDCModel, flagship_serving
from tpucdc_torch.utils import load_params_npz, params_from_jax

ENCODER_KEYS = sorted(
    [f"['params']['g_a']['conv{i}']['{p}']" for i in range(4)
     for p in ("bias", "kernel")]
    + [f"['params']['g_a']['gdn{i}']['{p}']" for i in range(3)
       for p in ("beta_r", "gamma_r")]
    + [f"['params']['h_a']['conv{i}']['{p}']" for i in range(3)
       for p in ("bias", "kernel")])


@pytest.fixture(scope="module")
def loaded():
    state, unused = load_params_npz(FLAGSHIP_NPZ)
    return state, unused, CDCModel(flagship_serving().model)


def test_flagship_loads_completely(loaded):
    state, unused, model = loaded
    assert unused == ENCODER_KEYS and len(unused) == 20
    counts = collections.Counter(k.split(".")[0] for k in state)
    assert counts == {"unet": 330, "cond_head": 16, "g_s": 14, "h_s": 6,
                      "factorized": 12}
    model.load_state_dict(state, strict=True)


def test_every_shape_matches_the_flax_layout(loaded):
    state, _, model = loaded
    expected = model.state_dict()
    assert set(state) == set(expected)
    with np.load(FLAGSHIP_NPZ) as flax:
        for key in flax.files:
            if key in ENCODER_KEYS:
                continue
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
