"""The training forward and the analytic rate estimate against the JAX package.

On the tiny preset in f32, with the port's initialisation (plus seeded noise)
carried to JAX: ``CDCModel.forward`` fed JAX's draws against
``tpucdc.model.CDCModel.__call__`` in training and eval mode, for every
context kind and every prediction mode, with variable-rate gains drawn per
image, conditioning dropout and the t-low bias; ``rate_estimate`` for every
context kind with and without a gain vector. Every returned array is within
1e-5 of JAX's, relative in the 2-norm.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpucdc.pipelines.train import schedule_tables as jax_schedule_tables

from tests._torch_jax_helpers import (CONTEXTS, jax_forward_draws,
                                      one_torch_thread_per_module,  # noqa: F401
                                      port_init_pair, rel_err, tiny_config,
                                      with_gain_ladder)
from tpucdc_torch.pipelines.train import schedule_tables

REL = 1e-5
PREDICTION = {"hyperprior": "residual", "checkerboard": "x0",
              "channel-ar": "eps", "space-channel": "residual"}


def _config(context):
    cfg = tiny_config(context=context, num_qualities=3)
    model = dataclasses.replace(cfg.model, prediction=PREDICTION[context],
                                cond_dropout_prob=0.5, t_low_frac=0.35,
                                t_low_prob=0.5)
    return dataclasses.replace(cfg, model=model)


@pytest.fixture(scope="module")
def pairs():
    """Per context: (cfg, JAX model, params, port model), built on demand."""
    cache = {}

    def get(context):
        if context not in cache:
            cfg = _config(context)
            jm, params, tm = port_init_pair(cfg, seed=CONTEXTS.index(context))
            params = with_gain_ladder(params,
                                      cfg.model.codec.latent_channels)
            for name in ("gains", "inv_gains"):
                getattr(tm, name).data.copy_(torch.from_numpy(
                    np.array(params["params"][name])))
            cache[context] = (cfg, jm, params, tm)
        return cache[context]
    return get


def _image(seed, b=4):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("context", CONTEXTS)
def test_forward_matches_jax(pairs, context, train):
    cfg, jm, params, tm = pairs(context)
    x = _image(CONTEXTS.index(context))
    rng = jax.random.key(11)
    tables = jax_schedule_tables(cfg)
    T = cfg.model.schedule.num_steps
    want = jax.jit(lambda p, x, r: jm.apply(p, x, r, tables, train=train))(
        params, x, rng)
    draws = jax_forward_draws(cfg.model, rng, x.shape, T, train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), schedule_tables(cfg, "cpu"),
                 train=train, draws=draws)
    assert set(got) == set(want)
    for key, value in want.items():
        if value is None:
            assert got[key] is None, key
            continue
        assert tuple(got[key].shape) == value.shape, key
        assert rel_err(got[key], value) <= REL, (key, rel_err(got[key], value))
    if train:
        # The draws exercise what they should: qualities differ, the t-low
        # bias and the dropout both fire for some image and not for another.
        assert len(set(draws["quality"].tolist())) > 1
        assert not draws["keep"].all() and draws["keep"].any()
        assert (draws["t"] < int(0.35 * T)).any() and (
            draws["t"] >= int(0.35 * T)).any()


@pytest.mark.parametrize("gain", [None, 0, 2], ids=["single", "q0", "q2"])
@pytest.mark.parametrize("context", CONTEXTS)
def test_rate_estimate_matches_jax(pairs, context, gain):
    cfg, jm, params, tm = pairs(context)
    x = _image(10 + CONTEXTS.index(context), b=1)
    g = None if gain is None else np.array(params["params"]["gains"][gain])
    from tpucdc.model import CDCModel as JaxCDCModel
    want = jm.apply(params, x, g, method=JaxCDCModel.rate_estimate)
    with torch.no_grad():
        got = tm.rate_estimate(torch.from_numpy(x),
                               None if g is None else torch.from_numpy(g))
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) <= REL * abs(float(b)), (a, b)


def test_forward_draws_from_its_generator(pairs):
    """Without injected draws the port draws from the generator: the same
    seed gives the same outputs, another seed other ones."""
    cfg, _, _, tm = pairs("hyperprior")
    x = torch.from_numpy(_image(3, b=2))
    tables = schedule_tables(cfg, "cpu")

    def run(seed):
        with torch.no_grad():
            return tm(x, tables, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    for key in ("eps", "t", "y_tilde", "x0_pred", "quality"):
        assert torch.equal(a[key], b[key]), key
    assert not torch.equal(a["eps"], c["eps"])
