"""tpucdc_torch's DDIM sampler against the JAX package's.

The tables must be equal; the chains are fed JAX's own initial ε (and, for
η > 0, JAX's per-step z) and a net function both sides compute alike, and
agree to atol 1e-5 (f32 elementwise arithmetic, ~1e-7 per step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucdc.ops import make_schedule as jax_make_schedule
from tpucdc.sampling import ddim as jax_ddim

from tpucdc_torch.ops import make_schedule
from tpucdc_torch.sampling import ddim_sample, ddim_step_tables

SHAPE = (1, 8, 12, 3)


@pytest.mark.parametrize("steps,eta,t_start",
                         [(5, 0.0, 150), (5, 0.5, 150), (50, 0.0, None),
                          (4, 1.0, 38)])
def test_step_tables_equal_jax(steps, eta, t_start):
    T = 1000 if t_start != 38 else 256
    want = jax_ddim.ddim_step_tables(jax_make_schedule("cosine", T), steps,
                                     eta, t_start)
    got = ddim_step_tables(make_schedule("cosine", T), steps, eta, t_start)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def _net_jax(x, t):
    return 0.3 * jnp.tanh(2.0 * x) + 1e-3 * t.astype(jnp.float32)[:, None,
                                                                  None, None]


def _net_torch(x, t):
    return 0.3 * torch.tanh(2.0 * x) + 1e-3 * t.to(torch.float32)[:, None,
                                                                  None, None]


def _jax_noise(key, steps, eta):
    """The initial ε and per-step z that jax_ddim.ddim_sample draws."""
    noise_rng, init_rng = jax_ddim._rng_streams(key)
    eps = jax_ddim._normal(init_rng, SHAPE)
    zs = []
    for _ in range(steps):
        noise_rng, sub = jax_ddim._split_keys(noise_rng)
        zs.append(jax_ddim._normal(sub, SHAPE))
    return eps, zs


@pytest.mark.parametrize("prediction,eta", [("residual", 0.0),
                                            ("residual", 0.5),
                                            ("eps", 0.0), ("x0", 0.0)])
def test_truncated_chain_matches_jax(prediction, eta):
    steps, t_start = 5, 150
    key = jax.random.key(0)
    x_ref = np.random.default_rng(2).uniform(-1, 1, SHAPE).astype(np.float32)
    want = jax_ddim.ddim_sample(
        _net_jax, jax_make_schedule("cosine", 1000), SHAPE, key,
        num_steps=steps, eta=eta, t_start=t_start, x_ref=jnp.asarray(x_ref),
        prediction=prediction)
    eps, zs = _jax_noise(key, steps, eta)
    got = ddim_sample(
        _net_torch, make_schedule("cosine", 1000), SHAPE, num_steps=steps,
        eta=eta, noise=torch.from_numpy(np.array(eps)),
        step_noise=[torch.from_numpy(np.array(z)) for z in zs],
        x_ref=torch.from_numpy(x_ref), t_start=t_start, prediction=prediction,
        device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_generator_noise_is_reproducible():
    sched = make_schedule("cosine", 1000)
    run = lambda seed: ddim_sample(
        _net_torch, sched, SHAPE, num_steps=3, eta=0.5, t_start=100,
        generator=torch.Generator().manual_seed(seed),
        x_ref=torch.zeros(SHAPE), prediction="residual", device="cpu")
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
