"""tpucdc_torch's split UNet and its other samplers against the JAX package's.

Same weights (a JAX-initialised tiny UNet, perturbed away from its zero
output head, carried across by ``params_from_jax``), same inputs from numpy
seeds, F32_POLICY on both sides. Tolerances: one UNet forward 1e-4·max|out|
(the f32 module bound of tests/test_torch_modules.py); a sampler's chain fed
JAX's ε and z with a net both sides compute alike 1e-5 (f32 elementwise
arithmetic, ~1e-7 a step), or 2e-5 over the 16 DDPM steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucdc.diffusion import UNet as JaxUNet
from tpucdc.diffusion import UNetConfig as JaxUNetConfig
from tpucdc.ops import make_schedule as jax_make_schedule
from tpucdc.runtime import F32_POLICY as JAX_F32
from tpucdc.sampling import ddim as jax_ddim
from tpucdc.sampling import ddpm as jax_ddpm
from tpucdc.sampling import guidance as jax_guidance

from tests._torch_jax_helpers import flat_params, maxdiff, t
from tpucdc_torch.config import UNetConfig
from tpucdc_torch.diffusion import UNet
from tpucdc_torch.ops import make_schedule
from tpucdc_torch.runtime import F32_POLICY
from tpucdc_torch.sampling import (ddim_sample, ddim_sample_blockcached,
                                   ddpm_sample, make_batched_cfg_eps_fn,
                                   make_cfg_eps_fn)
from tpucdc_torch.utils import params_from_jax

TINY = dict(base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attn_levels=(1,), num_heads=2, patch_size=2, groups=8)
SHAPE = (2, 16, 16, 3)


@pytest.mark.parametrize("kwargs,split", [
    (dict(channel_mult=(1, 2, 3, 4), attn_levels=(2, 3)), 2),
    (dict(channel_mult=(1, 2, 3), attn_levels=(2,), cache_split=1), 1),
    (dict(channel_mult=(1, 2), attn_levels=(0, 1)), 1),
    (dict(channel_mult=(1, 2, 3), attn_levels=()), 2),
])
def test_split_level_and_cache_shape_equal_jax(kwargs, split):
    got, want = UNetConfig(**kwargs), JaxUNetConfig(**kwargs)
    assert got.split_level == want.split_level == split
    assert got.cache_shape(3, 128, 192) == want.cache_shape(3, 128, 192)


@pytest.fixture(scope="module")
def unets():
    """(JAX UNet, params, port UNet) on the same perturbed weights."""
    jmodel = JaxUNet(JaxUNetConfig(**TINY), policy=JAX_F32)
    x = jnp.zeros(SHAPE)
    params = jmodel.init(jax.random.key(1), x, jnp.array([3, 5]))
    rng = np.random.default_rng(2)
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    flat = {k.replace("['params']", "['params']['unet']", 1): v
            for k, v in flat_params(params).items()}
    state, unused = params_from_jax(flat)
    assert not unused
    tmodel = UNet(UNetConfig(**TINY), policy=F32_POLICY)
    tmodel.load_state_dict({k.removeprefix("unet."): v
                            for k, v in state.items()}, strict=True)
    return jmodel, params, tmodel.eval()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE).astype(np.float32),
            np.array([3, 200], np.int32))


def test_return_cache_then_deep_cache_reproduces_the_forward(unets):
    jmodel, params, tmodel = unets
    x, tt = _inputs(0)
    with torch.no_grad():
        full = tmodel(t(x), t(tt))
        fresh, cache = tmodel(t(x), t(tt), return_cache=True)
        cached = tmodel(t(x), t(tt), deep_cache=cache)
    # The split forward is the same sequence of operations as the full one.
    assert torch.equal(fresh, full)
    assert cache.dtype == torch.float32
    assert tuple(cache.shape) == UNetConfig(**TINY).cache_shape(2, 16, 16)
    assert maxdiff(cached, full) <= 1e-5
    want, want_cache = jmodel.apply(params, jnp.asarray(x), jnp.asarray(tt),
                                    return_cache=True)
    assert maxdiff(full, want) <= 1e-4 * float(np.abs(want).max())
    assert maxdiff(cache, want_cache) <= 1e-4 * float(np.abs(want_cache).max())
    want_cached = jmodel.apply(params, jnp.asarray(x), jnp.asarray(tt),
                               deep_cache=want_cache)
    assert maxdiff(cached, want_cached) <= 1e-4 * float(np.abs(want).max())


def test_a_stale_cache_changes_the_output(unets):
    """The deep segment really is skipped, not recomputed."""
    _, _, tmodel = unets
    (x1, tt), (x2, _) = _inputs(0), _inputs(9)
    with torch.no_grad():
        _, cache1 = tmodel(t(x1), t(tt), return_cache=True)
        full2 = tmodel(t(x2), t(tt))
        stale = tmodel(t(x2), t(tt), deep_cache=cache1)
    assert maxdiff(stale, full2) > 1e-4


# ---- samplers: nets both sides compute alike ----

def _net_jax(x, tv):
    return 0.3 * jnp.tanh(2.0 * x) + 1e-3 * tv.astype(jnp.float32)[:, None,
                                                                   None, None]


def _net_torch(x, tv):
    return 0.3 * torch.tanh(2.0 * x) + 1e-3 * tv.to(torch.float32)[:, None,
                                                                   None, None]


def _cache_of(x, lib):
    """A stand-in deep cache: a function of the x it was made from."""
    return lib.tanh(x[:, ::2, ::2, :1])


def _fresh_jax(x, tv):
    return _net_jax(x, tv), _cache_of(x, jnp)


def _cached_jax(x, tv, c):
    return _net_jax(x, tv) + 0.1 * jnp.repeat(jnp.repeat(c, 2, 1), 2, 2)


def _fresh_torch(x, tv):
    return _net_torch(x, tv), _cache_of(x, torch)


def _cached_torch(x, tv, c):
    return _net_torch(x, tv) + 0.1 * c.repeat_interleave(
        2, 1).repeat_interleave(2, 2)


def _jax_noise(key, steps, shape=SHAPE):
    """The initial ε and per-step z that JAX's samplers draw from ``key``."""
    noise_rng, init_rng = jax_ddim._rng_streams(key)
    eps = np.array(jax_ddim._normal(init_rng, shape))
    zs = []
    for _ in range(steps):
        noise_rng, sub = jax_ddim._split_keys(noise_rng)
        zs.append(torch.from_numpy(np.array(jax_ddim._normal(sub, shape))))
    return torch.from_numpy(eps), zs


def test_blockcached_period_1_equals_ddim_sample():
    sched = make_schedule("cosine", 64)
    eps = torch.from_numpy(
        np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32))
    plain = ddim_sample(_net_torch, sched, SHAPE, num_steps=6, noise=eps,
                        device="cpu")
    cached = ddim_sample_blockcached(
        _fresh_torch, _cached_torch, sched, SHAPE, num_steps=6,
        cache_period=1, noise=eps, device="cpu")
    assert torch.equal(cached, plain)
    with pytest.raises(ValueError, match="cache_period"):
        ddim_sample_blockcached(_fresh_torch, _cached_torch, sched, SHAPE,
                                cache_period=0, noise=eps, device="cpu")


@pytest.mark.parametrize("prediction,eta", [("eps", 0.0), ("x0", 0.0),
                                            ("residual", 0.0),
                                            ("residual", 0.5)])
def test_blockcached_period_2_matches_jax(prediction, eta):
    steps, t_start = 5, 150
    key = jax.random.key(0)
    x_ref = np.random.default_rng(2).uniform(-1, 1, SHAPE).astype(np.float32)
    cshape = (SHAPE[0], SHAPE[1] // 2, SHAPE[2] // 2, 1)
    want = jax_ddim.ddim_sample_blockcached(
        _fresh_jax, _cached_jax, jax_make_schedule("cosine", 1000), SHAPE,
        cshape, key, num_steps=steps, cache_period=2, eta=eta,
        t_start=t_start, x_ref=jnp.asarray(x_ref), prediction=prediction)
    eps, zs = _jax_noise(key, steps)
    got = ddim_sample_blockcached(
        _fresh_torch, _cached_torch, make_schedule("cosine", 1000), SHAPE,
        num_steps=steps, cache_period=2, eta=eta, noise=eps, step_noise=zs,
        x_ref=t(x_ref), t_start=t_start, prediction=prediction, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # The cached steps did take the cache: the plain chain differs.
    plain = ddim_sample(
        _net_torch, make_schedule("cosine", 1000), SHAPE, num_steps=steps,
        eta=eta, noise=eps, step_noise=zs, x_ref=t(x_ref), t_start=t_start,
        prediction=prediction, device="cpu")
    assert maxdiff(got, plain) > 1e-3


def test_x_init_matches_jax_and_excludes_x_ref():
    key = jax.random.key(4)
    x_init = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    want = jax_ddim.ddim_sample(
        _net_jax, jax_make_schedule("cosine", 1000), SHAPE, key, num_steps=4,
        t_start=300, x_init=jnp.asarray(x_init))
    sched = make_schedule("cosine", 1000)
    got = ddim_sample(_net_torch, sched, SHAPE, num_steps=4, t_start=300,
                      x_init=t(x_init), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for sampler, fns in ((ddim_sample, (_net_torch,)),
                         (ddim_sample_blockcached,
                          (_fresh_torch, _cached_torch))):
        with pytest.raises(ValueError, match="not both"):
            sampler(*fns, sched, SHAPE, num_steps=4, t_start=300,
                    x_init=t(x_init), x_ref=t(x_init), device="cpu")


def test_samplers_default_to_the_card():
    """An entry point runs on the card unless asked for the CPU: without a
    card and without ``device="cpu"`` it raises, it does not fall back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    sched = make_schedule("cosine", 16)
    for call in (lambda: ddim_sample(_net_torch, sched, SHAPE, num_steps=2),
                 lambda: ddim_sample_blockcached(_fresh_torch, _cached_torch,
                                                 sched, SHAPE, num_steps=2),
                 lambda: ddpm_sample(_net_torch, sched, SHAPE)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_ddpm_matches_jax_on_a_16_step_schedule():
    key = jax.random.key(7)
    want = jax_ddpm.ddpm_sample(_net_jax, jax_make_schedule("cosine", 16),
                                SHAPE, key)
    # ddpm_sample splits its keys as ddim_sample does: the same two streams.
    eps, zs = _jax_noise(key, 16)
    got = ddpm_sample(_net_torch, make_schedule("cosine", 16), SHAPE,
                      noise=eps, step_noise=zs, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    run = lambda seed: ddpm_sample(
        _net_torch, make_schedule("cosine", 16), SHAPE,
        generator=torch.Generator().manual_seed(seed), device="cpu")
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def test_cfg_builders_match_jax():
    x, tt = _inputs(6)
    cond_j = lambda x_, t_: _net_jax(x_, t_)
    uncond_j = lambda x_, t_: 0.5 * _net_jax(x_, t_) - 0.1
    cond_t = lambda x_, t_: _net_torch(x_, t_)
    uncond_t = lambda x_, t_: 0.5 * _net_torch(x_, t_) - 0.1
    assert make_cfg_eps_fn(cond_t, uncond_t, 1.0) is cond_t
    assert make_cfg_eps_fn(cond_t, None, 3.0) is cond_t
    want = jax_guidance.make_cfg_eps_fn(cond_j, uncond_j, 2.5)(
        jnp.asarray(x), jnp.asarray(tt))
    got = make_cfg_eps_fn(cond_t, uncond_t, 2.5)(t(x), t(tt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    # Batch-doubled: the second half of the batch is the unconditional one.
    def doubled_j(x2, t2):
        return jnp.concatenate([cond_j(x2[:2], t2[:2]),
                                uncond_j(x2[2:], t2[2:])])

    def doubled_t(x2, t2):
        assert x2.shape[0] == 4 and t2.shape[0] == 4
        return torch.cat([cond_t(x2[:2], t2[:2]), uncond_t(x2[2:], t2[2:])])

    want2 = jax_guidance.make_batched_cfg_eps_fn(doubled_j, 2.5)(
        jnp.asarray(x), jnp.asarray(tt))
    got2 = make_batched_cfg_eps_fn(doubled_t, 2.5)(t(x), t(tt))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=1e-6)
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-6)
