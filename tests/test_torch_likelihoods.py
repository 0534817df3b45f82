"""The likelihood half of the entropy models, and the shuffle conditioning
head, against the JAX package.

``FactorizedPrior`` and ``GaussianConditional`` likelihoods, ``bits`` and
the factorized prior's ``aux_loss`` on seeded z and y in f32, within 1e-6
relative of JAX's; their gradients (the parameters' and the inputs') within
1e-5 relative of ``jax.grad``'s, in the 2-norm; ``aux_loss`` trains the
quantiles only. The conditioning head with ``upsample="shuffle"`` on
JAX-initialised weights within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucdc.codec import entropy_models as jax_em
from tpucdc.diffusion.conditioning import ConditioningConfig as JaxCondConfig
from tpucdc.diffusion.conditioning import ConditioningHead as JaxCondHead
from tpucdc.runtime import F32_POLICY as JAX_F32

from tests._torch_jax_helpers import (flat_params,
                                      one_torch_thread_per_module,  # noqa: F401
                                      rel_err)
from tpucdc_torch.codec import entropy_models as em
from tpucdc_torch.config import ConditioningConfig
from tpucdc_torch.diffusion.conditioning import ConditioningHead
from tpucdc_torch.runtime import F32_POLICY
from tpucdc_torch.utils import params_from_jax

C = 8
REL, GRAD_REL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def prior():
    """(JAX module, params with every leaf jittered, the port's module)."""
    z = jnp.zeros((1, 2, 2, C))
    module = jax_em.FactorizedPrior(channels=C)
    params = module.init(jax.random.key(0), z)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda p: p + 0.3 * rng.standard_normal(
        p.shape).astype(np.float32), params)
    port = em.FactorizedPrior(C)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          params["params"].items()}, strict=True)
    return module, params, port


def _z(seed=1):
    return np.random.default_rng(seed).normal(0, 3, (2, 3, 5, C)).astype(
        np.float32)


def test_factorized_likelihood_and_bits_match_jax(prior):
    module, params, port = prior
    z = _z()
    want = module.apply(params, z)
    with torch.no_grad():
        got = port(torch.from_numpy(z))
        far = port(torch.full((1, 1, 1, C), 1e4))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got, want) <= REL
    assert float(em.bits(got)) == pytest.approx(float(jax_em.bits(want)),
                                                rel=REL)
    # The floor: a value far in the tail has likelihood 1e-9, not 0.
    assert float(far.min()) == pytest.approx(1e-9)


def test_factorized_gradients_match_jax(prior):
    module, params, port = prior
    z = _z(2)
    f = lambda p, z: jnp.sum(jnp.log(module.apply(p, z)))
    gp, gz = jax.grad(f, argnums=(0, 1))(params, z)
    zt = torch.from_numpy(z).requires_grad_(True)
    torch.sum(torch.log(port(zt))).backward()
    assert rel_err(zt.grad, gz) <= GRAD_REL
    for name, p in port.named_parameters():
        want = gp["params"][name]
        if name == "quantiles":
            assert p.grad is None or not p.grad.any()
            assert not np.any(want)
            continue
        assert rel_err(p.grad, want) <= GRAD_REL, name


def test_aux_loss_matches_jax_and_trains_quantiles_only(prior):
    module, params, port = prior
    want, g = jax.value_and_grad(
        lambda p: module.apply(p, method=jax_em.FactorizedPrior.aux_loss)
    )(params)
    port.zero_grad()
    got = port.aux_loss()
    assert float(got.detach()) == pytest.approx(float(want), rel=REL)
    got.backward()
    assert rel_err(port.quantiles.grad, g["params"]["quantiles"]) <= GRAD_REL
    for name, p in port.named_parameters():
        if name != "quantiles":
            assert p.grad is None or not p.grad.any(), name


def test_gaussian_likelihood_and_gradients_match_jax():
    rng = np.random.default_rng(3)
    y = rng.normal(0, 4, (2, 4, 4, 16)).astype(np.float32)
    means = rng.normal(0, 2, y.shape).astype(np.float32)
    # Scales below the table's 0.11 are floored.
    scales = rng.uniform(0.01, 8.0, y.shape).astype(np.float32)
    gauss = jax_em.GaussianConditional()
    want = gauss.likelihood(y, means, scales)
    grads = jax.grad(lambda *a: jnp.sum(jnp.log(gauss.likelihood(*a))),
                     argnums=(0, 1, 2))(y, means, scales)
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (y, means, scales)]
    got = em.GaussianConditional().likelihood(*args)
    assert rel_err(got, want) <= REL
    assert float(em.bits(got.detach())) == pytest.approx(
        float(jax_em.bits(want)), rel=REL)
    torch.sum(torch.log(got)).backward()
    for a, g in zip(args, grads):
        assert rel_err(a.grad, g) <= GRAD_REL


def test_reset_parameters_is_jax_init():
    """The deterministic half of the factorized prior's initialisation is
    JAX's exactly; the biases are U(−½, ½)."""
    want = jax_em.FactorizedPrior(channels=C).init(
        jax.random.key(0), jnp.zeros((1, 1, 1, C)))["params"]
    port = em.FactorizedPrior(C)
    port.reset_parameters(torch.Generator().manual_seed(0))
    for name, p in port.named_parameters():
        if name.startswith("bias"):
            assert p.shape == want[name].shape
            assert float(p.min()) >= -0.5 and float(p.max()) < 0.5
        else:
            np.testing.assert_array_equal(p.detach().numpy(), want[name])


@pytest.mark.parametrize("output_stride", [2, 4])
def test_shuffle_conditioning_head_matches_jax(output_stride):
    cfg = dict(latent_factor=16, feature_channels=8, token_dim=16,
               hidden_channels=24, output_stride=output_stride,
               upsample="shuffle")
    y = np.random.default_rng(4).normal(size=(2, 3, 5, 12)).astype(
        np.float32)
    head = JaxCondHead(JaxCondConfig(**cfg), policy=JAX_F32)
    params = head.init(jax.random.key(1), y)
    want_f, want_t = head.apply(params, y)
    port = ConditioningHead(ConditioningConfig(**cfg), 12, F32_POLICY)
    state, unused = params_from_jax(flat_params(params))
    assert not unused
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got_f, got_t = port(torch.from_numpy(y))
    assert got_f.shape == want_f.shape
    assert rel_err(got_f, want_f) <= 1e-5 and rel_err(got_t, want_t) <= 1e-5
    # The shuffle stage is not the repeat stage on the same weights.
    rep = ConditioningHead(dataclasses.replace(
        ConditioningConfig(**cfg), upsample="repeat"), 12, F32_POLICY)
    assert rep.up0.weight.shape[0] * 4 == port.up0.weight.shape[0]
