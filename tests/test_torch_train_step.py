"""The optimizer, one train step and the training initialisation against the
JAX package.

* ``lr_schedule`` equals optax's ``warmup_cosine_decay_schedule`` at steps
  0, warmup−1, warmup, warmup+1 and ``steps`` (and with no warmup).
* ``make_optimizer`` against optax's ``multi_transform`` given the same
  gradients: the parameters after three updates within 1e-6 relative per
  parameter (2-norm), with the clip engaged, weight decay on, and the
  quantiles on their own Adam.
* One train step from one set of weights with JAX's draws against JAX's
  ``make_train_step``: the metrics within 1e-5 relative (the LPIPS term
  1e-4, as in test_torch_train_loss.py), the parameters and the EMA within
  2e-2·lr·√n + 1e-7 per parameter in the 2-norm, n its size. The first Adam
  update is lr·g/(|g|+ε) elementwise: where a gradient is zero up to
  rounding (a bias just before a GroupNorm of one channel per group, as in
  the conditioning head's last stages), that ratio turns rounding noise into
  up to 2·10⁻² lr (measured: 1.8·10⁻² lr at most, 9·10⁻³ lr·√n in the norm);
  a wrong rate, sign, clip or decay moves a parameter by about lr per value,
  50 times the bound.
* ``init_weights`` against flax's ``init_model``: every leaf that does not
  depend on the key equals JAX's exactly; every random leaf has JAX's shape
  and a standard deviation within 10 % of JAX's (leaves of 512 or more
  values one by one; the smaller ones pooled, as the ratio of the two
  standard deviations averaged over them, since a few dozen draws do not pin
  a standard deviation to 10 %).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpucdc.pipelines import train as jax_train
from tpucdc.runtime import make_mesh

from tests._torch_jax_helpers import (flat_params, jax_forward_draws,
                                      jax_init_f32, jax_tree,
                                      one_torch_thread_per_module,  # noqa: F401
                                      port_init_pair, tiny_config,
                                      to_torch_config)
from tpucdc_torch.model import CDCModel
from tpucdc_torch.pipelines import train
from tpucdc_torch.utils import init_weights, params_from_jax, params_to_jax


def _train_config(**train_kw):
    cfg = tiny_config()
    model = dataclasses.replace(cfg.model, cond_dropout_prob=0.5,
                                t_low_frac=0.35, t_low_prob=0.5)
    return dataclasses.replace(cfg, model=model, train=dataclasses.replace(
        cfg.train, **train_kw))


@pytest.mark.parametrize("warmup", [0, 10])
def test_lr_schedule_matches_optax(warmup):
    cfg = _train_config(lr=3e-4, warmup_steps=warmup, steps=50)
    want = optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, warmup, max(50, warmup + 1), end_value=3e-4 * 0.05)
    got = train.lr_schedule(cfg)
    for step in sorted({0, max(warmup - 1, 0), warmup, warmup + 1, 25, 50,
                        60}):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-12), step


def test_optimizer_matches_optax():
    cfg = _train_config(lr=1e-2, warmup_steps=1, steps=10, grad_clip=2.0,
                        weight_decay=0.05, aux_lr=3e-2)
    _, params, tm = port_init_pair(cfg, seed=5)
    jopt = jax_train.make_optimizer(cfg)
    jstate = jopt.init(params)
    opt = train.make_optimizer(cfg, tm)
    rng = np.random.default_rng(5)
    update = jax.jit(lambda g, s, p: jopt.update(g, s, p))
    for scale in (0.01, 0.2, 0.05):     # the clip engages in the second step
        grads = {n: torch.from_numpy((scale * rng.standard_normal(
            p.shape)).astype(np.float32)) for n, p in tm.named_parameters()}
        jgrads = jax_tree(grads, params)
        upd, jstate = update(jgrads, jstate, params)
        params = optax.apply_updates(params, upd)
        for n, p in tm.named_parameters():
            p.grad = grads[n].clone()
        opt.step()
    want, _ = params_from_jax(flat_params(params))
    for n, p in tm.named_parameters():
        err = np.linalg.norm(p.detach().numpy() - want[n].numpy())
        assert err <= 1e-6 * np.linalg.norm(want[n].numpy()) + 1e-9, n
    assert opt.count == 3


@pytest.fixture(scope="module")
def one_step():
    """JAX's state after one step and the port's, from one set of weights
    with JAX's draws; the recipe's distortion, LPIPS and t-low bias, the
    clip engaged, weight decay on."""
    cfg = _train_config(lr=1e-3, warmup_steps=0, steps=100, grad_clip=0.5,
                        weight_decay=0.01, distortion="both",
                        lpips_weight=0.5, rd_lambda=4.0)
    jm, params, tm = port_init_pair(cfg, seed=6)
    tables = jax_train.schedule_tables(cfg)
    mesh = make_mesh(n_data=1)
    step_fn = jax_train.make_train_step(jm, cfg, mesh, tables)
    jopt = jax_train.make_optimizer(cfg)
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        ema_params=jax.tree.map(jnp.copy, params),
        opt_state=jopt.init(params))
    batch = np.random.default_rng(6).integers(0, 256, (4, 64, 64, 3),
                                              dtype=np.uint8)
    rng = jax.random.key(13)
    jstate, jmetrics = step_fn(jstate, batch, rng, jnp.float32(4.0))
    state = train.state_from_model(cfg, tm)
    port_step = train.make_train_step(cfg, train.schedule_tables(cfg, "cpu"))
    draws = jax_forward_draws(cfg.model, rng, batch.shape,
                              cfg.model.schedule.num_steps)
    metrics = port_step(state, torch.from_numpy(batch), draws=draws)
    return cfg, jstate, jmetrics, state, metrics


def test_one_train_step_metrics_match_jax(one_step):
    _, _, jmetrics, state, metrics = one_step
    assert state.step == 1 and state.opt.count == 1
    assert set(metrics) == set(jmetrics)
    for key, value in jmetrics.items():
        rel = 1e-4 if key == "lpips_term" else 1e-5
        assert float(metrics[key]) == pytest.approx(float(value), rel=rel), key
    assert float(metrics["grad_norm"]) > 0.5      # the clip engaged


def test_one_train_step_params_and_ema_match_jax(one_step):
    cfg, jstate, _, state, _ = one_step
    lr = cfg.train.lr
    want, _ = params_from_jax(flat_params(jstate.params))
    want_ema, _ = params_from_jax(flat_params(jstate.ema_params))
    moved = 0
    for n, p in state.model.named_parameters():
        bound = 2e-2 * lr * np.sqrt(p.numel()) + 1e-7
        got = p.detach().numpy()
        assert np.linalg.norm(got - want[n].numpy()) <= bound, n
        assert np.linalg.norm(state.ema_params[n].numpy()
                              - want_ema[n].numpy()) <= bound, n
        moved += not np.array_equal(got, state.ema_params[n].numpy())
    # EMA decay at step 0 is min(0.9999, 1/10): it moved with the params.
    assert moved > 0


def test_init_weights_matches_flax_init():
    cfg = tiny_config(context="space-channel", num_qualities=3)
    model, first = jax_init_f32(cfg.model, jax.random.key(0))
    _, second = jax_init_f32(cfg.model, jax.random.key(1))
    port = CDCModel(to_torch_config(cfg).model)
    init_weights(port, torch.Generator().manual_seed(0))
    got = params_to_jax(port.state_dict())
    a, b = flat_params(first), flat_params(second)
    assert set(got) == set(a)
    ratios_small, n_random = [], 0
    for key, want in a.items():
        assert got[key].shape == want.shape, key
        if np.array_equal(want, b[key]):          # independent of the key
            np.testing.assert_array_equal(got[key], want, err_msg=key)
            continue
        n_random += 1
        ratio = np.std(got[key]) / np.std(want)
        if want.size >= 512:
            assert abs(ratio - 1) <= 0.1, (key, ratio)
        else:
            ratios_small.append(ratio)
    assert n_random > 20 and ratios_small
    assert abs(np.mean(ratios_small) - 1) <= 0.1, ratios_small
    # The UNet's output convolution starts at zero, as flax's.
    assert not port.unet.conv_out.weight.any()

