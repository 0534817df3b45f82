"""The training loss and its gradients against the JAX package.

On the tiny preset in f32, with one set of weights on both sides and JAX's
draws injected: ``pipelines.train.loss_fn``'s loss and metrics against
``tpucdc.pipelines.train.loss_fn`` within 1e-5 relative (the LPIPS term
1e-4, the bound tests/test_torch_eval_metrics.py holds the proxy to: it is a
small difference of two feature maps, which magnifies the 1e-6 differences of
x₀), and every parameter's gradient against ``jax.grad``'s:

    ‖g_port − g_jax‖ ≤ 1e-4 · ‖g_jax‖ + 1e-7

per parameter, in the 2-norm. The cases cover the three distortions, the
three prediction modes, the synthesis split with ``diff_weight``, a model
without synthesis, variable-rate ``rd_lambdas`` indexed by the drawn
quality, a context model, conditioning dropout, the t-low bias and the
LPIPS term on the clipped x₀.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpucdc.eval.lpips import PerceptualMetric as JaxPerceptualMetric
from tpucdc.pipelines.train import loss_fn as jax_loss_fn
from tpucdc.pipelines.train import schedule_tables as jax_schedule_tables

from tests._torch_jax_helpers import (flat_params, jax_forward_draws,
                                      one_torch_thread_per_module,  # noqa: F401
                                      port_init_pair, tiny_config,
                                      with_gain_ladder)
from tpucdc_torch.eval.lpips import PerceptualMetric
from tpucdc_torch.pipelines.train import loss_fn, schedule_tables
from tpucdc_torch.utils import params_from_jax

REL = 1e-5
METRIC_REL = {"lpips_term": 1e-4}
GRAD_REL, GRAD_ABS = 1e-4, 1e-7

# name: (context, prediction, synthesis, qualities, loss_fn keywords)
CASES = {
    # The flagship recipe's shape: residual refiner, "both", LPIPS, t-low.
    "recipe": ("hyperprior", "residual", True, 1,
               dict(distortion="both", lpips_weight=0.5, diff_weight=0.7)),
    # ε-prediction without synthesis: no x̄, λ on the diffusion term.
    "eps": ("hyperprior", "eps", False, 1, dict(distortion="eps")),
    # x0-prediction, variable rate with a λ per drawn quality, a context.
    "vr_x0": ("checkerboard", "x0", True, 3,
              dict(distortion="x0", rd_lambdas=(2.0, 8.0, 32.0))),
}


def _config(context, prediction, synthesis, nq):
    cfg = tiny_config(context=context, num_qualities=nq)
    codec = dataclasses.replace(cfg.model.codec, synthesis=synthesis)
    model = dataclasses.replace(cfg.model, codec=codec, prediction=prediction,
                                cond_dropout_prob=0.5, t_low_frac=0.35,
                                t_low_prob=0.5)
    return dataclasses.replace(cfg, model=model)


@pytest.fixture(scope="module")
def results():
    """Per case: JAX's (loss, metrics, grads) and the port's, on demand."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        context, prediction, synthesis, nq, kw = CASES[name]
        cfg = _config(context, prediction, synthesis, nq)
        jm, params, tm = port_init_pair(cfg, seed=len(cache) + 3)
        if nq > 1:
            params = with_gain_ladder(params, cfg.model.codec.latent_channels)
            for n in ("gains", "inv_gains"):
                getattr(tm, n).data.copy_(torch.from_numpy(
                    np.array(params["params"][n])))
        batch = np.random.default_rng(len(cache)).uniform(
            -1, 1, (4, 64, 64, 3)).astype(np.float32)
        rng = jax.random.key(21)
        tables = jax_schedule_tables(cfg)
        jkw = dict(kw)
        tkw = dict(kw)
        if kw.get("lpips_weight"):
            jkw["lpips_fn"] = JaxPerceptualMetric().distance
            tkw["lpips_fn"] = PerceptualMetric(device="cpu").distance
        grads, jmetrics = jax.jit(jax.grad(
            lambda p: jax_loss_fn(jm, p, batch, rng, tables, 4.0, **jkw),
            has_aux=True))(params)
        draws = jax_forward_draws(cfg.model, rng, batch.shape,
                                  cfg.model.schedule.num_steps)
        loss, metrics = loss_fn(tm, torch.from_numpy(batch),
                                schedule_tables(cfg, "cpu"), 4.0, draws=draws,
                                **tkw)
        loss.backward()
        jgrads, _ = params_from_jax(flat_params(grads))
        cache[name] = (jmetrics, jgrads, loss, metrics,
                       dict(tm.named_parameters()))
        return cache[name]
    return get


@pytest.mark.parametrize("name", CASES)
def test_loss_and_metrics_match_jax(results, name):
    jmetrics, _, loss, metrics, _ = results(name)
    assert set(metrics) == set(jmetrics)
    assert float(loss.detach()) == pytest.approx(float(jmetrics["loss"]),
                                                 rel=REL)
    for key, value in jmetrics.items():
        assert float(metrics[key].detach()) == pytest.approx(
            float(value), rel=METRIC_REL.get(key, REL), abs=1e-9), key
    if CASES[name][4].get("lpips_weight"):
        assert float(metrics["lpips_term"].detach()) > 0
    assert ("mse_gs" in metrics) == CASES[name][2]


@pytest.mark.parametrize("name", CASES)
def test_gradients_match_jax(results, name):
    _, jgrads, _, _, params = results(name)
    assert set(jgrads) == set(params)
    worst, nonzero = [], 0
    for key, want in jgrads.items():
        got = params[key].grad
        assert got is not None, key
        want = want.numpy().astype(np.float64)
        err = np.linalg.norm(got.numpy() - want)
        norm = np.linalg.norm(want)
        nonzero += norm > 0
        worst.append((err / (GRAD_REL * norm + GRAD_ABS), key, err, norm))
    ratio, key, err, norm = max(worst)
    assert ratio <= 1.0, (key, err, norm)
    # The loss reaches nearly every parameter (the unused heads of other
    # context kinds do not exist here).
    assert nonzero >= 0.9 * len(jgrads)


def test_unknown_distortion_raises():
    cfg = _config("hyperprior", "residual", True, 1)
    _, _, tm = port_init_pair(cfg, seed=1)
    with pytest.raises(ValueError, match="distortion"):
        loss_fn(tm, torch.zeros((1, 64, 64, 3)), schedule_tables(cfg, "cpu"),
                1.0, distortion="nope")
