"""Data-parallel training with the ``"tensor"`` state sharding, on gloo ranks
on the CPU, against one process and against the JAX package's step on a
2-device mesh.

* ``CDCModel.training_draws`` makes ``forward``'s own draws, bit for bit:
  the same outputs from one seed, and the generator left where ``forward``
  leaves it, for every context and for 1 and 3 gain rows.
* Two ranks at global batch 4 against one process at batch 4 (the tiny
  preset, the recipe's distortion, LPIPS term, conditioning dropout and
  t-low bias): the first step's loss and metrics within 1e-5 relative and
  every gradient within ‖Δg‖ ≤ 1e-4·‖g‖ + 1e-7 (PERF.md §2's tiny bound);
  after 3 steps of ``fit`` at lr 1e-3 the parameters within 2e-3 and the
  metrics within rtol 2e-3 / atol 2e-4 (tests/integration/
  test_tensor_parallel.py's bound for the same kind of comparison: AdamW
  moves a weight by about lr a step whatever the gradient, so a gradient
  near zero whose sign the sum order flips costs up to one step).
* The same two ranks against JAX's ``make_train_step`` over
  ``make_mesh(n_data=2)`` from one set of weights (``port_init_pair``) with
  JAX's draws of the global batch, which each rank slices: metrics within
  1e-5 (the LPIPS term 1e-4); the ranks' averaged gradients against
  ``jax.grad`` of the global batch's loss, which is what the mesh step
  differentiates, at the tiny bound.
* ``param_sharding="tensor"`` on a (data 1 × model 2) mesh, and on 4 ranks
  as (data 2 × model 2), against the replicated run at
  test_tensor_parallel.py's bounds; each rank's EMA and
  moments hold half of every shardable leaf; the checkpoint, written by
  rank 0 from the gathered state, restores into a replicated state that
  ``fit`` continues, and ``api.load_runtime`` serves its EMA weights.
* A global batch the data axis does not divide raises ValueError; a world
  of one is bit-equal to ``fit(mesh=None)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucdc.eval.lpips import PerceptualMetric as JaxPerceptualMetric
from tpucdc.pipelines import train as jax_train
from tpucdc.runtime import make_mesh as jax_make_mesh

from tests._torch_jax_helpers import (CONTEXTS, flat_params,
                                      jax_forward_draws,
                                      one_torch_thread_per_module,  # noqa: F401
                                      port_init_pair, run_ranks, tiny_config,
                                      to_torch_config)
from tpucdc_torch import api
from tpucdc_torch.data import train_crop_iterator
from tpucdc_torch.model import CDCModel
from tpucdc_torch.pipelines import train
from tpucdc_torch.runtime import make_mesh, prng
from tpucdc_torch.utils import init_weights, params_from_jax
from tpucdc_torch.utils.checkpoint import CheckpointManager

IMAGES = [np.random.default_rng(i).integers(0, 256, (80, 96, 3),
                                            dtype=np.uint8) for i in range(3)]
FIT = {"train.batch_size": 4, "train.crop_size": 64, "train.warmup_steps": 1,
       "train.lr": 1e-3, "train.log_every": 1, "train.steps": 8,
       "train.checkpoint_every": 3}


def _step_config():
    """The recipe's shape on the tiny model, as test_torch_train_step.py."""
    cfg = tiny_config()
    model = dataclasses.replace(cfg.model, cond_dropout_prob=0.5,
                                t_low_frac=0.35, t_low_prob=0.5)
    return dataclasses.replace(cfg, model=model, train=dataclasses.replace(
        cfg.train, lr=1e-3, warmup_steps=0, steps=100, grad_clip=0.5,
        weight_decay=0.01, distortion="both", lpips_weight=0.5,
        rd_lambda=4.0))


@pytest.mark.parametrize("num_qualities", [1, 3])
@pytest.mark.parametrize("context", CONTEXTS)
def test_training_draws_equal_forward_draws(context, num_qualities):
    cfg = dataclasses.replace(_step_config(), model=dataclasses.replace(
        _step_config().model, codec=dataclasses.replace(
            _step_config().model.codec, context=context,
            num_qualities=num_qualities)))
    model = CDCModel(to_torch_config(cfg).model)
    init_weights(model, torch.Generator().manual_seed(0))
    tables = train.schedule_tables(to_torch_config(cfg), "cpu")
    x = torch.rand((2, 64, 128, 3), generator=torch.Generator().manual_seed(
        1)) * 2 - 1
    g_own, g_made = (torch.Generator().manual_seed(7) for _ in range(2))
    with torch.no_grad():
        own = model(x, tables, generator=g_own)
        draws = model.training_draws(x.shape, tables["sqrt_ab"].shape[0],
                                     generator=g_made)
        made = model(x, tables, draws=draws)
    assert set(draws) == ({"u_z", "u_y", "keep", "t", "eps"}
                          | ({"quality"} if num_qualities > 1 else set()))
    for key, value in own.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, made[key]), key
    assert torch.equal(torch.rand(4, generator=g_own),
                       torch.rand(4, generator=g_made))


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _assert_grads_close(got: dict, want: dict):
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[name], np.float64)
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-7, name


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process references, JAX's mesh step, and every two-rank run
    (one spawn)."""
    tmp = tmp_path_factory.mktemp("dist_train")
    cfg = _step_config()
    tcfg = to_torch_config(cfg)
    jm, params, tm = port_init_pair(cfg, seed=6)
    batch = np.random.default_rng(6).integers(0, 256, (4, 64, 64, 3),
                                              dtype=np.uint8)
    rng = jax.random.key(13)
    num_t = cfg.model.schedule.num_steps
    jdraws = jax_forward_draws(cfg.model, rng, batch.shape, num_t)
    ref = {}
    # JAX: the step over a 2-device mesh, and the global batch's gradient.
    tables = jax_train.schedule_tables(cfg)
    jopt = jax_train.make_optimizer(cfg)
    # The step donates its state: it gets copies.
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.copy, params),
        ema_params=jax.tree.map(jnp.copy, params),
        opt_state=jopt.init(params))
    step_fn = jax_train.make_train_step(jm, cfg, jax_make_mesh(n_data=2),
                                        tables)
    _, jmetrics = step_fn(jstate, batch, rng, jnp.float32(cfg.train.rd_lambda))
    ref["jax_metrics"] = {k: float(v) for k, v in jmetrics.items()}
    tc = cfg.train
    lpips = JaxPerceptualMetric().distance
    xb = jnp.asarray(batch, jnp.float32) * (1.0 / 127.5) - 1.0
    jgrads, _ = jax.jit(jax.grad(lambda p: jax_train.loss_fn(
        jm, p, xb, rng, tables, tc.rd_lambda, distortion=tc.distortion,
        rd_lambdas=tc.rd_lambdas, diff_weight=tc.diff_weight,
        lpips_weight=tc.lpips_weight, lpips_fn=lpips), has_aux=True))(params)
    ref["jax_grads"] = params_from_jax(flat_params(jgrads))[0]
    # One process at batch 4: a step with the port's own draws.
    init = {n: p.detach().clone() for n, p in tm.state_dict().items()}
    state = train.state_from_model(tcfg, tm)
    port_step = train.make_train_step(tcfg, train.schedule_tables(tcfg,
                                                                  "cpu"))
    ref["own_metrics"] = port_step(state, torch.from_numpy(batch),
                                   generator=prng.generator(1, 0))
    ref["own_grads"] = _grads(tm)
    # One process: fit, 3 steps, replicated.
    fcfg = api.build_config("tiny", FIT)
    rows = []
    _, fstate = train.fit(fcfg, train_crop_iterator(IMAGES, 4, 64,
                                                    as_uint8=True),
                          num_steps=3, device="cpu",
                          writer=lambda s, m: rows.append(m))
    ref["fit"] = (fstate, rows)
    inputs = {"cfg": tcfg, "init": init, "batch": batch,
              "jax_draws": jdraws, "fit_cfg": fcfg, "images": IMAGES,
              "ckpt": str(tmp / "ckpt")}
    two = run_ranks(tmp, _CHILD, inputs)
    return cfg, fcfg, ref, two, tmp / "ckpt"


_CHILD = """
import dataclasses
from tpucdc_torch.data import train_crop_iterator
from tpucdc_torch.model import CDCModel
from tpucdc_torch.pipelines import train
from tpucdc_torch.runtime import F32_POLICY, make_mesh, prng, set_policy
from tpucdc_torch.utils.checkpoint import CheckpointManager

data_mesh = make_mesh(n_data=2, device="cpu")
model_mesh = make_mesh(n_data=1, n_model=2, device="cpu")
cfg = inp["cfg"]
lo, hi = 2 * rank, 2 * rank + 2
batch = torch.from_numpy(inp["batch"][lo:hi])
for tag, kw in (("jax", {"draws": inp["jax_draws"]}),
                ("own", {"generator": prng.generator(1, 0)})):
    model = CDCModel(cfg.model)
    model.load_state_dict(inp["init"])
    set_policy(model, F32_POLICY)
    state = train.state_from_model(cfg, model)
    step = train.make_train_step(cfg, train.schedule_tables(cfg, "cpu"),
                                 data_mesh)
    out[tag + "_metrics"] = step(state, batch, **kw)
    out[tag + "_grads"] = {n: p.grad.clone()
                           for n, p in model.named_parameters()}
fcfg = inp["fit_cfg"]


def data():
    return train_crop_iterator(inp["images"], 4, 64, as_uint8=True)


rows = []
_, st = train.fit(fcfg, data(), mesh=data_mesh, num_steps=3, device="cpu",
                  writer=lambda s, m: rows.append(m))
out["fit"] = ({n: p.detach() for n, p in st.model.named_parameters()}, rows)
tcfg = dataclasses.replace(fcfg, train=dataclasses.replace(
    fcfg.train, param_sharding="tensor"))
mngr = CheckpointManager(inp["ckpt"]) if rank == 0 else None
rows = []
_, st = train.fit(tcfg, data(), mesh=model_mesh, num_steps=3, device="cpu",
                  writer=lambda s, m: rows.append(m),
                  checkpointer=lambda s, full: mngr.save(s, full))
if mngr is not None:
    mngr.close()
out["tensor"] = ({n: p.detach() for n, p in st.model.named_parameters()},
                 rows,
                 {n: tuple(e.shape) for n, e in st.ema_params.items()},
                 {n: tuple(m.shape) for n, m in zip(st.opt.names, st.opt.mu)},
                 st.plan.dims)
try:
    bad = dataclasses.replace(fcfg, train=dataclasses.replace(
        fcfg.train, batch_size=3))
    train.fit(bad, train_crop_iterator(inp["images"], 3, 64), mesh=data_mesh,
              num_steps=1, device="cpu")
except ValueError as e:
    out["ragged"] = str(e)
"""


def test_two_ranks_first_step_matches_one_process(runs):
    _, _, ref, two, _ = runs
    for rank_out in two:
        for key, want in ref["own_metrics"].items():
            assert float(rank_out["own_metrics"][key]) == pytest.approx(
                float(want), rel=1e-5), key
        _assert_grads_close(rank_out["own_grads"], ref["own_grads"])


def test_two_ranks_match_jax_mesh_step(runs):
    _, _, ref, two, _ = runs
    for rank_out in two:
        got = rank_out["jax_metrics"]
        assert set(got) == set(ref["jax_metrics"])
        for key, want in ref["jax_metrics"].items():
            rel = 1e-4 if key == "lpips_term" else 1e-5
            assert float(got[key]) == pytest.approx(want, rel=rel), key
        _assert_grads_close(rank_out["jax_grads"], ref["jax_grads"])


def _assert_fit_close(params, rows, fstate, want_rows, rank):
    # The writer runs on rank 0 alone.
    assert len(rows) == (3 if rank == 0 else 0) and len(want_rows) == 3
    for got, want in zip(rows, want_rows):
        for key in ("loss", "bpp", "mse_eps", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=2e-3,
                                       atol=2e-4, err_msg=key)
    worst = max(float((params[n] - p.detach()).abs().max())
                for n, p in fstate.model.named_parameters())
    assert worst < 2e-3, worst


def test_two_ranks_three_steps_match_one_process(runs):
    _, _, ref, two, _ = runs
    fstate, want_rows = ref["fit"]
    for rank, rank_out in enumerate(two):
        _assert_fit_close(*rank_out["fit"], fstate, want_rows, rank)


def test_tensor_sharding_matches_replicated(runs):
    _, _, ref, two, _ = runs
    fstate, want_rows = ref["fit"]
    for rank, rank_out in enumerate(two):
        params, rows = rank_out["tensor"][:2]
        _assert_fit_close(params, rows, fstate, want_rows, rank)


def test_tensor_state_holds_half_of_every_shardable_leaf(runs):
    _, _, ref, two, _ = runs
    full = {n: tuple(p.shape) for n, p in
            ref["fit"][0].model.named_parameters()}
    for rank_out in two:
        ema, mu, dims = rank_out["tensor"][2:]
        sharded = [n for n, d in dims.items() if d is not None]
        assert len(sharded) > 20
        for name, shape in full.items():
            dim = dims[name]
            want = list(shape)
            if dim is not None:
                want[dim] //= 2
            assert ema[name] == mu[name] == tuple(want), name


def test_tensor_checkpoint_restores_replicated_and_serves(runs):
    _, fcfg, ref, two, ckpt = runs
    fstate = ref["fit"][0]
    mngr = CheckpointManager(ckpt)
    assert mngr.steps() == [3]
    saved = mngr.read()
    _, state = train.create_state(fcfg, seed=123, device="cpu")
    mngr.restore(state)
    assert state.step == 3 and state.opt.count == 3
    for n, p in state.model.named_parameters():
        want = fstate.model.get_parameter(n).detach()
        assert float((p.detach() - want).abs().max()) < 2e-3, n
        assert torch.equal(p, two[0]["tensor"][0][n]), n
        assert state.ema_params[n].shape == p.shape
        assert float((state.ema_params[n]
                      - fstate.ema_params[n]).abs().max()) < 2e-3, n
    _, cont = train.fit(fcfg, train_crop_iterator(IMAGES, 4, 64,
                                                  as_uint8=True, start=3),
                        start_state=state, num_steps=1, device="cpu")
    assert cont.step == 4
    rt = api.load_runtime("tiny", checkpoint=str(ckpt), overrides=FIT,
                          device="cpu")
    for n, p in rt.model.named_parameters():
        assert torch.equal(p, saved["ema_params"][n]), n


def test_batch_the_data_axis_does_not_divide_raises(runs):
    assert "batch 3 not divisible by data axis 2" in runs[3][0]["ragged"]


def test_world_of_one_is_bit_equal_to_one_card():
    cfg = api.build_config("tiny", {**FIT, "train.batch_size": 2,
                                    "train.steps_per_dispatch": 2})
    states = []
    for mesh in (None, make_mesh(device="cpu")):
        _, st = train.fit(cfg, train_crop_iterator(IMAGES, 2, 64,
                                                   as_uint8=True),
                          mesh=mesh, num_steps=2, device="cpu")
        states.append(st)
    a, b = states
    for n, p in a.model.named_parameters():
        assert torch.equal(p, b.model.get_parameter(n)), n
        assert torch.equal(a.ema_params[n], b.ema_params[n]), n


_CHILD_2X2 = """
import dataclasses
from tpucdc_torch.data import train_crop_iterator
from tpucdc_torch.pipelines import train
from tpucdc_torch.runtime import make_mesh

mesh = make_mesh(n_data=2, n_model=2, device="cpu")
fcfg = inp["fit_cfg"]
tcfg = dataclasses.replace(fcfg, train=dataclasses.replace(
    fcfg.train, param_sharding="tensor"))
rows = []
_, st = train.fit(tcfg, train_crop_iterator(inp["images"], 4, 64,
                                            as_uint8=True),
                  mesh=mesh, num_steps=3, device="cpu",
                  writer=lambda s, m: rows.append(m))
out["tensor"] = ({n: p.detach() for n, p in st.model.named_parameters()},
                 rows, {n: tuple(e.shape) for n, e in st.ema_params.items()})
"""


def test_data_and_model_axes_together_match_replicated(runs, tmp_path):
    """test_tensor_parallel.py's layout on 4 ranks: data 2 × model 2 with
    the ``"tensor"`` state against one replicated process."""
    _, fcfg, ref, _, _ = runs
    fstate, want_rows = ref["fit"]
    outs = run_ranks(tmp_path, _CHILD_2X2, {"fit_cfg": fcfg,
                                            "images": IMAGES}, world=4)
    for rank, rank_out in enumerate(outs):
        params, rows, ema = rank_out["tensor"]
        _assert_fit_close(params, rows, fstate, want_rows, rank)
        assert sum(ema[n] != tuple(p.shape)
                   for n, p in fstate.model.named_parameters()) > 20
