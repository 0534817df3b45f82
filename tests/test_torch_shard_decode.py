"""The batched decode sharded over the data axis, and the tiled decode over
a mesh, on 1 rank (this process) against 2 gloo ranks, and against the JAX
package on a 2-device mesh.

* tests/integration/test_shard_decode.py's cases on the port: the toy
  model (2 ranks within 1e-5 of 1, and 1 rank within 1e-4 of JAX's with
  JAX's per-image ε), the ragged batch's ValueError, ``steps=0`` (needs
  ``x_ref_fn``; the per-image mean), and the real tiny ``CDCModel`` at η 0.5
  over the full chain and truncated at ``t_start=63``: equal arrays. Image
  i's ε is its own entry and the η > 0 step noise is drawn for the whole
  batch on every rank, so the split does not change a value; the CPU's
  convolutions gave the same bits at batch 4 and 8 here, so no tolerance
  is taken.
* ``CodecRuntime.decompress_tiled(mesh=)`` on the tiny runtime (F32_POLICY)
  over 2 ranks, with 3 tiles so that a fourth pads the batch, against JAX's
  ``decompress_tiled(mesh=make_mesh(n_data=2))`` with JAX's per-tile ε
  replayed (``split(fold_in(key, 1), n + pad)``, ``_rng_streams``, a normal
  per tile): ``steps=0`` within 1 LSB; the served steps within 2 LSB with
  99.9 % of pixels within 1 (PERF.md §2's served-decode bounds); 1 rank
  within 1 LSB of 2. The served steps with three gain rows at quality id 2
  too, which shows that the inverse gain goes first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucdc.data import synthetic_images
from tpucdc.ops import make_schedule as jax_make_schedule
from tpucdc.parallel.shard_decode import sharded_sample as jax_sharded_sample
from tpucdc.pipelines.codec_runtime import CodecRuntime as JaxRuntime
from tpucdc.runtime import make_mesh as jax_make_mesh
from tpucdc.sampling.ddim import _normal, _rng_streams

from tests._torch_jax_helpers import (one_torch_thread_per_module,  # noqa: F401
                                      port_init_pair, run_ranks,
                                      tiny_config, to_torch_config,
                                      torch_model, with_gain_ladder)
from tpucdc_torch import CodecRuntime, F32_POLICY
from tpucdc_torch.model import CDCModel
from tpucdc_torch.ops import make_schedule
from tpucdc_torch.parallel import sharded_sample
from tpucdc_torch.runtime import make_mesh, set_policy
from tpucdc_torch.utils import init_weights

TILE, HALO = 64, 32            # extent 128: a 250×120 image pads to 256×128
STEPS = 2


def _toy(params, y_shard, x_t, t):
    cond = torch.mean(y_shard, dim=(1, 2, 3), keepdim=True)
    return x_t * 0.9 + cond


def _toy_mean(params, y_shard):
    cond = torch.mean(y_shard, dim=(1, 2, 3), keepdim=True)
    return cond.expand(y_shard.shape[0], 16, 16, 3)


def _tiny_model():
    cfg = to_torch_config(tiny_config())
    model = CDCModel(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        rng = np.random.default_rng(0)
        for p in model.parameters():
            p.add_(0.05 * torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32)))
    set_policy(model, F32_POLICY)
    return cfg, model.eval()


def _model_apply(m, y_shard, x_t, t, x_bar=None):
    cond_f, cond_t = m.cond_signal(y_shard)
    return m.denoise(x_t, t, cond_f, cond_t, x_bar)


def _jax_tile_eps(n, pad, extent):
    """JAX's init ε of each tile in its mesh branch from key(0)."""
    rngs = jax.random.split(jax.random.fold_in(jax.random.key(0), 1),
                            n + pad)
    init = _rng_streams(rngs)[1]
    return torch.from_numpy(np.array(_normal(init, (n + pad, extent,
                                                    extent, 3))))[:n]


def _tiled_case(tmp, num_qualities):
    cfg = tiny_config(steps=STEPS, num_qualities=num_qualities)
    jm, params, _ = port_init_pair(cfg, seed=3)
    if num_qualities > 1:
        params = with_gain_ladder(params, cfg.model.codec.latent_channels)
    trt = CodecRuntime(to_torch_config(cfg), torch_model(cfg, params),
                       device="cpu", policy=F32_POLICY)
    tables = tmp / f"tables{num_qualities}.npz"
    trt.save_cdf_tables(tables)
    jrt = JaxRuntime(cfg, jm, params,
                     cdf_tables=JaxRuntime.load_cdf_tables(tables))
    img = synthetic_images(1, 256, 128, seed=5)[0][:250, :120]
    blob = (jrt.compress(img, quality_id=2) if num_qualities > 1
            else jrt.compress(img))
    # JAX compiles each mesh decode for ~12-17 s: the mean decode of the
    # gain rows is left to the port's own 1-rank against 2-rank check.
    want = {s: jrt.decompress_tiled(blob, tile=TILE, halo=HALO,
                                    mesh=jax_make_mesh(n_data=2), steps=s)
            for s in ((0, STEPS) if num_qualities == 1 else (STEPS,))}
    eps = _jax_tile_eps(3, 1, TILE + 2 * HALO)
    return trt, blob, eps, want, str(tables)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every input, JAX's outputs, and the port's on 1 rank (here) and on 2
    ranks (one spawn)."""
    tmp = tmp_path_factory.mktemp("shard_decode")
    rng = np.random.default_rng(0)
    mesh1 = make_mesh(device="cpu")
    inp, one = {"steps": STEPS, "tile": TILE, "halo": HALO}, {}
    # The toy model, η = 0, with JAX's per-image ε.
    y = rng.standard_normal((8, 4, 4, 6)).astype(np.float32)
    rngs = jax.random.split(jax.random.key(1), 8)
    x_init = jax.vmap(lambda k: jax.random.normal(k, (16, 16, 3)))(rngs)
    want_toy = np.asarray(jax_sharded_sample(
        lambda p, ys, x, t: x * 0.9 + jnp.mean(ys, axis=(1, 2, 3),
                                               keepdims=True),
        {}, jax_make_schedule("cosine", 64), jax_make_mesh(n_data=2),
        jnp.asarray(y), rngs, (16, 16), num_steps=4))
    inp["toy"] = (torch.from_numpy(y), torch.from_numpy(np.array(x_init)))
    sched64 = make_schedule("cosine", 64)
    one["toy"] = sharded_sample(_toy, None, sched64, mesh1, *inp["toy"],
                                (16, 16), num_steps=4)
    one["mean"] = sharded_sample(_toy, None, sched64, mesh1, *inp["toy"],
                                 (16, 16), num_steps=0, x_ref_fn=_toy_mean)
    # The real tiny model: η 0.5 over the full chain, and truncated.
    cfg, model = _tiny_model()
    inp["real"] = (torch.from_numpy(rng.standard_normal(
        (8, 4, 4, cfg.model.codec.latent_channels)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((8, 64, 64, 3)).astype(
            np.float32)))
    inp["model"] = (cfg, model.state_dict())
    sched = make_schedule(cfg.model.schedule.kind,
                          cfg.model.schedule.num_steps)
    with torch.inference_mode():
        for eta, t_start in ((0.5, None), (0.0, 63)):
            one[f"real_{eta}_{t_start}"] = sharded_sample(
                _model_apply, model, sched, mesh1, *inp["real"], (64, 64),
                num_steps=3, eta=eta, t_start=t_start,
                x_ref_fn=lambda m, ys: m.synthesize(ys),
                generator=torch.Generator().manual_seed(9))
    # The tiled decode, single-rate and at quality id 2 of three gain rows.
    tiled = {}
    for nq in (1, 3):
        trt, blob, eps, want, tables = _tiled_case(tmp, nq)
        tiled[nq] = (trt, want)
        inp[f"tiled{nq}"] = (trt.config, trt.model.state_dict(), tables,
                             blob, eps)
        for s in (0, STEPS):
            one[f"tiled{nq}_{s}"] = trt.decompress_tiled(
                blob, noise=eps, tile=TILE, halo=HALO, mesh=mesh1, steps=s)
    two = run_ranks(tmp, _CHILD, inp)
    return {"want_toy": want_toy, "one": one, "two": two, "tiled": tiled,
            "inp": inp}


_CHILD = """
from tpucdc_torch import CodecRuntime, F32_POLICY
from tpucdc_torch.model import CDCModel
from tpucdc_torch.ops import make_schedule
from tpucdc_torch.parallel import sharded_sample
from tpucdc_torch.runtime import make_mesh, set_policy

mesh = make_mesh(device="cpu")
assert tuple(mesh.mesh.shape) == (2, 1)


def toy(params, y_shard, x_t, t):
    return x_t * 0.9 + torch.mean(y_shard, dim=(1, 2, 3), keepdim=True)


def toy_mean(params, y_shard):
    cond = torch.mean(y_shard, dim=(1, 2, 3), keepdim=True)
    return cond.expand(y_shard.shape[0], 16, 16, 3)


def model_apply(m, y_shard, x_t, t, x_bar=None):
    cond_f, cond_t = m.cond_signal(y_shard)
    return m.denoise(x_t, t, cond_f, cond_t, x_bar)


sched64 = make_schedule("cosine", 64)
out["toy"] = sharded_sample(toy, None, sched64, mesh, *inp["toy"], (16, 16),
                            num_steps=4)
out["mean"] = sharded_sample(toy, None, sched64, mesh, *inp["toy"], (16, 16),
                             num_steps=0, x_ref_fn=toy_mean)
y, eps = inp["toy"]
try:
    sharded_sample(toy, None, sched64, mesh, y[:3], eps[:3], (16, 16))
except ValueError as e:
    out["ragged"] = str(e)
cfg, state = inp["model"]
model = CDCModel(cfg.model)
model.load_state_dict(state)
set_policy(model, F32_POLICY)
model.eval()
sched = make_schedule(cfg.model.schedule.kind, cfg.model.schedule.num_steps)
with torch.inference_mode():
    for eta, t_start in ((0.5, None), (0.0, 63)):
        out[f"real_{eta}_{t_start}"] = sharded_sample(
            model_apply, model, sched, mesh, *inp["real"], (64, 64),
            num_steps=3, eta=eta, t_start=t_start,
            x_ref_fn=lambda m, ys: m.synthesize(ys),
            generator=torch.Generator().manual_seed(9))
for nq in (1, 3):
    cfg, state, tables, blob, eps = inp[f"tiled{nq}"]
    model = CDCModel(cfg.model)
    model.load_state_dict(state)
    rt = CodecRuntime(cfg, model, device="cpu", policy=F32_POLICY,
                      cdf_tables=CodecRuntime.load_cdf_tables(tables))
    for s in (0, inp["steps"]):
        out[f"tiled{nq}_{s}"] = rt.decompress_tiled(
            blob, noise=eps, tile=inp["tile"], halo=inp["halo"], mesh=mesh,
            steps=s)
"""


def _lsb(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), float(np.mean(d <= 1))


def test_both_ranks_return_the_whole_batch(cases):
    a, b = cases["two"]
    assert set(a) == set(b)
    for key in a:
        if key != "ragged":
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)


def test_toy_model_two_ranks_match_one_and_jax(cases):
    one, two = cases["one"]["toy"], cases["two"][0]["toy"]
    assert one.shape == (8, 16, 16, 3)
    np.testing.assert_allclose(two.numpy(), one.numpy(), atol=1e-5)
    # Against JAX the f32 rounding of the first step is divided by
    # √ᾱ ≈ 0.02 at t = 63 of 64 (measured: 4.0e-5 at 6 of 6144 values).
    np.testing.assert_allclose(one.numpy(), cases["want_toy"], atol=1e-4)


def test_ragged_batch_raises(cases):
    assert "not divisible by data axis 2" in cases["two"][0]["ragged"]


def test_mean_decode_steps0(cases):
    y = cases["inp"]["toy"][0].numpy()
    want = np.broadcast_to(np.mean(y, axis=(1, 2, 3), keepdims=True),
                           (8, 16, 16, 3))
    one, two = cases["one"]["mean"], cases["two"][0]["mean"]
    np.testing.assert_allclose(two.numpy(), one.numpy(), atol=1e-6)
    np.testing.assert_allclose(one.numpy(), want, atol=1e-5)


def test_argument_errors():
    mesh = make_mesh(device="cpu")
    sched = make_schedule("cosine", 8)
    y, eps = torch.zeros((2, 2, 2, 3)), torch.zeros((2, 8, 8, 3))
    with pytest.raises(ValueError, match="mean decode"):
        sharded_sample(_toy, None, sched, mesh, y, eps, (8, 8), num_steps=0)
    with pytest.raises(ValueError, match="t_start needs x_ref_fn"):
        sharded_sample(_toy, None, sched, mesh, y, eps, (8, 8), t_start=4)


@pytest.mark.parametrize("key", ["real_0.5_None", "real_0.0_63"])
def test_real_model_pixel_identity(cases, key):
    one, two = cases["one"][key], cases["two"][0][key]
    assert one.shape == (8, 64, 64, 3)
    np.testing.assert_array_equal(two.numpy(), one.numpy())


@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("steps", [0, STEPS])
def test_tiled_decode_over_a_mesh_one_rank_against_two(cases, nq, steps):
    """The same tiles and ε on one rank (a batch of 3) and two (2 a rank,
    the last tile repeated): the CPU's convolutions at another batch size
    may round a value the other way, so 1 LSB (measured: 1 or 2 of 90000
    values of the refined decodes, none of the mean decodes)."""
    got = cases["two"][0][f"tiled{nq}_{steps}"]
    assert got.shape == (250, 120, 3) and got.dtype == np.uint8
    worst, within1 = _lsb(got, cases["one"][f"tiled{nq}_{steps}"])
    assert worst <= 1 and within1 == 1.0, worst


@pytest.mark.parametrize("nq,steps", [(1, 0), (1, STEPS), (3, STEPS)])
def test_tiled_decode_over_a_mesh_matches_jax(cases, nq, steps):
    want = cases["tiled"][nq][1][steps]
    got = cases["two"][0][f"tiled{nq}_{steps}"]
    assert got.shape == want.shape == (250, 120, 3)
    worst, within1 = _lsb(got, want)
    if steps == 0:
        assert worst <= 1, worst
    else:
        assert worst <= 2 and within1 >= 0.999, (worst, within1)


def test_tiled_decode_over_a_mesh_matches_one_card(cases):
    """One rank's mesh decode and the one-card decode, same ε: the mesh
    branch starts the chain as JAX's does and conditions on the gained-back
    tiles, which the one-card branch does inside its device stage."""
    trt = cases["tiled"][1][0]
    _, _, _, blob, eps = cases["inp"]["tiled1"]
    plain = trt.decompress_tiled(blob, noise=eps, tile=TILE, halo=HALO,
                                 steps=STEPS)
    worst, _ = _lsb(cases["one"][f"tiled1_{STEPS}"], plain)
    assert worst <= 1, worst


def test_eval_harness_passes_the_mesh(cases):
    """``EvalOptions.mesh`` reaches the tiled decode, as in JAX's harness."""
    from tpucdc_torch.eval import harness
    trt = cases["tiled"][1][0]
    img = synthetic_images(1, 256, 128, seed=5)[0][:250, :120]
    mesh = make_mesh(device="cpu")
    opts = harness.EvalOptions(steps=STEPS, tiled=True, tile=TILE, halo=HALO,
                               mesh=mesh, compute_lpips=False)
    row, recon = harness.evaluate_image(trt, img, opts, None)
    want = trt.decompress_tiled(trt.compress(img), tile=TILE, halo=HALO,
                                mesh=mesh, steps=STEPS,
                                generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(recon, want)
    assert row["psnr"] > 0 and row["steps"] == STEPS


def test_cli_eval_mesh_runs_the_tiled_decode_over_the_mesh(tmp_path, capsys,
                                                           monkeypatch):
    """``eval --mesh --tiled`` builds ``make_mesh(device=--device)`` (here a
    world of one) and evaluates, as JAX's CLI does."""
    import json

    from tpucdc_torch.cli.main import main
    from tpucdc_torch.data import datasets
    # One 320×320 image: one tile at the CLI's tile 256 and halo 32.
    monkeypatch.setitem(datasets._SPECS, "kodak",
                        ("TPUCDC_KODAK_DIR", [], 1, (320, 320)))
    monkeypatch.setenv("TPUCDC_KODAK_DIR", str(tmp_path / "absent"))
    main(["eval", "--preset", "tiny", "--steps", "1", "--no-lpips",
          "--device", "cpu", "--workdir", str(tmp_path), "--tiled", "--mesh"])
    agg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert agg["num_images"] == 1 and np.isfinite(agg["psnr"])
