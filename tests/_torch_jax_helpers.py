"""Shared set-up for the tests that hold tpucdc_torch against tpucdc.

Both packages get the same weights and inputs: JAX params are flattened to
the keystr dictionary that ``save_params_npz`` writes and carried across by
``tpucdc_torch.utils.params_from_jax``; inputs are made with numpy.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucdc.presets as jax_presets
from tpucdc import config as jax_config
from tpucdc.model import CDCModel as JaxCDCModel
from tpucdc.ops import make_schedule as jax_make_schedule
from tpucdc.runtime import F32_POLICY as JAX_F32
from tpucdc.utils.checkpoint import load_params_npz as jax_load_params_npz

from tpucdc_torch import config as torch_config
from tpucdc_torch.model import CDCModel
from tpucdc_torch.runtime import F32_POLICY, set_policy
from tpucdc_torch.utils import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP_NPZ = ROOT / "artifacts" / "flagship_params.npz"
FIXTURES = ROOT / "tpucdc_torch" / "fixtures"


def flat_params(params) -> dict:
    """The keystr → numpy dictionary ``save_params_npz`` would write."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in leaves}


def to_torch_config(cfg):
    """A tpucdc Config → the equivalent tpucdc_torch Config."""
    m = cfg.model
    model = torch_config.ModelConfig(
        codec=torch_config.CodecConfig(**dataclasses.asdict(m.codec)),
        cond=torch_config.ConditioningConfig(**dataclasses.asdict(m.cond)),
        unet=torch_config.UNetConfig(**dataclasses.asdict(m.unet)),
        schedule=torch_config.ScheduleConfig(**dataclasses.asdict(m.schedule)),
        cond_dropout_prob=m.cond_dropout_prob, prediction=m.prediction,
        t_low_frac=m.t_low_frac, t_low_prob=m.t_low_prob)
    return torch_config.Config(
        model=model,
        train=torch_config.TrainConfig(**dataclasses.asdict(cfg.train)),
        sample=torch_config.SampleConfig(**dataclasses.asdict(cfg.sample)))


def tiny_config(steps: int = 4, context: str = "hyperprior",
                num_qualities: int = 1):
    """The tiny preset with the flagship's serving shape: residual refiner,
    truncated chain, γ blend; any entropy model, any number of gain rows."""
    cfg = jax_presets.tiny()
    codec = dataclasses.replace(cfg.model.codec, context=context,
                                context_groups=4,
                                num_qualities=num_qualities)
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, codec=codec,
                                  prediction="residual"),
        sample=dataclasses.replace(cfg.sample, steps=steps,
                                   truncate_frac=0.15, blend_gamma=0.5))


def jax_init_f32(model_cfg, rng, image_size: int = 64):
    """``tpucdc.model.init_model`` under F32_POLICY: (model, params).
    ``model.init`` runs as one compiled program instead of op by op: the
    same arrays, several times faster in a fresh process."""
    model = JaxCDCModel(model_cfg.validated(), policy=JAX_F32)
    sched = jax_make_schedule(model_cfg.schedule.kind,
                              model_cfg.schedule.num_steps)
    tables = {"sqrt_ab": sched.sqrt_alpha_bars,
              "sqrt_1mab": sched.sqrt_one_minus_alpha_bars}
    x = jnp.zeros((1, image_size, image_size, 3), jnp.float32)
    return model, jax.jit(model.init)(rng, x, jax.random.key(0), tables)


def init_jax(cfg, seed: int = 0, perturb: float = 0.05):
    """F32 JAX model + params; ``perturb`` adds seeded noise to every leaf
    (the UNet's zero-initialized output conv would otherwise hide it)."""
    model, params = jax_init_f32(cfg.model, jax.random.key(seed))
    if perturb:
        rng = np.random.default_rng(seed)
        params = jax.tree.map(
            lambda p: p + perturb * rng.standard_normal(p.shape).astype(
                np.float32), params)
    return model, params


def with_gain_ladder(params, channels: int):
    """Gains 0.5, 1, 2 (times a per-channel jitter), inverse gains 1/gain:
    a ladder whose rate rises with quality, as a trained one does."""
    jitter = 1 + 0.1 * np.random.default_rng(7).random((3, channels))
    gains = (np.array([[0.5], [1.0], [2.0]]) * jitter).astype(np.float32)
    tree = dict(params["params"], gains=jnp.asarray(gains),
                inv_gains=jnp.asarray((1.0 / gains).astype(np.float32)))
    return {"params": tree}


@functools.lru_cache(maxsize=1)
def flagship_jax():
    """(config, F32 JAX model, params) of the served flagship."""
    import sys
    sys.path.insert(0, str(ROOT / "scripts"))
    # The script re-points JAX's compile cache when imported; keep the
    # test session's setting.
    cache_dir = jax.config.jax_compilation_cache_dir
    from train_rd_sweep import build_eval_config
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    spec = json.loads((ROOT / "artifacts" / "flagship.json").read_text())
    cfg = build_eval_config(True, spec["unet"], spec["prediction"])
    serving = spec["serving"]
    cfg = dataclasses.replace(cfg, sample=dataclasses.replace(
        cfg.sample, steps=int(serving["steps"]),
        truncate_frac=float(serving["truncate_frac"]),
        blend_gamma=float(serving["gamma"])))
    model = JaxCDCModel(cfg.model.validated(), policy=JAX_F32)
    sched = jax_make_schedule(cfg.model.schedule.kind,
                              cfg.model.schedule.num_steps)
    tables = {"sqrt_ab": sched.sqrt_alpha_bars,
              "sqrt_1mab": sched.sqrt_one_minus_alpha_bars}
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    abstract = jax.eval_shape(
        lambda: model.init(jax.random.key(0), x, jax.random.key(0), tables))
    return cfg, model, jax_load_params_npz(FLAGSHIP_NPZ, abstract)


def torch_model(cfg, params) -> CDCModel:
    """The port's F32 model on the CPU carrying the same weights."""
    model = CDCModel(to_torch_config(cfg).model)
    state, _ = params_from_jax(flat_params(params))
    model.load_state_dict(state, strict=True)
    set_policy(model, F32_POLICY)
    return model.eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def maxdiff(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


# ---- coding comparisons shared by the encode and the variable-rate tests ----

CONTEXTS = ("hyperprior", "checkerboard", "channel-ar", "space-channel")
# Streams in a bitstream: z, then 1, 2, G or 2·G passes over y (G = 4).
N_STREAMS = {"hyperprior": 2, "checkerboard": 3, "channel-ar": 5,
             "space-channel": 9}
MAX_DIFF_FRACTION = 0.005


def symbols(trt, blob):
    """(z symbols, y symbols) the port decodes from ``blob``, as numpy."""
    _, z_sym, _, _ = trt._host_z_stage(blob)
    _, y_sym, _, _ = trt._decode_symbols(blob)
    return z_sym, y_sym.numpy()


def encoder_symbols(trt, img, quality=0):
    """(z, y) symbols the port's encoder codes for ``img``, from the stages
    ``compress`` runs."""
    from tpucdc_torch.pipelines.codec_runtime import pad_image, to_model_range
    x = torch.from_numpy(to_model_range(pad_image(img)[0]))[None]
    y, z_sym = trt._analysis(x, quality)
    y_sym, _, _ = trt._y_passes(z_sym.numpy(), y=y)
    return z_sym.numpy(), y_sym.numpy()


def assert_round_trip_exact(trt, img, blob, quality=0):
    """The symbols decoded from ``blob`` are the symbols the encoder coded."""
    for got, want in zip(symbols(trt, blob),
                         encoder_symbols(trt, img, quality)):
        np.testing.assert_array_equal(got, want)


def assert_encoders_agree(a, b):
    """Two encoders' (z, y) symbols: <= 0.5 % differ, none by more than 1."""
    differing = sum(int(np.sum(p != q)) for p, q in zip(a, b))
    total = sum(p.size for p in a)
    worst = max(int(np.abs(p.astype(np.int64) - q).max())
                for p, q in zip(a, b))
    assert worst <= 1, f"a symbol differs by {worst}"
    assert differing <= MAX_DIFF_FRACTION * total, (
        f"{differing} of {total} symbols differ")


@pytest.fixture
def one_torch_thread():
    """Run a test with PyTorch's intra-op pool at one thread. The suite runs
    in several worker processes; a pool per worker oversubscribes the cores,
    and the thousands of small ops of a tiny decode then wait on each other
    (a 6 s test took 115 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread_per_module():
    """``one_torch_thread`` for every test of a module that imports it, its
    module-scoped fixtures included (autouse: set up before them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread_per_module():
    """BLAS at one thread for every test of a module that imports it. The
    FID's ``scipy.linalg.sqrtm`` of a 512×512 covariance product takes 0.3 s
    at one OpenBLAS thread and 1.0 s at the default eight, and longer still
    when the suite's workers share the cores."""
    from threadpoolctl import threadpool_limits
    with threadpool_limits(1):
        yield


# ---- training: the port's initialisation carried to JAX ----

def port_init_pair(cfg, seed: int = 0, perturb: float = 0.05):
    """(F32 JAX model, its params, the port's F32 model) carrying one set of
    weights: the port's ``init_weights`` from ``seed`` plus seeded noise on
    every leaf (the UNet's zero head would otherwise hide the UNet), carried
    to JAX by ``params_to_jax``. ``jax.eval_shape`` gives the tree, so no
    JAX initialisation is compiled."""
    from tpucdc_torch.utils import init_weights
    tm = CDCModel(to_torch_config(cfg).model)
    init_weights(tm, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(perturb * torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32)))
    set_policy(tm, F32_POLICY)
    jm = JaxCDCModel(cfg.model.validated(), policy=JAX_F32)
    sched = jax_make_schedule(cfg.model.schedule.kind,
                              cfg.model.schedule.num_steps)
    tables = {"sqrt_ab": sched.sqrt_alpha_bars,
              "sqrt_1mab": sched.sqrt_one_minus_alpha_bars}
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    abstract = jax.eval_shape(
        lambda: jm.init(jax.random.key(0), x, jax.random.key(0), tables))
    return jm, jax_tree(tm.state_dict(), abstract), tm


def jax_tree(state: dict, like):
    """A port state_dict (or grads keyed alike) as a JAX params tree shaped
    like ``like``, through ``params_to_jax``."""
    from tpucdc_torch.utils import params_to_jax
    flat = params_to_jax(state)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    assert len(leaves) == len(flat)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(flat[jax.tree_util.keystr(kp)]) for kp, _ in leaves])


def jax_forward_draws(model_cfg, rng, x_shape, T: int, train: bool = True,
                      latent_factor: int = 16, hyper_factor: int = 4):
    """The draws ``tpucdc.model.CDCModel.__call__`` makes from ``rng``, in
    the port's ``draws`` layout (torch tensors)."""
    return {k: t_(v) for k, v in jax_forward_draws_np(
        model_cfg, rng, x_shape, T, train, latent_factor,
        hyper_factor).items()}


def jax_forward_draws_np(model_cfg, rng, x_shape, T: int, train: bool = True,
                         latent_factor: int = 16, hyper_factor: int = 4):
    """``jax_forward_draws`` as numpy arrays."""
    cfg = model_cfg.validated()
    b, h, w, _ = x_shape
    codec = cfg.codec
    y_shape = (b, h // latent_factor, w // latent_factor,
               codec.latent_channels)
    z_shape = (b, y_shape[1] // hyper_factor, y_shape[2] // hyper_factor,
               codec.hyper_channels)
    k_zq, k_yq, k_t, k_eps, k_drop, k_q = jax.random.split(rng, 6)
    draws = {}
    if codec.num_qualities > 1:
        draws["quality"] = jax.random.randint(k_q, (b,), 0,
                                              codec.num_qualities)
    if train:
        draws["u_z"] = jax.random.uniform(k_zq, z_shape, jnp.float32,
                                          -0.5, 0.5)
        draws["u_y"] = jax.random.uniform(k_yq, y_shape, jnp.float32,
                                          -0.5, 0.5)
        if cfg.cond_dropout_prob > 0:
            draws["keep"] = (jax.random.uniform(k_drop, (b,))
                             >= cfg.cond_dropout_prob)
    k_t, k_tl, k_tm = jax.random.split(k_t, 3)
    t = jax.random.randint(k_t, (b,), 0, T)
    if cfg.t_low_prob > 0.0:
        t_low = jax.random.randint(k_tl, (b,), 0,
                                   max(int(cfg.t_low_frac * T), 1))
        t = jnp.where(jax.random.uniform(k_tm, (b,)) < cfg.t_low_prob,
                      t_low, t)
    draws["t"] = t
    draws["eps"] = jax.random.normal(k_eps, x_shape, jnp.float32)
    return {k: np.asarray(v) for k, v in draws.items()}


def t_(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def rel_err(got, want) -> float:
    """‖got − want‖ / ‖want‖ (∞ when want is 0 and got is not)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    num = np.linalg.norm(got - want)
    den = np.linalg.norm(want)
    return float(num / den) if den else (0.0 if num == 0 else float("inf"))


# ---- several ranks: gloo processes on the CPU ----

_RANK_PRELUDE = """
import datetime, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={store!r}, rank=rank,
                        world_size={world}, timeout=datetime.timedelta(seconds=60))
inp = torch.load({inp!r}, weights_only=False)
out = {{}}
"""

_RANK_EPILOGUE = """
torch.save(out, {out!r} + f"{{rank}}.pt")
dist.destroy_process_group()
print("rank", rank, "ok", flush=True)
"""


def run_ranks(tmp_path, body: str, inputs: dict, world: int = 2,
              env: dict | None = None) -> list:
    """Run ``body`` in ``world`` fresh CPU processes joined by gloo (a
    ``file://`` store in ``tmp_path``): each sees ``rank``, ``inp`` (the
    ``inputs``, through ``torch.save``) and fills ``out``; returns every
    rank's ``out``. The children import the port only and run at one
    thread; a hang fails after 180 s instead of eating the suite."""
    import subprocess
    import sys
    import textwrap

    store = tmp_path / "store"
    store.unlink(missing_ok=True)
    torch.save(inputs, tmp_path / "in.pt")
    script = (_RANK_PRELUDE.format(repo=str(ROOT),
                                   store=f"file://{store}", world=world,
                                   inp=str(tmp_path / "in.pt"))
              + textwrap.dedent(body)
              + _RANK_EPILOGUE.format(out=str(tmp_path / "out")))
    child_env = {"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path),
                 "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": "",
                 **(env or {})}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              env=child_env, cwd=tmp_path,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-3000:]}"
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(world)]
