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
        prediction=m.prediction)
    return torch_config.Config(
        model=model,
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


def init_jax(cfg, seed: int = 0, perturb: float = 0.05):
    """F32 JAX model + params; ``perturb`` adds seeded noise to every leaf
    (the UNet's zero-initialized output conv would otherwise hide it)."""
    model = JaxCDCModel(cfg.model.validated(), policy=JAX_F32)
    sched = jax_make_schedule(cfg.model.schedule.kind,
                              cfg.model.schedule.num_steps)
    tables = {"sqrt_ab": sched.sqrt_alpha_bars,
              "sqrt_1mab": sched.sqrt_one_minus_alpha_bars}
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = model.init(jax.random.key(seed), x, jax.random.key(0), tables)
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
