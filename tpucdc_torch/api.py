"""High-level Python API, mirroring tpucdc/api.py.

    import tpucdc_torch.api as tpucdc
    from tpucdc_torch.presets import SERVING_OVERRIDES
    runtime = tpucdc.load_runtime("flagship",
                                  checkpoint="artifacts/flagship_params.npz",
                                  overrides=SERVING_OVERRIDES)
    blob = runtime.compress(img_u8)
    img = runtime.decompress(blob)

    model, state = tpucdc.train(preset="tiny", steps=1000,
                                workdir="/tmp/run", device="cpu")
    runtime = tpucdc.load_runtime("tiny", checkpoint="/tmp/run/lambda8",
                                  device="cpu")
"""

from __future__ import annotations

import pathlib
import warnings
from typing import Optional

from tpucdc_torch import presets
from tpucdc_torch.config import Config, apply_overrides
from tpucdc_torch.model import CDCModel
from tpucdc_torch.pipelines.codec_runtime import CodecRuntime
from tpucdc_torch.utils import draw_weights, load_params_npz

PRESETS = {"tiny": presets.tiny, "flagship": presets.flagship}


def run_dir(workdir, cfg: Config) -> pathlib.Path:
    """The λ-tagged run directory of ``cfg`` under ``workdir``: its
    checkpoints go to ``ckpt/``, its metrics to ``logs/``."""
    return pathlib.Path(workdir) / f"lambda{cfg.train.rd_lambda:g}"


def build_config(preset: str = "flagship",
                 overrides: Optional[dict] = None) -> Config:
    """A preset ("tiny" or "flagship") with ``{"a.b.c": value}``
    dot-overrides applied, validated."""
    cfg = PRESETS[preset]()
    if overrides:
        cfg = apply_overrides(cfg, {k: str(v) for k, v in overrides.items()})
    return cfg.validated()


def load_model(cfg: Config, checkpoint: Optional[str] = None,
               use_ema: bool = True) -> CDCModel:
    """The model of ``cfg`` carrying the weights of ``checkpoint``.

    ``checkpoint`` is a ``save_params_npz`` file (e.g.
    ``artifacts/flagship_params.npz``), which holds EMA parameters, or a
    run directory of the port's ``train`` (its ``ckpt/`` directory, or the
    λ directory holding it): the latest step's EMA parameters, or the raw
    ones with ``use_ema=False``. Every array must map onto the model and
    every parameter must be in it. The JAX package's orbax run directories
    are not read: orbax needs JAX. With no checkpoint the weights are drawn
    by ``utils.draw_weights(model, 0)``: they are not the JAX package's flax
    initialisation, so a no-checkpoint runtime of the port does not decode
    what a no-checkpoint JAX runtime encoded.

    A DiT refiner (``model.refiner="dit"``) is served from a checkpoint that
    holds no DiT, as the flagship's npz does (the repo has no trained DiT):
    the codec and the conditioning head are loaded (every one of their
    parameters must be there), the checkpoint's ``unet.*`` arrays are left
    out, and the DiT is drawn by ``draw_weights(model, 0,
    prefixes=("dit.",))``, with a warning that the refiner is random.
    """
    model = CDCModel(cfg.model)
    if checkpoint is None:
        draw_weights(model, 0)
        return model
    path = pathlib.Path(checkpoint)
    if path.is_dir():
        from tpucdc_torch.utils.checkpoint import CheckpointManager
        if (path / "ckpt").is_dir():
            path = path / "ckpt"
        saved = CheckpointManager(path).read()
        _load_state(model, saved["ema_params"] if use_ema
                    else saved["params"])
        return model
    if not use_ema:
        raise ValueError(f"{path} holds EMA parameters only; the raw "
                         f"training parameters are in a run directory")
    state, unused = load_params_npz(path)
    if unused:
        raise ValueError(f"{path}: {len(unused)} arrays map onto nothing, "
                         f"e.g. {unused[:3]}")
    _load_state(model, state)
    return model


def _load_state(model: CDCModel, state: dict) -> None:
    """``state`` into ``model``, strictly; a DiT that ``state`` lacks is
    drawn (``load_model``)."""
    if model.config.refiner != "dit" or any(k.startswith("dit.")
                                            for k in state):
        model.load_state_dict(state, strict=True)
        return
    kept = {k: v for k, v in state.items() if not k.startswith("unet.")}
    missing, unexpected = model.load_state_dict(kept, strict=False)
    absent = [k for k in missing if not k.startswith("dit.")]
    if absent or unexpected:
        raise ValueError(f"checkpoint does not fit the model outside the "
                         f"refiner: missing {absent[:3]}, unexpected "
                         f"{unexpected[:3]}")
    warnings.warn("the checkpoint holds no DiT: the refiner is drawn from "
                  "seed 0 (random weights)", stacklevel=3)
    draw_weights(model, 0, prefixes=("dit.",))


def load_runtime(preset: str = "flagship", checkpoint: Optional[str] = None,
                 overrides: Optional[dict] = None, use_ema: bool = True,
                 device="cuda") -> CodecRuntime:
    """A ready-to-serve CodecRuntime on ``device`` (the card unless the
    caller passes "cpu"); ``checkpoint`` and ``use_ema`` as ``load_model``
    reads them."""
    cfg = build_config(preset, overrides)
    return CodecRuntime(cfg, load_model(cfg, checkpoint, use_ema),
                        device=device)


def train(preset: str = "tiny", steps: int = 1000,
          workdir: Optional[str] = None, dataset: str = "kodak",
          overrides: Optional[dict] = None, device="cuda"):
    """R-D training on ``device`` (the card unless the caller passes "cpu")
    for ``steps`` steps, with checkpoints in ``run_dir(workdir)/ckpt`` and
    metrics in ``run_dir(workdir)/logs``; returns (model, final
    TrainState).

    As in the JAX package the run is always over a mesh of every rank:
    ``runtime.maybe_init_distributed`` joins the world that the environment
    names (torchrun, or ``TPUCDC_*``), else ``make_mesh`` forms a world of
    1. Every rank calls ``train`` with the same arguments; only rank 0
    writes the run directory.
    """
    import torch.distributed as dist

    from tpucdc_torch.data import eval_dataset, train_crop_iterator
    from tpucdc_torch.pipelines import train as train_lib
    from tpucdc_torch.runtime import make_mesh, maybe_init_distributed
    from tpucdc_torch.runtime.mesh import is_rank0
    from tpucdc_torch.utils import MetricLogger
    from tpucdc_torch.utils.checkpoint import CheckpointManager

    cfg = build_config(preset, overrides)
    if not dist.is_initialized():
        maybe_init_distributed(device)
    mesh = make_mesh(device=device)
    wd = run_dir(workdir or cfg.workdir, cfg)
    logger = ckpt = None
    if is_rank0():
        logger = MetricLogger(wd / "logs")
        ckpt = CheckpointManager(wd / "ckpt")
    ds = eval_dataset(dataset)
    data = train_crop_iterator(ds.images, cfg.train.batch_size,
                               cfg.train.crop_size, seed=cfg.train.seed,
                               as_uint8=True)
    try:
        # fit calls the checkpointer on rank 0 alone.
        return train_lib.fit(cfg, data, mesh=mesh, writer=logger,
                             checkpointer=lambda step, st: ckpt.save(step, st),
                             num_steps=steps, device=device)
    finally:
        if ckpt is not None:
            ckpt.close()
            logger.close()
