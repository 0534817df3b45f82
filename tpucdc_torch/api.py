"""High-level Python API, mirroring tpucdc/api.py.

    import tpucdc_torch.api as tpucdc
    from tpucdc_torch.presets import SERVING_OVERRIDES
    runtime = tpucdc.load_runtime("flagship",
                                  checkpoint="artifacts/flagship_params.npz",
                                  overrides=SERVING_OVERRIDES)
    blob = runtime.compress(img_u8)
    img = runtime.decompress(blob)

Training (``train``) is not ported yet and raises.
"""

from __future__ import annotations

import pathlib
from typing import Optional

from tpucdc_torch import presets
from tpucdc_torch.config import Config, apply_overrides
from tpucdc_torch.model import CDCModel
from tpucdc_torch.pipelines.codec_runtime import CodecRuntime
from tpucdc_torch.utils import draw_weights, load_params_npz

PRESETS = {"tiny": presets.tiny, "flagship": presets.flagship}


def _not_ported_training(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with training; see ROADMAP.md, "
        f"Queue 1 item 13")


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
    ``artifacts/flagship_params.npz``), which holds EMA parameters; every
    array must map onto the model and every parameter must be in it. With
    no checkpoint the weights are drawn by ``utils.draw_weights(model, 0)``:
    they are not the JAX package's flax initialisation, which needs JAX to
    reproduce, so a no-checkpoint runtime of the port does not decode what
    a no-checkpoint JAX runtime encoded.
    """
    model = CDCModel(cfg.model)
    if checkpoint is None:
        draw_weights(model, 0)
        return model
    path = pathlib.Path(checkpoint)
    if path.is_dir():
        raise _not_ported_training(
            f"reading the orbax run directory {path}")
    if not use_ema:
        raise ValueError(f"{path} holds EMA parameters only; the raw "
                         f"training parameters live in an orbax run "
                         f"directory, which the port does not read yet")
    state, unused = load_params_npz(path)
    if unused:
        raise ValueError(f"{path}: {len(unused)} arrays map onto nothing, "
                         f"e.g. {unused[:3]}")
    model.load_state_dict(state, strict=True)
    return model


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
          overrides: Optional[dict] = None):
    """R-D training: not ported yet."""
    raise _not_ported_training("train")
