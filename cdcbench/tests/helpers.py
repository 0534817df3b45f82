"""CPU helpers of the benchmark's tests: a run of a cell in this process on
the CPU, at a size a test can hold, with files in a temporary copy."""

from __future__ import annotations

import dataclasses
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]


def tiny_config(context: str = "hyperprior") -> dict:
    """The tiny preset with the served flagship's refiner dial, as a
    configuration file's ``config``: 2 truncated steps, residual."""
    from tpucdc_torch import presets
    cfg = presets.tiny()
    codec = dataclasses.replace(
        cfg.model.codec, context=context, context_groups=4,
        num_qualities=3 if context == "space-channel" else 1)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, codec=codec,
                                       prediction="residual"),
        sample=dataclasses.replace(cfg.sample, steps=2, truncate_frac=0.15,
                                   blend_gamma=0.5)).validated()
    d = dataclasses.asdict(cfg)
    d.pop("workdir")
    return d


def tiny_weights(config: dict, path: pathlib.Path, seed: int = 0):
    """Seeded weights for ``config`` in the JAX package's npz layout."""
    from tpucdc_torch import config as port_config
    from tpucdc_torch.model import CDCModel
    from tpucdc_torch.utils import draw_weights
    from tpucdc_torch.utils.weights import save_params_npz

    from cdcbench.reference.codec_ref import from_dict
    cfg = from_dict(port_config.Config, config).validated()
    model = CDCModel(cfg.model)
    draw_weights(model, seed)
    save_params_npz(model.state_dict(), path)
    return path


# The four-card training cell: its traffic, limits and collectives metric
# are in cdcbench/, its entry is not in BENCHMARK.json until the card proves
# it; the tests run its four ranks over gloo.
DP4_CELL = {"name": "flagship-train-dp4", "config": "flagship",
            "traffic": "train_recipe_dp4", "chips": 4, "why": "test"}


def cpu_run(workload: str, seed: int, seconds: float = 2.0, trace: int = 0,
            config: dict | None = None, traffic: dict | None = None,
            control: bool = False):
    """One run of ``workload`` on the CPU, through ``run.execute``, with the
    cell's configuration or traffic fields overridden."""
    import torch

    from cdcbench import run as runmod
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    if workload == DP4_CELL["name"]:
        manifest["workloads"].append(DP4_CELL)
    real = runmod.cell_files

    def cell_files(man, name):
        cell, conf, traf, limits = real(man, name)
        return (cell, {**conf, **(config or {})}, {**traf, **(traffic or {})},
                limits)
    runmod.cell_files = cell_files
    try:
        args = runmod.parse(["--workload", workload, "--seed", str(seed),
                             "--seconds", str(seconds), "--trace", str(trace)])
        return runmod.execute(args, device=torch.device("cpu"),
                              manifest=manifest, control=control)
    finally:
        runmod.cell_files = real


SMALL = {"height": 128, "width": 128, "judge_requests": 2, "trace_after": 1,
         "trace_requests": 1}
