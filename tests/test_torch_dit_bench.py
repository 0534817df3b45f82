"""The benchmark's ``dit_xl2-decode`` cell run on the CPU at a tiny size, in
this process, through the harness (``cdcbench.run.execute``): the drawn-DiT
decode loop, its counts and its reference.

* A run is correct against the reference, its window decodes, and its
  ``setup_s`` and decode percentiles are reported.
* A traced run reads the new counts; the fp8 control reads more than the
  port does.
* The counts at 768×512 (meta device): 140 attention calls, attention 47 %
  of the decode's FLOP, ``dit_gemm_flops`` the 28 blocks' and the
  embedders' products.
* A port whose configuration has no refiner kind fails the set-up at once.
"""

import json
import pathlib

import pytest
import torch

from cdcbench.tests.helpers import SMALL, cpu_run, tiny_config, tiny_weights

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "dit_xl2-decode"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    """The cell's configuration file cut to the tiny preset: a UNet weights
    file for the codec and head, and a DiT of 2 heads of 72 and depth 2 on
    the tiny head's grid (space-to-depth 2)."""
    conf = tiny_config()
    weights = tiny_weights(conf, tmp_path_factory.mktemp("w") / "tiny.npz")
    dit = json.loads((ROOT / "cdcbench/configs/dit_xl2.json").read_text())[
        "config"]["model"]["dit"]
    conf["model"].update(refiner="dit", dit={
        **dit, "hidden": 144, "depth": 2, "heads": 2, "space_to_depth": 2,
        "cond_channels": conf["model"]["cond"]["feature_channels"]})
    return {"config": conf, "weights": str(weights)}


def test_cell_is_correct_on_the_cpu(tiny_cell):
    res = cpu_run(CELL, 2 ** 31 + 77, config=tiny_cell,
                  traffic={**SMALL, "pool": 2})
    checks = {c.name: c for c in res["_checks"]}
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert checks["off2_share"].value < 0.02
    assert set(res["metrics"]) == {"setup_s", "decode_ms.p50",
                                   "decode_ms.p95"}


def test_traced_run_and_control(tiny_cell):
    res = cpu_run(CELL, 5, trace=1, config=tiny_cell,
                  traffic={**SMALL, "pool": 2}, control=True)
    checks = {c.name: c.value for c in res["_checks"]}
    assert checks["control_off2_share"] > 10 * max(checks["off2_share"],
                                                   1e-4)
    # No device on the CPU: the device readers find nothing, the span
    # readers what the port recorded.
    assert "attention.roofline.decode" not in res["metrics"]
    assert res["metrics"]["decode.graph_share"]["value"] == 0.0
    for name in ("decode.rans_ms", "decode.sampler_host_ms",
                 "decode.fetches"):
        assert res["metrics"][name]["value"] > 0, name


def test_counts_at_the_served_size():
    from cdcbench import counts_dit
    conf = json.loads((ROOT / "cdcbench/configs/dit_xl2.json").read_text())
    c = counts_dit.decode_counts(conf["config"], 512, 768)
    n, d, steps, depth = 6144, 1152, 5, 28
    assert c["attention_calls"] == steps * depth
    assert c["attention_flops"] == steps * depth * 4 * 16 * n * n * 72
    blocks = steps * depth * 2 * (n * d * 12 * d + d * 6 * d)
    embed = steps * 2 * (256 * d + d * d + d * 2 * d + n * d * 384)
    assert c["dit_gemm_flops"] == blocks + embed
    assert 0.46 < c["attention_flops"] / c["flops"] < 0.48


def test_a_port_without_refiners_fails_at_once(tiny_cell, monkeypatch):
    from tpucdc_torch import config as port_config
    fields = dict(port_config.ModelConfig.__dataclass_fields__)
    fields.pop("refiner")
    monkeypatch.setattr(port_config.ModelConfig, "__dataclass_fields__",
                        fields)
    with pytest.raises(SystemExit, match="no refiner kind"):
        cpu_run(CELL, 1, config=tiny_cell, traffic={**SMALL, "pool": 2})

