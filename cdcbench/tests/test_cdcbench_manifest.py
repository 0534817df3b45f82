"""BENCHMARK.json against the benchmark's contract, and the harness finding
everything by name: a configuration, a traffic mix, a metric and a cell
added as files and entries in a temporary copy, with no file edited."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from cdcbench.tests.helpers import ROOT, tiny_config, tiny_weights

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "cdcbench"


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "cdcbench/run.py"]
    assert MANIFEST["paths"] == ["cdcbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and w["config"] in names
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def _reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in MANIFEST["workloads"]:
        e2e = [m["name"] for m in MANIFEST["end_to_end"]
               if _reports(w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(w["name"], m) for m in MANIFEST["per_layer"])


def test_per_layer_moves_an_e2e_metric_that_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(cell, e2e[m["moves"]])
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["layer"], m["source"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_each_name_has_its_files():
    for c in MANIFEST["configs"]:
        assert c["file"] == f"cdcbench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()
    for w in MANIFEST["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (BENCH / "loops" / f"{traffic['loop']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("name,preset", [("flagship", "flagship_serving"),
                                         ("vr_wide", "vr_wide_serving")])
def test_configuration_files_hold_the_served_models(name, preset):
    """Nothing cut: each file is the port's preset of the trained model."""
    from tpucdc_torch import config as port_config
    from tpucdc_torch import presets

    from cdcbench.reference.codec_ref import from_dict
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    built = from_dict(port_config.Config, conf["config"]).validated()
    want = getattr(presets, preset)()
    assert dataclasses.replace(built, workdir=want.workdir) == want
    assert conf["reduced"] == [] and (ROOT / conf["weights"]).is_file()


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A dummy configuration, traffic mix, metric and cell in a copy: the
    copy's harness runs the cell and reports the metric, and every file
    the copy had is unchanged."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "cdcbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digests(copy / "cdcbench")
    conf = tiny_config()
    weights = tiny_weights(conf, tmp_path / "dummy.npz")
    (copy / "cdcbench/configs/dummy.json").write_text(json.dumps(
        {"name": "dummy", "weights": str(weights), "policy": "bf16",
         "reduced": [], "config": conf}))
    (copy / "cdcbench/traffic/dummy_mix.json").write_text(json.dumps(
        {"loop": "decode", "height": 128, "width": 128, "pool": 2,
         "judge_requests": 1, "trace_after": 1, "trace_requests": 1}))
    (copy / "cdcbench/limits/dummy-decode.json").write_text(
        json.dumps({"off2_share": 1e9}))
    (copy / "cdcbench/metrics/dummy.requests.py").write_text(
        "def read(view):\n    return float(view.requests)\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "dummy", "source": "test",
                                "file": "cdcbench/configs/dummy.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "dummy-decode", "config": "dummy",
                                  "traffic": "dummy_mix", "chips": 1,
                                  "why": "test"})
    for m in manifest["end_to_end"]:
        if "workloads" in m and m["name"].startswith("decode_ms"):
            m["workloads"].append("dummy-decode")
    manifest["per_layer"].append({
        "name": "dummy.requests", "unit": "requests", "better": "higher",
        "source": "device_trace", "layer": "test",
        "moves": "decode_ms.p50", "workloads": ["dummy-decode"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(copy)!r}, {str(ROOT)!r}]\n"
        "torch.set_num_threads(2)\n"
        "from cdcbench import run\n"
        "assert run.ROOT.as_posix() == sys.path[0]\n"
        "for trace in ('0', '1'):\n"
        "    r = run.execute(run.parse(['--workload', 'dummy-decode', "
        "'--seed', '5', '--seconds', '0.5', '--trace', trace]), "
        "device=torch.device('cpu'))\n"
        "    print(json.dumps(sorted(r['metrics'])))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    e2e, layer = [json.loads(x) for x in out.stdout.strip().splitlines()[-2:]]
    assert e2e == ["decode_ms.p50", "decode_ms.p95", "setup_s"]
    assert "dummy.requests" in layer
    after = _digests(copy / "cdcbench")
    assert all(after[k] == v for k, v in before.items())
