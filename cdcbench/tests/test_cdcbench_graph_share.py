"""``cdcbench/metrics/decode.graph_share.py`` on synthetic records of the
port's recorder: every step replayed reads 100, no replay among the steps
0, no ``ddim.step`` None, and a port without the graphed denoiser (the
parent commit's) None."""

from __future__ import annotations

import importlib.util

import pytest

from cdcbench import core
from cdcbench.run import load_module
from cdcbench.tests.test_cdcbench_port_spans import _record
from tpucdc_torch.utils import profiling

METRIC = load_module(core.BENCH / "metrics" / "decode.graph_share.py")


def _decodes(monkeypatch, stages_of_each):
    records = [_record("codec.decompress", stages)
               for stages in stages_of_each]
    monkeypatch.setattr(profiling, "requests", lambda: records)


@pytest.mark.parametrize("replays,steps,want", [
    (5, 5, 100.0), (0, 5, 0.0), (4, 5, 80.0), (5, 0, None), (0, 0, None)])
def test_replays_over_steps(monkeypatch, replays, steps, want):
    stages = {"ddim.step": [10.0] * steps, "unet.replay": [1.0] * replays}
    _decodes(monkeypatch, [stages, stages, {"rans.decode": [1.0]}
                           if steps == 0 else stages])
    got = METRIC.read(None)
    assert got == (None if want is None else pytest.approx(want))


def test_the_median_decode(monkeypatch):
    graphed = {"ddim.step": [10.0] * 5, "unet.replay": [1.0] * 5}
    eager = {"ddim.step": [10.0] * 5}
    _decodes(monkeypatch, [eager, graphed, graphed])
    assert METRIC.read(None) == pytest.approx(100.0)
    _decodes(monkeypatch, [eager, eager, graphed])
    assert METRIC.read(None) == 0.0


def test_a_port_without_graphs_gives_none(monkeypatch):
    _decodes(monkeypatch, [{"ddim.step": [10.0] * 5}])
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "tpucdc_torch.sampling.graphed"
        else find_spec(name, *a)))
    assert METRIC.read(None) is None
