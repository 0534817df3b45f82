"""``cdcbench/port_spans.py`` on synthetic records of the port's recorder:
the median over a root's requests, the division by a training chunk's
steps, the profiled records and other roots left out, and None where there
is nothing to read (no such span, or a port without spans)."""

from __future__ import annotations

import sys
import types

import pytest

from cdcbench import port_spans
from tpucdc_torch.utils import profiling


def _record(root: str, stages: dict, profiled: bool = False,
            steps: int | None = None):
    """A record of ``root`` holding, per stage name, spans of the given
    milliseconds, one after another."""
    spans, t, n = [], 0, 1
    for name, durations in stages.items():
        for ms in durations:
            spans.append((n, 0, name, t, t + int(ms * 1e6), None))
            t += int(ms * 1e6)
            n += 1
    counts = {"steps": steps} if steps else None
    spans.append((0, None, root, 0, t + 1000, counts))
    return profiling.Request(root, spans, profiled=profiled)


def test_median_over_the_roots_requests():
    small = {"rans.decode": [1.0, 2.0], "codec.fetch": [0.5, 0.5]}
    records = [_record("codec.decompress", small),
               _record("codec.decompress", small),
               _record("codec.decompress", {"rans.decode": [10.0, 20.0],
                                            "codec.fetch": [0.5] * 9}),
               _record("codec.decompress", {"rans.decode": [4.0]})]
    got = port_spans.ms("codec.decompress", "rans.decode", records=records)
    assert got == pytest.approx(3.5)      # of 3, 3, 4 and 30
    assert port_spans.calls("codec.decompress", "codec.fetch",
                            records=records) == 2
    assert port_spans.ms("codec.decompress", "rans.decode", "codec.fetch",
                         records=records) == pytest.approx(4.0)


def test_profiled_records_and_other_roots_are_left_out():
    records = [_record("codec.decompress", {"ddim.step": [5.0]}),
               _record("codec.decompress", {"ddim.step": [500.0]},
                       profiled=True),
               _record("codec.compress", {"ddim.step": [700.0] * 6})]
    assert port_spans.ms("codec.decompress", "ddim.step",
                         records=records) == pytest.approx(5.0)
    assert port_spans.ms("codec.compress", "ddim.step",
                         records=records) == pytest.approx(4200.0)
    only_traced = records[1:2]
    assert port_spans.ms("codec.decompress", "ddim.step",
                         records=only_traced) is None


def test_training_chunks_are_read_per_step():
    records = [_record("train.chunk", {"train.forward": [10.0] * 16,
                                       "train.ema": [1.0] * 16}, steps=16),
               _record("train.chunk", {"train.forward": [30.0]}, steps=1),
               _record("train.chunk", {"train.forward": [12.0] * 16,
                                       "train.ema": [1.0] * 16}, steps=16),
               _record("train.setup", {"train.forward": [99.0]})]
    assert port_spans.ms("train.chunk", "train.forward", per_step=True,
                         records=records) == pytest.approx(12.0)
    assert port_spans.ms("train.chunk", "train.forward", "train.ema",
                         per_step=True, records=records) == pytest.approx(
        13.0)


def test_nothing_to_read_gives_none():
    records = [_record("codec.decompress", {"rans.decode": [1.0]})]
    assert port_spans.ms("codec.decompress", "gamma.grid_fit",
                         records=records) is None
    assert port_spans.calls("codec.compress", "rans.decode",
                            records=records) is None
    assert port_spans.ms("train.chunk", "train.forward", per_step=True,
                         records=[]) is None


def test_a_port_without_spans_gives_none(monkeypatch):
    """The parent commit's port: a profiling module with no recorder."""
    import tpucdc_torch.utils as utils
    bare = types.ModuleType("tpucdc_torch.utils.profiling")
    bare.profile_trace = profiling.profile_trace
    monkeypatch.setitem(sys.modules,
                        "tpucdc_torch.utils.profiling", bare)
    monkeypatch.setattr(utils, "profiling", bare)
    assert port_spans.ms("codec.decompress", "rans.decode") is None
    assert port_spans.calls("codec.decompress", "codec.fetch") is None


def test_the_cells_read_the_port_after_a_run():
    """The readers find the port's own records of real requests."""
    with profiling.span("test.request"):
        with profiling.span("codec.fetch", bytes=4):
            pass
        with profiling.span("codec.fetch", bytes=4):
            pass
    assert port_spans.calls("test.request", "codec.fetch") == 2
