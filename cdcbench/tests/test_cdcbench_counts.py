"""The benchmark's FLOP and byte counts against hand counts at small
shapes, and against the bounds of the served decode that the port's kernel
table gives (GN+SiLU 0.0743 ms by bytes, attention 0.0550 ms by FLOP)."""

from __future__ import annotations

import json

import pytest
import torch

from cdcbench import core, counts
from cdcbench.reference.ops.layers import Conv, Dense
from cdcbench.tests.helpers import ROOT

FLAGSHIP = json.loads((ROOT / "cdcbench/configs/flagship.json").read_text())


def test_attention_flops_by_hand():
    calls = [((1, 4, 1536, 24), (1, 4, 1536, 24)), ((2, 2, 10, 8),
                                                    (2, 2, 7, 8))]
    assert counts.attention_flops(calls) == (4 * 4 * 1536 * 1536 * 24
                                             + 4 * 2 * 2 * 10 * 7 * 8)


def test_gn_silu_bytes_by_hand():
    calls = [((1, 4, 6, 32), torch.bfloat16, 32), ((2, 3, 3, 8),
                                                    torch.float32, 8)]
    assert counts.gn_silu_bytes(calls) == (2 * 4 * 6 * 32 * 2 + 2 * 32 * 4
                                           + 2 * 2 * 3 * 3 * 8 * 4 + 2 * 8 * 4)


def test_flop_meter_by_hand():
    conv, dense = Conv(8, 16, 3).to(counts.META), Dense(16, 5).to(counts.META)
    m = counts._Meter()
    with m():
        y = conv(torch.zeros((2, 10, 12, 8), device=counts.META),
                 torch.bfloat16)
        dense(y, torch.bfloat16)
    assert m.flops == 2 * (2 * 10 * 12) * 16 * 8 * 9 + 2 * (2 * 10 * 12) * 16 * 5


def test_flagship_decode_against_the_kernel_table():
    c = counts.decode_counts(FLAGSHIP["config"], 512, 768)
    assert (c["gn_silu_calls"], c["attention_calls"]) == (93, 60)
    assert 1e3 * c["gn_silu_bytes"] / core.PEAK_HBM_BYTES == pytest.approx(
        0.0743, abs=5e-5)
    assert 1e3 * c["attention_flops"] / core.PEAK_BF16_FLOPS == \
        pytest.approx(0.0550, abs=5e-5)
    # g_s, the head and five UNet steps: some hundreds of GFLOP.
    assert 1e11 < c["flops"] < 5e11


def test_encode_counts_six_decodes_more():
    one = counts.decode_counts(FLAGSHIP["config"], 512, 768)
    enc = counts.encode_counts(FLAGSHIP["config"], 512, 768, 6)
    assert enc["gn_silu_calls"] == 6 * 93 and enc["attention_calls"] == 360
    assert enc["flops"] > 6 * one["flops"]
