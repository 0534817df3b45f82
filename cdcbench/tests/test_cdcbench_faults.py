"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have; a sound run and the lower-precision control,
each at a size a test can hold on the CPU.

The serving cells run the trained models on 128×128 images (the encode's
control on 256×256); the training
cell the tiny preset at batch 4, crop 64, K 2, on one process and on four
gloo ranks. Each drives ``run.execute`` past the harness's look for a card,
with the cell's own limits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cdcbench.control import plant
from cdcbench.tests.helpers import ROOT, SMALL, cpu_run, tiny_config


def _checks(result) -> dict:
    return {c.name: c.value for c in result["_checks"]}


@pytest.mark.parametrize("workload", ["flagship-decode", "vr_wide-decode"])
def test_decode_sound_and_control(workload):
    r = cpu_run(workload, 21, traffic=SMALL, control=True)
    got = _checks(r)
    assert r["correct"] is False          # the control's number fails
    assert got["off2_share"] <= r["_checks"][0].limit
    assert got["control_off2_share"] > r["_checks"][0].limit


@pytest.mark.parametrize("workload", ["flagship-decode", "vr_wide-decode"])
def test_decode_answer_altered(workload, monkeypatch):
    """The decoded image two levels brighter where it is produced."""
    from tpucdc_torch.pipelines.codec_runtime import CodecRuntime
    real = CodecRuntime.decompress

    def altered(self, *a, **k):
        img = real(self, *a, **k)
        return np.clip(img.astype(np.int16) + 2, 0, 255).astype(np.uint8)
    monkeypatch.setattr(CodecRuntime, "decompress", altered)
    assert cpu_run(workload, 22, traffic=SMALL)["correct"] is False


def test_decode_token_altered(monkeypatch):
    """Every 40th y symbol the coder decodes moved by one (the flagship's
    one y pass: in a context model the next pass would desync and the
    decode would raise)."""
    from tpucdc_torch.entropy.rans import RansCodec
    real = RansCodec.decode

    def altered(self, data, indexes):
        out = np.array(real(self, data, indexes))
        if out.size > 1000:
            out.reshape(-1)[::40] += 1
        return out
    monkeypatch.setattr(RansCodec, "decode", altered)
    assert cpu_run("flagship-decode", 23, traffic=SMALL)["correct"] is False


def test_encode_sound_and_control():
    """256×256 and two judged encodes: at 128×128 the fp8 control's loss
    falls under the limit that the card's 768×512 readings set."""
    r = cpu_run("flagship-encode", 24, seconds=5.0, control=True,
                traffic={**SMALL, "height": 256, "width": 256})
    got, limit = _checks(r), r["_checks"][0].limit
    assert got["psnr_loss_db"] <= limit < got["control_psnr_loss_db"]


def test_encode_token_altered(monkeypatch):
    """A byte of the last y stream flipped in the bitstream produced."""
    from tpucdc_torch.pipelines.codec_runtime import CodecRuntime
    real = CodecRuntime.compress

    def altered(self, *a, **k):
        blob = bytearray(real(self, *a, **k))
        blob[-40] ^= 0x5A
        return bytes(blob)
    monkeypatch.setattr(CodecRuntime, "compress", altered)
    assert cpu_run("flagship-encode", 25, traffic=SMALL)["correct"] is False


TRAIN = {"train.batch_size": 4, "train.crop_size": 64,
         "train.steps_per_dispatch": 2}


def _train_config() -> dict:
    conf = json.loads((ROOT / "cdcbench/configs/flagship.json").read_text())
    conf["config"] = tiny_config()
    conf["train_recipe"]["overrides"].update(TRAIN)
    return conf


TRAIN_TRAFFIC = {"height": 128, "width": 128, "pool": 4}


@pytest.mark.parametrize("fault", [None, "unchanged", "half"])
def test_train_one_card(fault, monkeypatch):
    """The one-card training cell's step (no mesh)."""
    if fault:
        plant(fault, monkeypatch.setattr)
    r = cpu_run("flagship-train", 26, config=_train_config(),
                traffic=TRAIN_TRAFFIC, control=fault is None)
    if fault is None:
        got = _checks(r)
        limits = {c.name: c.limit for c in r["_checks"]}
        assert all(got[k] <= limits[k] for k in
                   ("loss_gap", "grad_gap", "update_gap"))
        assert any(got[f"control_{k}"] > limits[k] for k in
                   ("loss_gap", "grad_gap", "update_gap"))
    else:
        assert r["correct"] is False


RANK_CODE = """
import json, os, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from cdcbench.tests import test_cdcbench_faults as t
from cdcbench.tests.helpers import cpu_run
from cdcbench.control import plant
if {fault!r}:
    plant({fault!r})
r = cpu_run("flagship-train-dp4", 27, config=t._train_config(),
            traffic=t.TRAIN_TRAFFIC)
if os.environ["RANK"] == "0":
    print(json.dumps({{"correct": r["correct"],
                       "checks": {{c.name: c.value for c in r["_checks"]}}}}))
"""


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_train_four_ranks(fault, tmp_path):
    from cdcbench import ranks
    port = ranks.free_port()
    procs = []
    for rank in range(4):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CODE.format(root=str(ROOT),
                                                    fault=fault)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs[0][-3000:]
    result = json.loads(outs[0].strip().splitlines()[-1])
    assert result["correct"] is (fault is None), result
