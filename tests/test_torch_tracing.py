"""The port's spans (``tpucdc_torch.utils.profiling``), on the CPU.

* The recorder: nesting, parents, the request id and self time; counts given
  at the start and added with ``add``; the ring of the newest
  ``MAX_REQUESTS`` records and the ``MAX_SPANS`` bound with its dropped
  count; each thread's spans in records of its own; ``export_spans``.
* The profiler's ranges: none without a profiler; under a CPU
  ``torch.profiler`` every span is a host range ``tpucdc.<name>`` inside its
  parent's, and the record is flagged as profiled.
* The span tree of each request path at the tiny preset: a hyperprior
  decode fetches twice and steps once a DDIM step; a space-channel decode
  fetches 2·groups + 1 times; the spatial γ search decodes six times inside
  one ``codec.compress``; ``fit`` records one ``train.chunk`` of K steps a
  chunk. Every public entry point opens one root, and a root's own time
  is a small share of it.
* No change to results: a decode's uint8 image and a fit step's loss are
  bit-equal with and without a profiler recording.
"""

import dataclasses
import json
import sys
import threading

import numpy as np
import pytest
import torch

from tpucdc_torch import presets
from tpucdc_torch.data import train_crop_iterator
from tpucdc_torch.model import CDCModel
from tpucdc_torch.pipelines import CodecRuntime
from tpucdc_torch.pipelines import train
from tpucdc_torch.runtime import F32_POLICY
from tpucdc_torch.utils import draw_weights, profiling, span

IMG = np.random.default_rng(0).integers(0, 256, (64, 96, 3), dtype=np.uint8)
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(fn):
    """The records of the requests ``fn()`` made on this thread, oldest
    first, and what it returned."""
    before = {r.id for r in profiling.requests()}
    out = fn()
    me = threading.get_ident()
    return [r for r in profiling.requests()
            if r.id not in before and r.thread == me], out


def _one(fn):
    records, out = _records(fn)
    assert len(records) == 1, [r.name for r in records]
    return records[0], out


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


# ---- the recorder ----

def test_nesting_parents_request_and_self_time():
    def work():
        with span("outer"):
            with span("a"):
                with span("leaf"):
                    sum(range(20000))
            with span("a"):
                sum(range(20000))
            sum(range(20000))
    rec, _ = _one(work)
    assert rec.name == "outer" and not rec.profiled and rec.dropped == 0
    by_id = {s[0]: s for s in rec.spans}
    root = [s for s in rec.spans if s[1] is None]
    assert len(root) == 1 and root[0][0] == 0 and root[0][2] == "outer"
    assert [by_id[s[1]][2] for s in rec.spans if s[1] is not None] == [
        "a", "outer", "outer"]
    for i, p, _, a, b, _ in rec.spans:
        assert a <= b
        if p is not None:
            assert by_id[p][3] <= a and b <= by_id[p][4]
    assert profiling.calls(rec, "a") == 2 and profiling.calls(rec, "x") == 0
    total = profiling.total_ms(rec, "outer")
    kids = profiling.total_ms(rec, "a")
    assert 0 < profiling.self_ms(rec, "outer") == pytest.approx(
        total - kids, abs=1e-9)
    assert profiling.self_ms(rec, "a") == pytest.approx(
        kids - profiling.total_ms(rec, "leaf"), abs=1e-9)
    assert profiling.self_ms(rec, "leaf") == profiling.total_ms(rec, "leaf")
    assert rec.start_ns == root[0][3]


def test_requests_are_separate_and_numbered_in_order():
    def work():
        for _ in range(3):
            with span("req"):
                with span("inner"):
                    pass
    records, _ = _records(work)
    assert [r.name for r in records] == ["req"] * 3
    ids = [r.id for r in records]
    assert ids == sorted(ids) and len(set(ids)) == 3
    assert all(len(r.spans) == 2 for r in records)


def test_counts_given_and_added():
    def work():
        with span("root", steps=4):
            with span("rans.decode", symbols=10, bytes=3):
                pass
            with span("rans.encode", symbols=5) as s:
                s.add("bytes", 2)
                s.add("bytes", 7)
            with span("plain"):
                pass
    rec, _ = _one(work)
    assert profiling.count(rec, "root", "steps") == 4
    assert profiling.count(rec, "rans.decode", "symbols") == 10
    assert profiling.count(rec, "rans.encode", "bytes") == 9
    assert profiling.count(rec, "plain", "bytes") == 0
    assert [s[5] for s in rec.spans if s[2] == "plain"] == [None]


def test_the_ring_keeps_the_newest_records():
    n = profiling.MAX_REQUESTS + 40

    def work():
        for i in range(n):
            with span(f"ring{i}"):
                pass
    work()
    kept = profiling.requests()
    assert len(kept) == profiling.MAX_REQUESTS
    assert [r.name for r in kept[-3:]] == [f"ring{i}" for i in
                                            range(n - 3, n)]
    assert "ring39" not in {r.name for r in kept}


def test_spans_beyond_the_bound_are_dropped_and_counted():
    extra = 25

    def work():
        with span("big"):
            for _ in range(profiling.MAX_SPANS + extra):
                with span("s"):
                    pass
    rec, _ = _one(work)
    assert len(rec.spans) == profiling.MAX_SPANS
    assert rec.dropped == extra + 1
    assert any(s[2] == "big" for s in rec.spans)


def test_threads_keep_their_own_requests():
    gate = threading.Barrier(4, timeout=30)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def worker(k):
        try:
            gate.wait()
            for _ in range(20):
                with span(f"t{k}"):
                    for _ in range(5):
                        with span(f"t{k}.child"):
                            sum(range(200))
        except Exception as e:     # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    mine = [r for r in profiling.requests() if r.name.startswith("t")
            and r.name[1:].isdigit()]
    assert len(mine) == 80
    for r in mine:
        assert len(r.spans) == 6
        assert {s[2] for s in r.spans} == {r.name, r.name + ".child"}
    assert len({r.thread for r in mine}) == 4


def test_export_spans_writes_a_line_a_record(tmp_path):
    def work():
        with span("exported", steps=2):
            with span("child", bytes=5):
                pass
    rec, _ = _one(work)
    path = tmp_path / "spans.jsonl"
    profiling.export_spans(path, [rec])
    [line] = path.read_text().splitlines()
    got = json.loads(line)
    assert got["name"] == "exported" and got["id"] == rec.id
    assert got["profiled"] is False and got["dropped"] == 0
    assert [(s["name"], s["parent"], s.get("counts")) for s in got["spans"]
            ] == [("child", 0, {"bytes": 5}), ("exported", None,
                                               {"steps": 2})]


# ---- the profiler's ranges ----

def test_no_range_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    rec, _ = _one(lambda: _nested())
    assert not rec.profiled and len(rec.spans) == 2


def _nested():
    with span("outer"):
        with span("inner"):
            torch.ones(4).sum()


def test_spans_are_nested_host_ranges_under_the_profiler():
    with _cpu_profile() as prof:
        rec, _ = _one(_nested)
    assert rec.profiled
    events = {e.name: e for e in prof.events()
              if e.name.startswith(profiling.RANGE_PREFIX)}
    assert set(events) == {"tpucdc.outer", "tpucdc.inner"}
    inner = events["tpucdc.inner"]
    assert inner.cpu_parent is not None
    assert inner.cpu_parent.name == "tpucdc.outer"
    assert any(c.name == "aten::sum" for c in inner.cpu_children)


# ---- the request paths at the tiny preset ----

def _runtime(context: str) -> CodecRuntime:
    cfg = presets.tiny()
    codec = dataclasses.replace(cfg.model.codec, context=context,
                                context_groups=4)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, codec=codec,
                                       prediction="residual"),
        sample=dataclasses.replace(cfg.sample, steps=STEPS,
                                   truncate_frac=0.15, blend_gamma=0.5))
    model = CDCModel(cfg.model)
    with torch.no_grad():
        draw_weights(model, 3)
    return CodecRuntime(cfg, model, device="cpu", policy=F32_POLICY)


@pytest.fixture(scope="module")
def hyper():
    rt = _runtime("hyperprior")
    return rt, rt.compress(IMG)


@pytest.fixture(scope="module")
def space_channel():
    rt = _runtime("space-channel")
    return rt, rt.compress(IMG)


def _noise(rt):
    return torch.randn((1, 64, 128, 3),
                       generator=torch.Generator().manual_seed(5))


def _covered(rec):
    """The root's own time, as a share of it."""
    return (profiling.self_ms(rec, rec.name)
            / profiling.total_ms(rec, rec.name))


def test_hyperprior_decode_tree(hyper):
    rt, blob = hyper
    rec, _ = _one(lambda: rt.decompress(blob, noise=_noise(rt)))
    names = {s[0]: s[2] for s in rec.spans}
    assert rec.name == "codec.decompress"
    assert profiling.calls(rec, "codec.fetch") == 2
    for name in ("ddim.step", "ddim.update", "unet.stem", "unet.out"):
        assert profiling.calls(rec, name) == STEPS, name
    for name in ("codec.decode_symbols", "codec.parse", "codec.hyper",
                 "codec.y_pass", "codec.device_stage", "codec.cond",
                 "codec.synth", "codec.blend"):
        assert profiling.calls(rec, name) == 1, name
    assert profiling.calls(rec, "rans.decode") == 2
    assert profiling.count(rec, "rans.decode", "bytes") == sum(
        len(s) for s in _streams(blob))
    parent = {s[2]: names.get(s[1]) for s in rec.spans}
    assert parent["ddim.step"] == "codec.device_stage"
    assert parent["unet.res"] == parent["ddim.update"] == "ddim.step"
    assert parent["codec.device_stage"] == "codec.decompress"
    assert parent["codec.y_pass"] == "codec.decode_symbols"
    assert parent["codec.hyper"] == "codec.y_pass"
    fetches = [s for s in rec.spans if s[2] == "codec.fetch"]
    assert [names[s[1]] for s in fetches] == ["codec.y_pass",
                                              "codec.decompress"]
    assert fetches[-1][5] == {"bytes": 64 * 128 * 3}
    assert _covered(rec) < 0.05


def _streams(blob):
    from tpucdc_torch.entropy import read_bitstream
    return read_bitstream(blob)[1]


def test_space_channel_decode_fetches(space_channel):
    rt, blob = space_channel
    rec, _ = _one(lambda: rt.decompress(blob, noise=_noise(rt)))
    groups = rt.config.model.codec.context_groups
    assert profiling.calls(rec, "codec.fetch") == 2 * groups + 1
    assert profiling.calls(rec, "codec.y_pass") == 2 * groups
    assert profiling.calls(rec, "rans.decode") == 2 * groups + 1
    # Every latent symbol once, and z's.
    ys = 32 * (64 // 16) * (128 // 16)
    zs = 16 * (64 // 64) * (128 // 64)
    assert profiling.count(rec, "rans.decode", "symbols") == ys + zs
    assert profiling.count(rec, "rans.decode", "bytes") == sum(
        len(s) for s in _streams(blob))
    assert _covered(rec) < 0.05


def test_spatial_gamma_search_tree(hyper):
    rt, _ = hyper
    rec, blob = _one(lambda: rt.compress(IMG, optimize_gamma="spatial",
                                         noise=_noise(rt)))
    assert rec.name == "codec.compress"
    assert profiling.calls(rec, "codec.decompress") == 6
    assert profiling.calls(rec, "gamma.candidate") == 5
    assert profiling.calls(rec, "gamma.score") == 6
    for name in ("gamma.search", "gamma.grid_fit", "gamma.verify",
                 "codec.analysis", "codec.container"):
        assert profiling.calls(rec, name) == 1, name
    assert profiling.calls(rec, "rans.encode") == 2
    assert profiling.count(rec, "rans.encode", "bytes") == sum(
        len(s) for s in _streams(blob))
    names = {s[0]: s[2] for s in rec.spans}
    assert {names[s[1]] for s in rec.spans if s[2] == "codec.decompress"
            } == {"gamma.candidate", "gamma.verify"}
    assert _covered(rec) < 0.05


@pytest.mark.parametrize("entry", ["compress", "compress_many",
                                   "estimate_bpp", "decompress",
                                   "decompress_many", "decompress_tiled"])
def test_each_entry_point_is_one_request(hyper, entry):
    rt, blob = hyper
    call = {
        "compress": lambda: rt.compress(IMG),
        "compress_many": lambda: rt.compress_many([IMG, IMG]),
        "estimate_bpp": lambda: rt.estimate_bpp(IMG),
        "decompress": lambda: rt.decompress(blob, noise=_noise(rt)),
        "decompress_many": lambda: rt.decompress_many([blob, blob]),
        "decompress_tiled": lambda: rt.decompress_tiled(blob, tile=32,
                                                        halo=16, steps=1),
    }[entry]
    rec, _ = _one(call)
    assert rec.name == f"codec.{entry}"
    inner = {"compress_many": ("codec.compress", 2),
             "decompress_many": ("codec.decode_symbols", 2),
             "decompress_tiled": ("codec.tile_blend", 1)}
    if entry in inner:
        name, n = inner[entry]
        assert profiling.calls(rec, name) == n
    if entry == "decompress_many":
        assert profiling.calls(rec, "codec.fetch") == 2 + 2
        assert profiling.calls(rec, "ddim.step") == 2 * STEPS


def _fit_cfg(k: int):
    return dataclasses.replace(
        presets.tiny(), train=dataclasses.replace(
            presets.tiny().train, batch_size=2, crop_size=64,
            steps_per_dispatch=k, log_every=k, lpips_weight=1.0,
            warmup_steps=2, steps=8))


def _fit(cfg, steps, writer=None):
    images = [np.random.default_rng(i).integers(0, 256, (80, 96, 3),
                                                dtype=np.uint8)
              for i in range(2)]
    data = train_crop_iterator(images, cfg.train.batch_size,
                               cfg.train.crop_size, seed=1, as_uint8=True)
    return train.fit(cfg, data, writer=writer, num_steps=steps,
                     device="cpu")


def test_fit_records_a_chunk_of_k_steps():
    k = 2
    records, _ = _records(lambda: _fit(_fit_cfg(k), 2 * k,
                                       writer=lambda s, m: None))
    assert [r.name for r in records] == ["train.setup", "train.chunk",
                                         "train.chunk"]
    for rec in records[1:]:
        assert profiling.count(rec, "train.chunk", "steps") == k
        assert profiling.calls(rec, "train.data") == 1
        assert profiling.calls(rec, "train.log") == 1
        names = {s[0]: s[2] for s in rec.spans}
        steps = [s[0] for s in rec.spans if s[2] == "train.step"]
        assert len(steps) == k
        for sid in steps:
            kids = sorted((s[3], s[2]) for s in rec.spans if s[1] == sid)
            assert [n for _, n in kids] == [
                "train.draws", "train.forward", "train.backward",
                "train.grad_norm", "train.optimizer", "train.ema"]
        parent = {s[0]: s[1] for s in rec.spans}

        def ancestors(i):
            while parent[i] is not None:
                i = parent[i]
                yield names[i]
        for s in rec.spans:
            if s[2] in ("train.lpips", "model.unet", "unet.res"):
                assert "train.forward" in set(ancestors(s[0])), s[2]
        assert profiling.calls(rec, "train.all_reduce") == 0
        assert _covered(rec) < 0.05


# ---- no change to results ----

def test_decode_is_bit_equal_under_the_profiler(space_channel):
    rt, blob = space_channel
    plain = rt.decompress(blob, noise=_noise(rt))
    with _cpu_profile():
        rec, traced = _one(lambda: rt.decompress(blob, noise=_noise(rt)))
    assert rec.profiled
    np.testing.assert_array_equal(plain, traced)


def test_fit_loss_is_bit_equal_under_the_profiler():
    cfg = _fit_cfg(1)
    losses = []
    _fit(cfg, 2, writer=lambda s, m: losses.append(m["loss"]))
    with _cpu_profile():
        records, _ = _records(lambda: _fit(
            cfg, 2, writer=lambda s, m: losses.append(m["loss"])))
    assert all(r.profiled for r in records)
    assert losses[:2] == losses[2:]
