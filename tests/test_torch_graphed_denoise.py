"""The refiner's UNet step as a CUDA graph (``sampling.graphed``).

On the CPU (tier 1):

* A decode on the CPU engages no graph: it records no ``unet.replay`` and
  no ``unet.capture``, its ``unet.*`` block spans are those of the eager
  loop, and its uint8 image is bit-equal to a decode whose net calls skip
  the ``GraphedDenoiser`` altogether (plain DDIM, guidance, block-cached
  DDIM).
* ``GraphedDenoiser``'s cache, with the capture replaced by a stub whose
  "graph" runs the net function on the static buffers: one capture a key
  (device, dtype, shape, strides, None inputs), every call a replay on
  fresh inputs, the least recently used of ``MAX_GRAPHS`` keys evicted,
  the launch counter moved once a call, and no engagement off the card or
  outside ``torch.inference_mode``.

On the card (``cuda``; they skip here): graphed decodes against the same
runtime's eager decodes of the same inputs, bit-equal in uint8, with equal
``_kernels.LAUNCHES`` deltas, and no capture at a second decode of a shape:
three flagship decodes at 768×512 with different ε, ``vr_wide`` at two
continuous qualities in a row, the spatial γ search and its v5 grid,
``decompress_many`` of 3 bitstreams, the tiled decode, a short DDPM chain,
a guided decode; block-cached DDIM and a second thread stay eager. On a
machine with a card (JAX need not be there, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_graphed_denoise.py -q
"""

import contextlib
import dataclasses
import pathlib
import threading

import numpy as np
import pytest
import torch

from tpucdc_torch import presets
from tpucdc_torch.model import CDCModel
from tpucdc_torch.ops import _kernels
from tpucdc_torch.pipelines import CodecRuntime
from tpucdc_torch.runtime import F32_POLICY
from tpucdc_torch.sampling import graphed
from tpucdc_torch.utils import draw_weights, profiling, span

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMG = np.random.default_rng(0).integers(0, 256, (64, 96, 3), dtype=np.uint8)
STEPS = 3


def _eager(fn, *inputs):
    """A runtime's denoiser that calls the net eagerly, always."""
    return fn(*inputs)


@contextlib.contextmanager
def eager_steps(rt):
    kept = rt._denoiser
    rt._denoiser = _eager
    try:
        yield
    finally:
        rt._denoiser = kept


def _records(fn):
    before = {r.id for r in profiling.requests()}
    out = fn()
    me = threading.get_ident()
    return [r for r in profiling.requests()
            if r.id not in before and r.thread == me], out


def _calls(records, name):
    return sum(profiling.calls(r, name) for r in records)


# ---- the CPU: no graph, the eager loop as it was ----

def _cpu_runtime(**sample) -> CodecRuntime:
    cfg = presets.tiny()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, prediction="residual"),
        sample=dataclasses.replace(cfg.sample, steps=STEPS,
                                   truncate_frac=0.15, blend_gamma=0.5,
                                   **sample))
    model = CDCModel(cfg.model)
    with torch.no_grad():
        draw_weights(model, 3)
    return CodecRuntime(cfg, model, device="cpu", policy=F32_POLICY)


@pytest.fixture(scope="module")
def cpu_rt():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rt = _cpu_runtime()
    yield rt, rt.compress(IMG)
    torch.set_num_threads(n)


def _noise():
    return torch.randn((1, 64, 128, 3),
                       generator=torch.Generator().manual_seed(5))


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_cpu_decode_engages_no_graph(cpu_rt, guidance):
    rt, blob = cpu_rt
    records, got = _records(lambda: rt.decompress(
        blob, noise=_noise(), guidance=guidance))
    assert _calls(records, "unet.replay") == _calls(
        records, "unet.capture") == 0
    for name in ("ddim.step", "unet.stem", "unet.out"):
        assert _calls(records, name) == STEPS, name
    with eager_steps(rt):
        eager, want = _records(lambda: rt.decompress(
            blob, noise=_noise(), guidance=guidance))
    np.testing.assert_array_equal(got, want)
    for name in ("unet.res", "unet.attn", "unet.resample"):
        assert _calls(records, name) == _calls(eager, name) > 0, name


def test_cpu_blockcached_decode_is_unchanged():
    rt = _cpu_runtime(cache_period=2)
    blob = rt.compress(IMG)
    records, got = _records(lambda: rt.decompress(blob, noise=_noise()))
    assert _calls(records, "unet.replay") == 0
    assert _calls(records, "unet.stem") == STEPS
    with eager_steps(rt):
        np.testing.assert_array_equal(
            got, rt.decompress(blob, noise=_noise()))


# ---- the cache, with a stub capture ----

class _StubGraph:
    """Replays by running the net function on the static buffers."""

    def __init__(self, fn, inputs, output):
        self.fn, self.inputs, self.output = fn, inputs, output
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.output.copy_(self.fn(*self.inputs))


STUB_LAUNCHES = {"gn_silu": 3, "attention": 2}


def _stub_denoiser():
    d = graphed.GraphedDenoiser()
    d.captured = []

    def capture(fn, inputs):
        static = tuple(None if t is None else t.clone() for t in inputs)
        output = fn(*static).clone()
        step = graphed.CapturedStep(_StubGraph(fn, static, output), static,
                                    output, dict(STUB_LAUNCHES))
        d.captured.append(graphed.graph_key(inputs))
        return step

    d.engages = lambda x_t: True
    d._capture = capture
    return d


def _net(x_t, t, cond_f, cond_t, x_bar):
    out = 2.0 * x_t + t.to(x_t.dtype)[:, None, None, None]
    out = out + cond_f.mean() + cond_t.sum()
    return out if x_bar is None else out - x_bar


def _inputs(seed, b=1, h=8, w=12, dtype=torch.float32, x_bar=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, 3), generator=g).to(dtype)
    return (x, torch.full((b,), seed, dtype=torch.int32),
            torch.randn((b, h // 2, w // 2, 4), generator=g),
            torch.randn((b, 6, 5), generator=g),
            torch.randn((b, h, w, 3), generator=g).to(dtype) if x_bar
            else None)


def test_one_capture_a_key_and_a_replay_a_call():
    d = _stub_denoiser()
    before = dict(_kernels.LAUNCHES)
    outs = []

    def request():
        with span("test.request"):
            for seed in (1, 2, 3):
                outs.append(d(_net, *_inputs(seed)).clone())
                np.testing.assert_array_equal(outs[-1], _net(*_inputs(seed)))
    (rec,), _ = _records(request)
    assert profiling.calls(rec, "unet.capture") == 1
    assert profiling.count(rec, "unet.capture", "kernels") == 5
    assert profiling.calls(rec, "unet.replay") == 3
    assert len(d.captured) == 1
    assert not torch.equal(outs[0], outs[1])
    for name, n in STUB_LAUNCHES.items():
        assert _kernels.LAUNCHES[name] - before[name] == 3 * n


def test_the_output_is_the_graphs_static_tensor():
    d = _stub_denoiser()
    a = d(_net, *_inputs(1))
    b = d(_net, *_inputs(2))
    assert a is b
    np.testing.assert_array_equal(b, _net(*_inputs(2)))


@pytest.mark.parametrize("change", ["batch", "size", "dtype", "strides",
                                    "no_x_bar"])
def test_a_new_key_captures_anew(change):
    d = _stub_denoiser()
    d(_net, *_inputs(1))
    other = {
        "batch": lambda: _inputs(2, b=2),
        "size": lambda: _inputs(2, h=16),
        "dtype": lambda: _inputs(2, dtype=torch.float64),
        "strides": lambda: tuple(
            t.transpose(1, 2).contiguous().transpose(1, 2) if k in (0, 4)
            else t for k, t in enumerate(_inputs(2))),
        "no_x_bar": lambda: _inputs(2, x_bar=False),
    }[change]()
    got = d(_net, *other)
    np.testing.assert_array_equal(got, _net(*other))
    assert len(d.captured) == 2
    d(_net, *_inputs(3))
    assert len(d.captured) == 2


def test_the_least_recently_used_key_is_evicted():
    d = _stub_denoiser()
    sizes = [8 * (k + 1) for k in range(graphed.MAX_GRAPHS)]
    for h in sizes:
        d(_net, *_inputs(h, h=h))
    d(_net, *_inputs(0, h=sizes[0]))            # the oldest, used again
    assert len(d.captured) == graphed.MAX_GRAPHS
    d(_net, *_inputs(1, h=200))                 # evicts sizes[1]
    assert len(d._steps) == graphed.MAX_GRAPHS
    d(_net, *_inputs(2, h=sizes[0]))
    assert len(d.captured) == graphed.MAX_GRAPHS + 1
    d(_net, *_inputs(3, h=sizes[1]))
    assert len(d.captured) == graphed.MAX_GRAPHS + 2
    assert d.captured[-1] == graphed.graph_key(_inputs(3, h=sizes[1]))


def test_no_engagement_off_the_card_or_with_autograd():
    d = graphed.GraphedDenoiser()
    x = torch.zeros(1, 8, 8, 3)
    with torch.inference_mode():
        assert not d.engages(x)
    with torch.no_grad():
        assert not d.engages(x)
    calls = []

    def net(*inputs):
        calls.append(1)
        return _net(*inputs)

    with torch.inference_mode():
        got = d(net, *_inputs(4))
    np.testing.assert_array_equal(got, _net(*_inputs(4)))
    assert calls == [1] and not d._steps


# ---- the card ----

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs capture CUDA work only")
    return torch.device("cuda")


def _load(card, preset):
    from tpucdc_torch import api
    from tpucdc_torch.runtime import BF16_POLICY
    cfg = getattr(presets, preset)()
    weights = {"flagship_serving": "flagship_params.npz",
               "vr_wide_serving": "vr_wide_params.npz"}[preset]
    model = api.load_model(cfg, str(ROOT / "artifacts" / weights))
    return CodecRuntime(cfg, model, device=card, policy=BF16_POLICY)


@pytest.fixture(scope="module")
def flagship(card):
    return _load(card, "flagship_serving")


@pytest.fixture(scope="module")
def image768():
    return np.load(ROOT / "tpucdc_torch" / "fixtures" /
                   "image_768x512.npz")["image_u8"]


def _eps(card, shape, seed):
    return torch.randn(shape, generator=torch.Generator(card).manual_seed(
        seed), device=card)


def _graphed_and_eager(rt, call):
    """(graphed records, graphed output, its launches), and the eager
    output and launches, of ``call()`` on ``rt``."""
    def run():
        _kernels.reset_launches()
        records, out = _records(call)
        torch.cuda.synchronize()
        return records, out, dict(_kernels.LAUNCHES)
    records, got, launches = run()
    with eager_steps(rt):
        eager_records, want, eager_launches = run()
    assert _calls(eager_records, "unet.replay") == 0
    assert launches == eager_launches
    return records, got, want


def _same(got, want):
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(got, bytes):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_flagship_decodes_with_three_eps(card, flagship, image768):
    rt = flagship
    blob = rt.compress(image768)
    shape = (1, 512, 768, 3)
    for k in range(3):
        records, got, want = _graphed_and_eager(
            rt, lambda: rt.decompress(blob, noise=_eps(card, shape, k)))
        _same(got, want)
        steps = _calls(records, "ddim.step")
        assert steps == _calls(records, "unet.replay") == 5
        if k:
            assert _calls(records, "unet.capture") == 0
    _kernels.reset_launches()
    rt.decompress(blob)
    assert _kernels.LAUNCHES == {"gn_silu": 93, "attention": 60, "adaln": 0}


@pytest.mark.cuda
def test_vr_wide_at_two_qualities_in_a_row(card, image768):
    rt = _load(card, "vr_wide_serving")
    img = image768[:256, :384]
    blobs = [rt.compress(img, quality=q) for q in (0.5, 1.7)]
    for _ in range(2):
        for blob in blobs:
            records, got, want = _graphed_and_eager(
                rt, lambda: rt.decompress(blob, noise=_eps(
                    card, (1, 256, 384, 3), 7)))
            _same(got, want)
            assert _calls(records, "unet.replay") == 5
    assert _calls(records, "unet.capture") == 0


@pytest.mark.cuda
def test_spatial_gamma_search_and_its_grid(card, flagship, image768):
    rt = flagship
    img = image768[:256, :384]
    eps = _eps(card, (1, 256, 384, 3), 3)
    records, blob, want_blob = _graphed_and_eager(
        rt, lambda: rt.compress(img, optimize_gamma="spatial", noise=eps))
    _same(blob, want_blob)
    assert _calls(records, "unet.replay") == 30
    assert _calls(records, "unet.capture") <= 1
    records, got, want = _graphed_and_eager(
        rt, lambda: rt.decompress(blob, noise=eps))
    _same(got, want)
    assert _calls(records, "unet.capture") == 0


@pytest.mark.cuda
def test_decompress_many_of_three(card, flagship, image768):
    rt = flagship
    blobs = [rt.compress(image768[y:y + 256, x:x + 384])
             for y, x in ((0, 0), (256, 384), (128, 192))]
    for _ in range(2):
        records, got, want = _graphed_and_eager(
            rt, lambda: rt.decompress_many(blobs))
        _same(got, want)
        assert _calls(records, "unet.replay") == 15
    assert _calls(records, "unet.capture") == 0


@pytest.mark.cuda
def test_tiled_decode(card, flagship, image768):
    rt = flagship
    blob = rt.compress(image768[:256, :384])
    for _ in range(2):
        records, got, want = _graphed_and_eager(
            rt, lambda: rt.decompress_tiled(blob, tile=128, halo=32))
        _same(got, want)
    assert _calls(records, "unet.capture") == 0
    assert _calls(records, "unet.replay") == 5


@pytest.mark.cuda
def test_guided_decode(card, flagship, image768):
    rt = flagship
    blob = rt.compress(image768[:256, :384])
    for seed in (1, 2):
        records, got, want = _graphed_and_eager(
            rt, lambda: rt.decompress(blob, guidance=2.0, noise=_eps(
                card, (1, 256, 384, 3), seed)))
        _same(got, want)
    assert _calls(records, "unet.capture") == 0
    assert _calls(records, "unet.replay") == 5


@pytest.mark.cuda
def test_short_ddpm_chain(card):
    from tpucdc_torch.runtime import BF16_POLICY
    cfg = presets.tiny()
    model_cfg = dataclasses.replace(
        cfg.model, prediction="eps",
        schedule=dataclasses.replace(cfg.model.schedule, num_steps=12))
    cfg = dataclasses.replace(cfg, model=model_cfg, sample=dataclasses.replace(
        cfg.sample, sampler="ddpm"))
    model = CDCModel(cfg.model)
    with torch.no_grad():
        draw_weights(model, 4)
    rt = CodecRuntime(cfg, model, device=card, policy=BF16_POLICY)
    img = np.random.default_rng(1).integers(0, 256, (64, 128, 3),
                                            dtype=np.uint8)
    blob = rt.compress(img)
    for seed in (1, 2):
        records, got, want = _graphed_and_eager(
            rt, lambda: rt.decompress(blob, generator=torch.Generator(
                card).manual_seed(seed)))
        _same(got, want)
        assert _calls(records, "ddpm.step") == _calls(
            records, "unet.replay") == 12
    assert _calls(records, "unet.capture") == 0


@pytest.mark.cuda
def test_blockcached_and_another_thread_stay_eager(card, flagship, image768):
    rt = flagship
    blob = rt.compress(image768[:256, :384])
    eps = _eps(card, (1, 256, 384, 3), 9)
    want = rt.decompress(blob, noise=eps)
    got = {}

    def other():
        records, got["image"] = _records(lambda: rt.decompress(
            blob, noise=eps))
        got["replays"] = _calls(records, "unet.replay")
    thread = threading.Thread(target=other)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert got["replays"] == 0
    _same(got["image"], want)
    cached = CodecRuntime(dataclasses.replace(
        rt.config, sample=dataclasses.replace(rt.config.sample,
                                              cache_period=2)),
        rt.model, device=card, policy=rt.policy)
    records, _ = _records(lambda: cached.decompress(blob, noise=eps))
    assert _calls(records, "unet.replay") == _calls(
        records, "unet.capture") == 0
