"""The publisher's encode, closed loop: a pool of seeded images encoded
round-robin through ``CodecRuntime.compress(img, optimize_gamma=<the
traffic's>, noise=ε)``, each request with its own ε from the seed. Set-up
warms up with one encode of the same kind.

``correct``: for a seeded sample of the encodes the window finished, the
reference reads the port's bitstream with its own coder tables and the
pure-Python coder, and works the encode out again from the image, the
weights and ε (analysis and quantization in f32, its own γ search on f32
decodes). ``psnr_loss_db``, the widest over the sample: the served PSNR of
the reference's own encode less that of the port's bitstream, both decoded
by the reference in f32 with ε, at each bitstream's own γ or γ grid. (The
share of symbols that differ from the reference's does not part the port's
bf16 from the fp8 control by three times, and is not compared.)
"""

from __future__ import annotations

import contextlib

import numpy as np

from cdcbench import core, serving
from cdcbench.spans import Spans


class State:
    rt = None
    spans = None
    loop = None


def setup(run: core.Run) -> State:
    st = State()
    st.rt = serving.port_runtime(run)
    st.images = serving.images(run)
    st.search = run.traffic["optimize_gamma"]
    st.rt.compress(st.images[0], optimize_gamma=st.search,
                   noise=serving.noise(run, 0, serving.padded_shape(run),
                                       serving.TAG_WARM))
    if run.trace:
        st.spans = Spans()
        st.spans.install(st.rt)
    return st


def window(run: core.Run, st: State) -> core.Window:
    shape, pool = serving.padded_shape(run), len(st.images)

    def request(i):
        return st.rt.compress(st.images[i % pool], optimize_gamma=st.search,
                              noise=serving.noise(run, i, shape))
    st.setup_s = core.now() - run.t0
    st.loop = loop = serving.closed_loop(run, request)
    n = len(loop.latencies)
    return core.Window(
        metrics={"setup_s": st.setup_s,
                 "encode_ms.mean": 1e3 * loop.seconds / n},
        attempted=n, failed=loop.failed)


def trace_view(run: core.Run, st: State, win: core.Window):
    from cdcbench import counts
    t = run.traffic
    return serving.trace_view(run, st.loop, st.spans, counts.encode_counts(
        run.config["config"], t["height"], t["width"],
        t["search_decodes"]))


def release(st: State) -> None:
    st.rt = None


def _served(ref, img, y_hat, eps, gamma, grid):
    h, w = img.shape[:2]
    g = gamma if grid is None else np.asarray(grid, np.float32) / 255.0
    return ref.serve(y_hat, eps, 0, g, h, w)


def reference_encodes(run: core.Run, st: State, ref, control: bool = False):
    """Per kept request: (ŷ, γ, grid) of the reference's own encode, in f32 (the control: the port's bf16 products
    in fp8, its f32 ones in TF32)."""
    import torch

    from cdcbench.reference.ops.layers import fp8_products
    shape, pool = serving.padded_shape(run), len(st.images)
    out = {}
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    ref.set_control(control)
    try:
        with fp8_products() if control else contextlib.nullcontext():
            for i in sorted(st.loop.kept):
                img = st.images[i % pool]
                y_hat = ref.analyse(img)[2]
                g, grid = ref.gamma_search(img, y_hat,
                                           serving.noise(run, i, shape))
                out[i] = (y_hat, g, grid)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref.set_control(False)
    return out


def _loss(run, st, ref, mine, theirs) -> float:
    """The widest PSNR loss in dB of ``theirs`` = (ŷ, γ, grid) against the
    reference's own encode ``mine`` of each request."""
    losses = []
    shape, pool = serving.padded_shape(run), len(st.images)
    for i, (y_hat, g, grid) in mine.items():
        if isinstance(theirs[i], Exception):
            return np.inf
        t_hat, tg, tgrid = theirs[i]
        img, eps = st.images[i % pool], serving.noise(run, i, shape)
        losses.append(serving.psnr(_served(ref, img, y_hat, eps, g, grid), img)
                      - serving.psnr(_served(ref, img, t_hat, eps, tg, tgrid),
                                     img))
    return max(losses)


def _read(ref, blob):
    if isinstance(blob, Exception):
        return blob
    try:
        hdr, _, _, y_hat = ref.read_blob(blob)
    except (ValueError, IndexError) as e:
        return e
    return y_hat, hdr.gamma_or_none, hdr.gamma_grid


def judge(run: core.Run, st: State, win: core.Window) -> list:
    ref = serving.reference(run)
    mine = reference_encodes(run, st, ref)
    theirs = {i: _read(ref, b) for i, b in st.loop.kept.items()}
    limit = run.limits["psnr_loss_db"]
    checks = [core.Check("psnr_loss_db", _loss(run, st, ref, mine, theirs),
                         limit)]
    if run.control:
        ctl = reference_encodes(run, st, ref, control=True)
        checks.append(core.Check("control_psnr_loss_db",
                                 _loss(run, st, ref, mine, ctl), limit))
    return checks
