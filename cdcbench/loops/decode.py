"""The served decode, closed loop: a pool of bitstreams, decoded round-robin
through ``CodecRuntime.decompress(blob, noise=ε)``, each request with its
own ε from the seed.

Set-up makes the traffic's pool of seeded images and their bitstreams, at
the ladder's first row or at a quality drawn from the seed. The benchmark
writes them itself: the reference quantizes each image in f32 and codes it
with its own tables and the pure-Python coder into the port's container (no
γ in the header: the decode blends at the configuration's ``blend_gamma``).
Then it builds the port's runtime and decodes each bitstream once to warm
every shape. The peak device memory is counted from there.

``correct``: for a seeded sample of the requests the window finished, the
reference decodes its own ŷ of that bitstream with the request's ε in f32
(the conditioning head, g_s, the five UNet steps, the blend).
``off2_share``, the widest over the sample: the share of the port's uint8
values that lie two levels or more from the reference's. A desynced rANS
stream, a wrong row index, hyper stage or context pass shows there as a
wrong ŷ. (The RMS gap is carried by a few hundred values on some latents,
where the bf16 chain strays by 3 to 7 levels, and does not part the port's
bf16 from the fp8 control by three times.)
"""

from __future__ import annotations

import numpy as np

from cdcbench import core, serving
from cdcbench.spans import Spans


class State:
    rt = None
    spans = None
    loop = None


def setup(run: core.Run) -> State:
    import torch
    st = State()
    st.images = serving.images(run)
    st.qualities = serving.qualities(run)
    ref = serving.reference(run)
    st.blobs, st.y_hats = zip(*[ref.write_blob(img, q) for img, q in
                               zip(st.images, st.qualities)])
    del ref
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.device)
    st.rt = serving.port_runtime(run)
    shape = serving.padded_shape(run)
    for k, blob in enumerate(st.blobs):
        st.rt.decompress(blob, noise=serving.noise(run, k, shape,
                                                     serving.TAG_WARM))
    if run.trace:
        st.spans = Spans()
        st.spans.install(st.rt)
    return st


def window(run: core.Run, st: State) -> core.Window:
    shape, pool = serving.padded_shape(run), len(st.blobs)

    def request(i):
        eps = serving.noise(run, i, shape)
        return st.rt.decompress(st.blobs[i % pool], noise=eps)
    st.setup_s = core.now() - run.t0
    st.loop = loop = serving.closed_loop(run, request)
    ms = 1e3 * np.asarray(loop.latencies)
    return core.Window(
        metrics={"setup_s": st.setup_s,
                 "decode_ms.p50": core.quantile(ms, 0.50),
                 "decode_ms.p95": core.quantile(ms, 0.95)},
        attempted=len(ms), failed=loop.failed)


def trace_view(run: core.Run, st: State, win: core.Window):
    from cdcbench import counts
    t = run.traffic
    return serving.trace_view(run, st.loop, st.spans, counts.decode_counts(
        run.config["config"], t["height"], t["width"]))


def release(st: State) -> None:
    st.rt = None


def reference_images(run: core.Run, st: State, ref, control: bool = False):
    """The reference's image for each kept request, in f32 (or, for the
    control, with the port's bf16 products in fp8 and its f32 ones in
    TF32)."""
    import contextlib

    import torch

    from cdcbench.reference.ops.layers import fp8_products
    shape, pool = serving.padded_shape(run), len(st.images)
    gamma = run.config["config"]["sample"]["blend_gamma"]
    h, w = run.traffic["height"], run.traffic["width"]
    out = {}
    ctx = fp8_products() if control else contextlib.nullcontext()
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    ref.set_control(control)
    try:
        with ctx:
            for i in sorted(st.loop.kept):
                p = i % pool
                q = 0 if st.qualities[p] is None else st.qualities[p]
                out[i] = ref.serve(st.y_hats[p].to(run.device),
                                   serving.noise(run, i, shape), q, gamma, h,
                                   w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref.set_control(False)
    return out


def off2_share(got: np.ndarray, want: np.ndarray) -> float:
    """The share of values two uint8 levels or more apart."""
    return float(np.mean(np.abs(got.astype(np.int16)
                                - want.astype(np.int16)) >= 2))


def judge(run: core.Run, st: State, win: core.Window) -> list:
    ref = serving.reference(run)
    want = reference_images(run, st, ref)
    limit = run.limits["off2_share"]
    gaps = [1.0 if isinstance(got, Exception) else off2_share(got, want[i])
            for i, got in st.loop.kept.items()]
    checks = [core.Check("off2_share", max(gaps), limit)]
    if run.control:
        ctl = reference_images(run, st, ref, control=True)
        checks.append(core.Check(
            "control_off2_share",
            max(off2_share(ctl[i], want[i]) for i in ctl), limit))
    return checks
