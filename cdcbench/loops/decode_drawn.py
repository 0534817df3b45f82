"""The served decode with a drawn refiner, closed loop: as ``decode``, a pool
of bitstreams decoded round-robin through ``CodecRuntime.decompress(blob,
noise=ε)``, each request with its own ε from the seed, for a configuration
whose refiner has no trained weights in the repo (a DiT; ``model.refiner``
of the configuration file).

Set-up makes the pool's seeded images and their bitstreams with the
reference, at the ladder's first row, as ``decode`` does. It draws the
refiner itself, into the plain DiT of ``reference.dit`` (``draw_dit``: a CPU
generator seeded from ``--seed``), so the reference's weights come from no
code of the port. Then it builds the port's model: the arrays of the weights
file for the codec and the conditioning head, and the drawn DiT's state
loaded strictly into the port's refiner; and decodes each bitstream once to
warm every shape. The peak device memory is counted from there.

``correct``: for a seeded sample of the requests the window finished, the
reference (``reference.dit_codec``: the reference codec with the plain DiT,
carrying the drawn f32 weights) decodes its own ŷ of that bitstream with the
request's ε in f32; ``off2_share``, the widest over the sample, is the share
of the port's uint8 values two levels or more from the reference's.

A port whose configuration has no ``refiner`` fails the set-up at once,
before any image is made.
"""

from __future__ import annotations

import dataclasses
import pathlib

from cdcbench import core, run, serving

TAG_REFINER = 6
# The plain decode loop, whose window and comparison this one shares.
_decode = run.load_module(pathlib.Path(__file__).with_name("decode.py"))


class State:
    rt = None
    spans = None
    loop = None
    dit_state = None


def _port_config(run: core.Run):
    from tpucdc_torch import config as port_config

    from cdcbench.reference.codec_ref import from_dict
    refiner = run.config["config"]["model"]["refiner"]
    if "refiner" not in {f.name for f in
                         dataclasses.fields(port_config.ModelConfig)}:
        raise SystemExit(f"cdcbench: this port has no refiner kind; "
                         f"{run.workload} needs model.refiner={refiner!r}")
    return from_dict(port_config.Config, run.config["config"]).validated()


def draw_dit(config: dict, seed: int) -> dict:
    """The plain DiT of ``config`` (a configuration file's ``config``) drawn
    from ``seed``, in ``named_parameters`` order on a CPU generator: every
    matrix and convolution weight from N(0, 1/fan_in), every bias and the
    null-class row from N(0, 0.02²). Nothing is left at zero, where DiT
    initialises adaLN-Zero and the final layer: a block at zero is the
    identity, and a layer the port maps wrongly would not show. Its f32
    state, in the port's names."""
    import torch

    from cdcbench.reference.dit import DiTReference
    dit = DiTReference.from_config(config["model"]["dit"])
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in dit.parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen)
                        / (p.numel() // p.shape[0]) ** 0.5)
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    return dit.state_dict()


def _port_model(run: core.Run, cfg, dit_state: dict):
    """The port's model: the weights file's arrays for everything but the
    refiner (its UNet arrays left out), strictly, and ``dit_state`` for the
    DiT."""
    from tpucdc_torch.model import CDCModel
    from tpucdc_torch.utils import load_params_npz
    model = CDCModel(cfg.model)
    state, _ = load_params_npz(core.ROOT / run.config["weights"])
    missing, unexpected = model.load_state_dict(
        {k: v for k, v in state.items() if not k.startswith("unet.")},
        strict=False)
    absent = [k for k in missing if not k.startswith("dit.")]
    if absent or unexpected:
        raise SystemExit(f"cdcbench: {run.config['weights']} does not fit "
                         f"the model outside the refiner: missing "
                         f"{absent[:3]}, unexpected {unexpected[:3]}")
    model.refiner.load_state_dict(dit_state, strict=True)
    return model


def setup(run: core.Run) -> State:
    import torch

    from tpucdc_torch.pipelines.codec_runtime import CodecRuntime
    from tpucdc_torch.runtime import BF16_POLICY, F32_POLICY
    cfg = _port_config(run)
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
    # The drawn f32 refiner, kept on the host for the reference: the
    # runtime moves the model's parameters to the card.
    st.dit_state = draw_dit(run.config["config"],
                            core.seed_words(run.seed, TAG_REFINER))
    model = _port_model(run, cfg, st.dit_state)
    policy = {"bf16": BF16_POLICY, "f32": F32_POLICY}[run.config["policy"]]
    st.rt = CodecRuntime(cfg, model, device=run.device, policy=policy)
    shape = serving.padded_shape(run)
    for k, blob in enumerate(st.blobs):
        st.rt.decompress(blob, noise=serving.noise(run, k, shape,
                                                     serving.TAG_WARM))
    if run.trace:
        from cdcbench.spans import Spans
        st.spans = Spans()
        st.spans.install(st.rt)
    return st


window = _decode.window
release = _decode.release


def trace_view(run: core.Run, st: State, win: core.Window):
    from cdcbench import counts_dit
    t = run.traffic
    return serving.trace_view(run, st.loop, st.spans, counts_dit.decode_counts(
        run.config["config"], t["height"], t["width"]))


def judge(run: core.Run, st: State, win: core.Window) -> list:
    from cdcbench.reference.dit_codec import RefDiTCodec
    ref = RefDiTCodec(run.config["config"], core.ROOT / run.config["weights"],
                      run.device, st.dit_state)
    want = _decode.reference_images(run, st, ref)
    limit = run.limits["off2_share"]
    gaps = [1.0 if isinstance(got, Exception)
            else _decode.off2_share(got, want[i])
            for i, got in st.loop.kept.items()]
    checks = [core.Check("off2_share", max(gaps), limit)]
    if run.control:
        ctl = _decode.reference_images(run, st, ref, control=True)
        checks.append(core.Check(
            "control_off2_share",
            max(_decode.off2_share(ctl[i], want[i]) for i in ctl), limit))
    return checks
