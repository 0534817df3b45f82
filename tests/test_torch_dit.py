"""The DiT refiner (``diffusion.dit``) against its plain reference
(``tpucdc_torch/reference/dit.py``), on the CPU at tiny sizes.

* The forward, F32, within 1e-5 relative, on a square and a rectangular grid.
* ``CodecRuntime.decompress`` of a tiny model with ``refiner="dit"`` under
  F32_POLICY against a decode whose denoiser is the reference: uint8 within
  one level.
* One training loss and its gradient against the same model with the
  reference in the DiT's place.
* ``draw_weights``: the same seed, the same DiT, and no adaLN or final weight
  left at zero; ``init_weights``: adaLN-Zero.
* ``dit_xl2_serving()`` on the meta device: 28 blocks, 674–676M refiner
  parameters, 6144 tokens at 768×512; ``cache_period > 1`` raises; the CLI's
  ``--set model.refiner=dit`` (its config, ``load_model``, and a compress and
  decompress); the spatial γ search through the DiT; the reference imports
  nothing of the port.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from tpucdc_torch import api, presets
from tpucdc_torch.config import Config, DiTConfig
from tpucdc_torch.diffusion.dit import DiT
from tpucdc_torch.model import CDCModel
from tpucdc_torch.ops import make_schedule
from tpucdc_torch.pipelines import CodecRuntime
from tpucdc_torch.pipelines import train as train_lib
from tpucdc_torch.reference.dit import DiTReference
from tpucdc_torch.runtime import F32_POLICY, set_policy
from tpucdc_torch.sampling import ddim_sample
from tpucdc_torch.utils import draw_weights, load_params_npz, profiling
from tpucdc_torch.utils.weights import init_weights

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_DIT = DiTConfig(hidden=144, depth=2, heads=2, patch=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_dit_config(steps: int = 3) -> Config:
    """The tiny preset with a DiT refiner (2 heads of 72, depth 2) and the
    served flagship's refiner dial."""
    cfg = presets.tiny()
    model = dataclasses.replace(cfg.model, refiner="dit", dit=TINY_DIT,
                                prediction="residual")
    sample = dataclasses.replace(cfg.sample, steps=steps, truncate_frac=0.15,
                                 blend_gamma=0.5)
    return dataclasses.replace(cfg, model=model, sample=sample).validated()


def _randomised(module, seed: int):
    """Draw the weights, then give the biases and the null row values, so
    that every parameter reaches the output."""
    draw_weights(module, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias") or name.endswith("null_class"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return module


def _reference_of(dit: DiT) -> DiTReference:
    ref = DiTReference.from_config(dataclasses.asdict(dit.config))
    ref.load_state_dict(dit.state_dict(), strict=True)
    return ref.eval()


@pytest.mark.parametrize("hw", [(32, 32), (32, 48)], ids=["square", "rect"])
def test_forward_matches_reference(hw):
    cfg = dataclasses.replace(TINY_DIT, in_channels=6, cond_channels=8)
    dit = _randomised(DiT(cfg, F32_POLICY).eval(), 3)
    ref = _reference_of(dit)
    gen = torch.Generator().manual_seed(hw[1])
    h, w = hw
    x = torch.randn((2, h, w, 6), generator=gen)
    cond = torch.randn((2, h // 4, w // 4, 8), generator=gen)
    t = torch.tensor([3, 700])
    with torch.no_grad():
        got, want = dit(x, t, cond), ref(x, t, cond)
    assert got.shape == want.shape == (2, h, w, 3)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel < 1e-5, rel


def test_position_embedding_follows_the_grid():
    """The port's embedding is DiT's on a square grid and on the input's
    own rectangular one."""
    from tpucdc_torch.diffusion.dit import pos_embed_2d
    from tpucdc_torch.reference.dit import pos_embed
    for rows, cols in [(4, 4), (3, 5)]:
        got = pos_embed_2d(16, rows, cols)
        want = torch.from_numpy(pos_embed(16, rows, cols)).float()
        torch.testing.assert_close(got, want, atol=1e-7, rtol=0)
    # Column first: tokens of one row differ in the first half only.
    e = pos_embed_2d(16, 3, 5)
    assert torch.equal(e[0, 8:], e[1, 8:]) and not torch.equal(e[0, :8],
                                                               e[1, :8])


@pytest.fixture(scope="module")
def tiny_runtime():
    cfg = tiny_dit_config()
    model = _randomised(CDCModel(cfg.model), 5)
    rt = CodecRuntime(cfg, model, device="cpu", policy=F32_POLICY)
    img = np.random.default_rng(0).integers(0, 256, (64, 96, 3),
                                            dtype=np.uint8)
    return rt, rt.compress(img)


def test_decompress_matches_reference_decode(tiny_runtime):
    rt, blob = tiny_runtime
    cfg, model = rt.config, rt.model
    eps = torch.randn((1, 64, 128, 3),
                      generator=torch.Generator().manual_seed(7))
    got = rt.decompress(blob, noise=eps)
    ref = _reference_of(model.dit)
    with torch.inference_mode():
        y_hat, _ = rt.decode_latent(blob)
        cond_f, _ = model.cond_signal(y_hat)
        x_bar = model.synthesize(y_hat)
        x0 = ddim_sample(
            lambda x_t, t: ref(torch.cat([x_t, x_bar], -1), t, cond_f),
            make_schedule("cosine", cfg.model.schedule.num_steps),
            tuple(eps.shape), num_steps=cfg.sample.steps, noise=eps,
            device="cpu", x_ref=x_bar, tables=rt._decode_tables(
                cfg.sample.steps, 0.0), prediction="residual")
        x = x_bar + 0.5 * (x0 - x_bar)
        want = torch.clamp((x + 1.0) * 127.5 + 0.5, 0, 255).to(torch.uint8)
    want = want[0, :64, :96].numpy()
    assert got.shape == want.shape
    gap = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert gap.max() <= 1
    assert not np.array_equal(got, rt.decompress(blob, noise=eps, steps=0))


def test_decode_opens_the_dit_spans(tiny_runtime):
    rt, blob = tiny_runtime
    rt.decompress(blob)
    req = [r for r in profiling.requests() if r.name == "codec.decompress"][-1]
    assert profiling.calls(req, "dit.block") == 3 * TINY_DIT.depth
    assert profiling.calls(req, "dit.embed") == profiling.calls(
        req, "dit.final") == profiling.calls(req, "ddim.step") == 3
    assert profiling.count(req, "dit.embed", "tokens") == 3 * 8 * 16
    assert profiling.calls(req, "unet.replay") == 0


def test_tiled_decode_takes_the_dit_grid(tiny_runtime):
    rt, blob = tiny_runtime
    out = rt.decompress_tiled(blob, tile=32, halo=16)
    assert out.shape == (64, 96, 3)
    with pytest.raises(ValueError, match="divisible by 8"):
        rt.decompress_tiled(blob, tile=36, halo=8)


def test_training_gradient_matches_reference():
    cfg = tiny_dit_config()
    port = _randomised(CDCModel(cfg.model), 9)
    twin = CDCModel(cfg.model)
    twin.load_state_dict(port.state_dict())
    twin.dit = _reference_of(port.dit).train()
    for m in (port, twin):
        set_policy(m, F32_POLICY)
        m.train()
    tables = train_lib.schedule_tables(cfg, "cpu")
    batch = torch.rand((2, 64, 64, 3),
                       generator=torch.Generator().manual_seed(4)) * 2 - 1
    draws = port.training_draws(batch.shape, cfg.model.schedule.num_steps,
                                generator=torch.Generator().manual_seed(8))
    grads = []
    for m in (port, twin):
        loss, _ = train_lib.loss_fn(m, batch, tables, 8.0, draws=dict(draws),
                                    distortion="both")
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in
                                      m.dit.named_parameters()}))
    (loss_p, gp), (loss_r, gr) = grads
    torch.testing.assert_close(loss_p, loss_r, rtol=1e-5, atol=0)
    assert set(gp) == set(gr)
    for name in gp:
        rel = ((gp[name] - gr[name]).norm() / gr[name].norm()).item()
        assert gr[name].norm() > 0 and rel < 1e-4, (name, rel)


def test_draw_weights_is_seeded_and_draws_the_zero_inits():
    cfg = dataclasses.replace(TINY_DIT, in_channels=6, cond_channels=8)
    a, b, c = (DiT(cfg) for _ in range(3))
    draw_weights(a, 11)
    draw_weights(b, 11)
    draw_weights(c, 12)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if pa.dim() >= 2:
            assert not torch.equal(pa, pc), name
    for dense in [blk.adaLN for blk in a.blocks] + [a.final_adaLN,
                                                    a.final_linear]:
        assert (dense.weight != 0).all()
    model = CDCModel(tiny_dit_config().model)
    init_weights(model, torch.Generator().manual_seed(0))
    d = model.dit
    for dense in [blk.adaLN for blk in d.blocks] + [d.final_adaLN,
                                                    d.final_linear]:
        assert not dense.weight.any()
    assert d.null_class.abs().max() > 0 and (d.blocks[0].qkv.weight != 0).any()


def test_dit_xl2_serving_on_the_meta_device():
    cfg = presets.dit_xl2_serving()
    d = cfg.model.dit
    assert (d.hidden, d.depth, d.heads, d.hidden // d.heads, d.patch,
            d.mlp_hidden, d.learn_sigma) == (1152, 28, 16, 72, 2, 4608, True)
    assert cfg.model.codec == presets.flagship_serving().model.codec
    assert cfg.sample == presets.flagship_serving().sample
    with torch.device("meta"):
        model = CDCModel(cfg.model)
    assert not hasattr(model, "unet") and len(model.dit.blocks) == 28
    n = sum(p.numel() for p in model.dit.parameters())
    assert 674e6 <= n <= 676e6, n
    assert model.dit.final_linear.weight.shape == (384, 1152)
    assert model.dit.x_embedder.weight.shape == (1152, 128, 2, 2)
    x = torch.zeros((1, 512, 768, 6), device="meta")
    cond = torch.zeros((1, 128, 192, 32), device="meta")
    with profiling.span("meta"), torch.inference_mode():
        out = model.dit(x, torch.zeros((1,), dtype=torch.int64,
                                       device="meta"), cond)
    req = [r for r in profiling.requests() if r.name == "meta"][-1]
    assert profiling.count(req, "dit.embed", "tokens") == 6144
    assert out.shape == (1, 512, 768, 3)


def test_block_cached_ddim_raises_with_the_dit():
    cfg = tiny_dit_config()
    cached = dataclasses.replace(cfg, sample=dataclasses.replace(
        cfg.sample, cache_period=2))
    with pytest.raises(ValueError, match="UNet's deep segment"):
        cached.validated()


def test_unknown_refiner_and_grid_are_refused():
    cfg = presets.tiny()
    with pytest.raises(ValueError, match="unknown refiner"):
        dataclasses.replace(cfg.model, refiner="vit").validated()
    with pytest.raises(ValueError, match="padded image"):
        dataclasses.replace(cfg.model, refiner="dit", dit=dataclasses.replace(
            TINY_DIT, space_to_depth=3)).validated()


def test_cli_overrides_reach_the_dit_and_load_the_flagship_codec():
    from tpucdc_torch.presets import SERVING_OVERRIDES
    overrides = {**SERVING_OVERRIDES, "model.refiner": "dit"}
    cfg = api.build_config("flagship", overrides)
    want = presets.dit_xl2_serving()
    assert (cfg.model, cfg.sample) == (want.model, want.sample)
    small = api.build_config("flagship", {
        **overrides, "model.dit.depth": "1", "model.dit.hidden": "144",
        "model.dit.heads": "2"})
    npz = ROOT / "artifacts" / "flagship_params.npz"
    with pytest.warns(UserWarning, match="refiner is drawn"):
        a = api.load_model(small, str(npz))
    with pytest.warns(UserWarning, match="refiner is drawn"):
        b = api.load_model(small, str(npz))
    want, _ = load_params_npz(npz)
    got = a.state_dict()
    for k, v in want.items():
        if not k.startswith("unet."):
            assert torch.equal(got[k], v), k
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in got.items())
    assert (a.dit.blocks[0].adaLN.weight != 0).all()


def test_reference_imports_nothing_of_the_port():
    path = ROOT / "tpucdc_torch" / "reference" / "dit.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch"}, names


def test_benchmark_configuration_holds_the_preset():
    """The cell's configuration file is ``dit_xl2_serving()``, uncut."""
    import json

    from cdcbench.reference.codec_ref import from_dict
    from tpucdc_torch import config as port_config
    conf = json.loads((ROOT / "cdcbench" / "configs" / "dit_xl2.json")
                      .read_text())
    built = from_dict(port_config.Config, conf["config"]).validated()
    want = presets.dit_xl2_serving()
    assert dataclasses.replace(built, workdir=want.workdir) == want
    assert conf["reduced"] == [] and (ROOT / conf["weights"]).is_file()


def test_spatial_gamma_search_decodes_through_the_dit(tiny_runtime):
    rt, _ = tiny_runtime
    img = np.random.default_rng(1).integers(0, 256, (64, 96, 3),
                                            dtype=np.uint8)
    blob = rt.compress(img, optimize_gamma="spatial")
    req = [r for r in profiling.requests() if r.name == "codec.compress"][-1]
    assert profiling.calls(req, "dit.block") >= 5 * 3 * TINY_DIT.depth
    assert rt.decompress(blob).shape == img.shape


def test_cli_serves_the_dit(tmp_path):
    """``compress`` and ``decompress`` of the port's CLI with
    ``--set model.refiner=dit`` (a tiny DiT, weights drawn)."""
    from PIL import Image

    from tpucdc_torch.cli.main import main
    png, blob, out = (tmp_path / n for n in ("in.png", "in.tpucdc",
                                             "out.png"))
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (64, 64, 3), dtype=np.uint8)).save(png)
    dit = ["--set", "model.refiner=dit", "--set", "model.dit.hidden=144",
           "--set", "model.dit.heads=2", "--set", "model.dit.depth=1",
           "--set", "model.prediction=residual", "--set", "sample.steps=2",
           "--set", "sample.truncate_frac=0.15"]
    common = ["--preset", "tiny", "--device", "cpu", *dit]
    main(["compress", str(png), str(blob), *common])
    main(["decompress", str(blob), str(out), *common])
    assert np.asarray(Image.open(out)).shape == (64, 64, 3)
