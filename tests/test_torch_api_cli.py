"""tpucdc_torch.api and ``python -m tpucdc_torch`` on the CPU.

The config overrides and ``SERVING_OVERRIDES`` against the JAX package's
``apply_overrides`` and ``presets.flagship_serving()``; a tiny runtime's
round trip; every case of tests/integration/test_cli.py but ``train``
(tests/test_torch_fit.py runs it), mirrored on the port's CLI with
``--device cpu``; a directory without the port's checkpoint raises.

Across the two CLIs, on JAX's tiny initialisation (``init_model`` with key
0, which JAX's CLI builds without a checkpoint and the port reads from a
``save_params_npz`` file through ``--checkpoint``), both under F32_POLICY as
every parity test of the port: JAX's bitstream decodes in the port within 1
LSB of JAX's own mean decode, and the port's in JAX likewise. The
coder-table sidecar JAX's CLI writes (``--cdf-tables``) loads into the port,
equals the port's own export key for key, and decodes JAX's bitstream.
"""

import dataclasses
import json
import runpy
import sys

import jax
import numpy as np
import pytest
from PIL import Image

import tpucdc.model as jax_model
import tpucdc.presets as jax_presets
from tpucdc import config as jax_config
from tpucdc.cli.main import main as jax_main
from tpucdc.utils.checkpoint import save_params_npz

from tests._torch_jax_helpers import (  # noqa: F401
    jax_init_f32, one_torch_thread_per_module)
import tpucdc_torch.api as api
from tpucdc_torch import config as port_config
from tpucdc_torch import presets
from tpucdc_torch.cli.main import main
from tpucdc_torch.pipelines import codec_runtime
from tpucdc_torch.runtime import F32_POLICY
from tpucdc_torch.utils import profile_trace


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "img.png"
    rng = np.random.default_rng(0)
    img = np.repeat(np.repeat(
        rng.integers(0, 255, (16, 16, 3), dtype=np.uint8), 8, 0), 8, 1)
    Image.fromarray(img[:120, :112]).save(p)   # odd size exercises padding
    return p


@pytest.fixture(scope="module")
def small_png(tmp_path_factory):
    """40×56, padded to one 64×64 block: the cases that are not about the
    size run on a quarter of ``png``'s pixels."""
    p = tmp_path_factory.mktemp("cli_small") / "img.png"
    img = np.random.default_rng(2).integers(0, 255, (40, 56, 3),
                                            dtype=np.uint8)
    Image.fromarray(img).save(p)
    return p


def _rows(capsys, n=1):
    return [json.loads(ln)
            for ln in capsys.readouterr().out.strip().splitlines()[-n:]]


# ---- config and API ----

@dataclasses.dataclass(frozen=True)
class _Leaf:
    flag: bool = False
    count: int = 1
    rate: float = 0.5
    name: str = "a"
    dims: tuple = (1, 2)
    empty: tuple = ()


@dataclasses.dataclass(frozen=True)
class _Tree:
    leaf: _Leaf = _Leaf()


@pytest.mark.parametrize("key,raw", [
    ("leaf.flag", "true"), ("leaf.flag", "0"), ("leaf.count", "7"),
    ("leaf.rate", "3e-4"), ("leaf.name", "b.c"), ("leaf.dims", "4,5,6"),
    ("leaf.empty", "1,0.25,x"), ("leaf.empty", ""),
])
def test_apply_overrides_matches_jax(key, raw):
    got = port_config.apply_overrides(_Tree(), {key: raw})
    want = jax_config.apply_overrides(_Tree(), {key: raw})
    assert got == want
    assert type(got.leaf.empty) is tuple


@pytest.mark.parametrize("key,err", [("leaf.nope", KeyError),
                                     ("leaf.count.x", TypeError)])
def test_apply_overrides_rejects_bad_paths(key, err):
    with pytest.raises(err):
        port_config.apply_overrides(_Tree(), {key: "1"})


def test_build_config_overrides():
    cfg = api.build_config("tiny", {"train.rd_lambda": 4.0,
                                    "sample.steps": 3})
    assert cfg.train.rd_lambda == 4.0
    assert cfg.sample.steps == 3
    with pytest.raises(KeyError):
        api.build_config("nope")


def test_serving_overrides_give_flagship_serving():
    cfg = api.build_config("flagship", presets.SERVING_OVERRIDES)
    want = presets.flagship_serving()
    assert cfg.model == want.model and cfg.sample == want.sample
    vr = api.build_config("flagship", {**presets.SERVING_OVERRIDES,
                                       **presets.VR_WIDE_OVERRIDES})
    assert vr.model == presets.vr_wide_serving().model


def test_load_runtime_roundtrip():
    rt = api.load_runtime("tiny", overrides={"sample.steps": 2},
                          device="cpu")
    img = np.random.default_rng(0).integers(0, 255, (64, 64, 3),
                                            dtype=np.uint8)
    out = rt.decompress(rt.compress(img), steps=2)
    assert out.shape == img.shape and out.dtype == np.uint8


def test_unported_entry_points_raise(tmp_path):
    """A directory is read as the port's run directory
    (tests/test_torch_fit.py trains one); one without the port's checkpoint,
    such as the JAX package's orbax run directory, raises. (``eval --mesh``
    runs: tests/test_torch_shard_decode.py.)"""
    with pytest.raises(FileNotFoundError, match="orbax"):
        api.load_runtime("tiny", checkpoint=str(tmp_path), device="cpu")


# ---- the CLI: tests/integration/test_cli.py's cases ----

def test_cli_compress_decompress(png, tmp_path, capsys):
    blob = tmp_path / "img.tpucdc"
    out = tmp_path / "out.png"
    main(["compress", str(png), str(blob), "--preset", "tiny",
          "--device", "cpu"])
    stats = _rows(capsys)[0]
    assert stats["bytes"] > 0 and stats["bpp"] > 0
    assert blob.exists()

    main(["decompress", str(blob), str(out), "--preset", "tiny",
          "--steps", "2", "--device", "cpu"])
    assert _rows(capsys)[0]["shape"] == [120, 112, 3]
    assert Image.open(out).size == (112, 120)


def test_cli_batch_compress_decompress(small_png, tmp_path, capsys):
    """Several inputs: OUTPUT is a directory; compress is compress_many,
    decompress is decompress_many."""
    rng = np.random.default_rng(1)
    png2 = tmp_path / "img2.png"
    Image.fromarray(rng.integers(0, 255, (40, 56, 3),
                                 dtype=np.uint8)).save(png2)
    bdir = tmp_path / "blobs"
    main(["compress", str(small_png), str(png2), str(bdir), "--preset", "tiny",
          "--device", "cpu"])
    rows = _rows(capsys, 2)
    assert all(r["bytes"] > 0 and "file" in r for r in rows)
    blobs = sorted(bdir.glob("*.tpucdc"))
    assert len(blobs) == 2

    odir = tmp_path / "outs"
    main(["decompress", *map(str, blobs), str(odir), "--preset", "tiny",
          "--steps", "2", "--device", "cpu"])
    rows = _rows(capsys, 2)
    assert all(r["shape"] == [40, 56, 3] for r in rows)
    assert len(sorted(odir.glob("*.png"))) == 2


def test_cli_single_input_directory_output(small_png, tmp_path, capsys):
    """A one-file input with a directory output takes the directory path,
    and same-stem inputs do not overwrite each other."""
    bdir = tmp_path / "blobs"
    main(["compress", str(small_png), str(bdir) + "/", "--preset", "tiny",
          "--device", "cpu"])
    row = _rows(capsys)[0]
    assert row["file"].endswith(".tpucdc") and (bdir / "img.tpucdc").exists()

    d2 = tmp_path / "other"
    d2.mkdir()
    png2 = d2 / "img.png"
    Image.open(small_png).save(png2)
    main(["compress", str(small_png), str(png2), str(bdir), "--preset", "tiny",
          "--device", "cpu"])
    capsys.readouterr()
    names = sorted(p.name for p in bdir.glob("*.tpucdc"))
    assert names == ["img.tpucdc", "img_2.tpucdc"]

    odir = tmp_path / "outs"
    main(["decompress", str(bdir / "img.tpucdc"), str(odir) + "/",
          "--preset", "tiny", "--steps", "2", "--device", "cpu"])
    row = _rows(capsys)[0]
    assert row["shape"] == [40, 56, 3] and (odir / "img.png").exists()


def test_cli_rejects_bad_preset(png, tmp_path):
    with pytest.raises(SystemExit):
        main(["compress", str(png), str(tmp_path / "x"), "--preset", "nope",
              "--device", "cpu"])


def test_cli_optimize_gamma_spatial(small_png, tmp_path, capsys):
    """--optimize-gamma spatial writes a decodable stream and echoes the dial
    (the scalar γ always, the grid's dimensions when the fit won)."""
    blob = tmp_path / "sp.tpucdc"
    main(["compress", str(small_png), str(blob), "--preset", "tiny",
          "--optimize-gamma", "spatial", "--set", "sample.steps=2",
          "--device", "cpu"])
    row = _rows(capsys)[0]
    assert row["gamma"] is not None
    if "gamma_grid" in row:
        assert row["gamma_grid"] == [1, 1]    # 40×56 pads to one tile
    out = tmp_path / "sp.png"
    main(["decompress", str(blob), str(out), "--preset", "tiny",
          "--steps", "2", "--device", "cpu"])
    assert _rows(capsys)[0]["shape"] == [40, 56, 3]


def test_cli_optimize_gamma_rejects_bad_value(png, tmp_path):
    with pytest.raises(SystemExit, match="spatial"):
        main(["compress", str(png), str(tmp_path / "x.tpucdc"),
              "--preset", "tiny", "--optimize-gamma", "bogus",
              "--device", "cpu"])


def test_cli_quality_and_target_bpp_are_exclusive(png, tmp_path):
    with pytest.raises(SystemExit, match="exclusive"):
        main(["compress", str(png), str(tmp_path / "x.tpucdc"),
              "--preset", "tiny", "--quality", "1", "--target-bpp", "0.5",
              "--device", "cpu"])


def test_cli_target_bpp_on_a_vr_model(small_png, tmp_path, capsys):
    """Rate control through the CLI echoes the quality it chose."""
    main(["compress", str(small_png), str(tmp_path / "vr.tpucdc"), "--preset",
          "tiny", "--set", "model.codec.num_qualities=3", "--target-bpp",
          "0.5", "--device", "cpu"])
    row = _rows(capsys)[0]
    assert 0.0 <= row["quality"] <= 2.0 and row["bpp"] > 0


def test_cli_eval_and_rd_sweep(tmp_path, capsys, monkeypatch):
    """eval (rows, the latency sweep) and rd-sweep on a small dataset."""
    from tpucdc_torch.data import datasets
    monkeypatch.setitem(datasets._SPECS, "kodak",
                        ("TPUCDC_KODAK_DIR", [], 1, (64, 64)))
    monkeypatch.setenv("TPUCDC_KODAK_DIR", str(tmp_path / "absent"))
    common = ["--preset", "tiny", "--steps", "1", "--no-lpips",
              "--device", "cpu", "--workdir", str(tmp_path)]
    main(["eval", *common])
    agg = _rows(capsys)[0]
    assert agg["num_images"] == 1 and agg["synthetic"] is True
    main(["eval", "--sweep", "latency", *common])
    assert _rows(capsys)[0]["out_shape"] == [64, 64, 3]
    main(["rd-sweep", "--lambdas", "4,8", *common])
    points = _rows(capsys)[0]
    assert [p["rd_lambda"] for p in points] == [4.0, 8.0]
    logged = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(logged) == 1 + 1 + 1 + 2 + 2
    assert all("code_sha" in json.loads(ln) for ln in logged)


def test_cli_profile_writes_a_trace(small_png, tmp_path, capsys):
    blob = tmp_path / "p.tpucdc"
    main(["compress", str(small_png), str(blob), "--preset", "tiny",
          "--device", "cpu"])
    main(["decompress", str(blob), str(tmp_path / "p.png"), "--preset",
          "tiny", "--steps", "0", "--device", "cpu", "--profile",
          str(tmp_path / "trace")])
    capsys.readouterr()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    [line] = (tmp_path / "trace" / "spans.jsonl").read_text().splitlines()
    request = json.loads(line)
    assert request["name"] == "codec.decompress" and request["profiled"]
    names = [s["name"] for s in request["spans"]]
    assert names.count("codec.fetch") == 2 and "codec.synth" in names
    with profile_trace(None):
        pass


def test_python_m_entry_point(monkeypatch, capsys):
    """``python -m tpucdc_torch``, run in-process as ``-m`` runs it."""
    monkeypatch.setattr(sys, "argv", ["tpucdc_torch", "--help"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("tpucdc_torch", run_name="__main__", alter_sys=True)
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "compress" in out and "rd-sweep" in out


# ---- across the two CLIs ----

class _F32Runtime(codec_runtime.CodecRuntime):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, policy=F32_POLICY, **kwargs)


@pytest.fixture(scope="module")
def crossed(png, tmp_path_factory):
    """Bitstreams and decodes of both CLIs, F32 on both sides. JAX's CLI
    initialises once: every call gets the same (model, params) that
    ``init_model`` gives for the tiny preset and key 0; its decompress reads
    the sidecar its compress wrote."""
    d = tmp_path_factory.mktemp("crossed")
    tiny = jax_presets.tiny()
    tiny_model = tiny.model
    # What JAX's CLI initialises without a checkpoint.
    model, params = jax_init_f32(tiny_model, jax.random.key(0),
                                 tiny.train.crop_size)
    save_params_npz(params, d / "init.npz")

    def init_once(config, rng, image_size=64, policy=None):
        assert config == tiny_model
        return model, params

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_model, "init_model", init_once)
    mp.setattr(codec_runtime, "CodecRuntime", _F32Runtime)
    try:
        jax_cli = ["--preset", "tiny", "--cdf-tables",
                   str(d / "jax_tables.npz")]
        port = ["--preset", "tiny", "--device", "cpu", "--checkpoint",
                str(d / "init.npz")]
        jax_main(["compress", str(png), str(d / "jax.tpucdc"), *jax_cli])
        main(["compress", str(png), str(d / "port.tpucdc"), *port])
        blobs = [str(d / "jax.tpucdc"), str(d / "port.tpucdc")]
        # Both bitstreams in one call of each CLI (batch mode: a directory
        # of <stem>.png); the mean decode draws no noise.
        jax_main(["decompress", *blobs, str(d / "by_jax"), *jax_cli,
                  "--steps", "0"])
        main(["decompress", *blobs, str(d / "by_port"), *port,
              "--steps", "0"])
        main(["decompress", str(d / "jax.tpucdc"),
              str(d / "jax_by_port_sidecar.png"), *port, "--steps", "0",
              "--cdf-tables", str(d / "jax_tables.npz")])
    finally:
        mp.undo()
    return d


def _img(path):
    return np.asarray(Image.open(path)).astype(np.int32)


@pytest.mark.parametrize("src", ["jax", "port"])
def test_cross_cli_mean_decodes_within_one_lsb(crossed, src):
    by_jax = _img(crossed / "by_jax" / f"{src}.png")
    by_port = _img(crossed / "by_port" / f"{src}.png")
    assert by_jax.shape == by_port.shape == (120, 112, 3)
    assert np.abs(by_jax - by_port).max() <= 1


def test_jax_sidecar_decodes_in_the_port(crossed):
    """The sidecar JAX wrote is what a runtime built on it exports, key for
    key and entry for entry, and it decodes JAX's bitstream to the pixels
    of the port's own tables. The port's own table build has the same keys
    and shapes; on this initialisation one z-CDF entry of 368 is 1 count off
    JAX's (the float sums of the factorized prior run in another order),
    which is what the sidecar takes out of the decode."""
    tables = codec_runtime.CodecRuntime.load_cdf_tables(
        crossed / "jax_tables.npz")
    own_rt = api.load_runtime("tiny", checkpoint=str(crossed / "init.npz"),
                              device="cpu")
    rt = codec_runtime.CodecRuntime(own_rt.config, own_rt.model,
                                    device="cpu", cdf_tables=tables)
    own = own_rt.export_cdf_tables()
    export = rt.export_cdf_tables()
    with np.load(crossed / "jax_tables.npz") as jax_tables:
        assert sorted(export) == sorted(own) == sorted(jax_tables.files)
        for k in jax_tables.files:
            np.testing.assert_array_equal(export[k], jax_tables[k])
            assert own[k].shape == jax_tables[k].shape
            gap = np.abs(own[k].astype(np.int64) - jax_tables[k])
            assert gap.max() <= 1 and np.mean(gap > 0) <= 0.01, k
    np.testing.assert_array_equal(
        _img(crossed / "jax_by_port_sidecar.png"),
        _img(crossed / "by_port" / "jax.png"))


def test_cli_writes_the_sidecar_when_absent(small_png, tmp_path, capsys):
    path = tmp_path / "tables.npz"
    main(["compress", str(small_png), str(tmp_path / "a.tpucdc"), "--preset",
          "tiny", "--device", "cpu", "--cdf-tables", str(path)])
    capsys.readouterr()
    rt = api.load_runtime("tiny", device="cpu")
    with np.load(path) as saved:
        assert sorted(saved.files) == sorted(rt.export_cdf_tables())


def test_npz_checkpoint_is_read_strictly(crossed, tmp_path):
    with pytest.raises(ValueError, match="EMA"):
        api.load_runtime("tiny", checkpoint=str(crossed / "init.npz"),
                         use_ema=False, device="cpu")
    with np.load(crossed / "init.npz") as data:
        arrays = {k: data[k] for k in data.files}
    extra = tmp_path / "extra.npz"
    np.savez(extra, **arrays, **{"['params']['nothing']['kernel']":
                                 np.zeros((2, 2), np.float32)})
    with pytest.raises((ValueError, RuntimeError)):
        api.load_runtime("tiny", checkpoint=str(extra), device="cpu")
