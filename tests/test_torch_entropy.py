"""tpucdc_torch's host entropy coding against the JAX package's.

Bitstreams, rANS payloads and CDF tables cross between the packages, so
every comparison here is exact.
"""

import numpy as np
import pytest
import torch

import tpucdc.entropy as jax_entropy
from tpucdc.codec.entropy_models import GaussianConditional as JaxGaussian
from tpucdc.model import CDCModel as JaxCDCModel
from tpucdc.pipelines.codec_runtime import CodecRuntime as JaxRuntime

from tests._torch_jax_helpers import FIXTURES, flagship_jax, torch_model
from tpucdc_torch import entropy
from tpucdc_torch.codec.entropy_models import GaussianConditional
from tpucdc_torch.pipelines.codec_runtime import CodecRuntime


def _headers():
    grid = np.arange(12, dtype=np.uint8).reshape(3, 4) * 20
    return {
        "v3": jax_entropy.BitstreamHeader(384, 512, 0, 5, 1.0, gamma=0.25),
        "v3-unset": jax_entropy.BitstreamHeader(100, 70, 0, 7, 1.0),
        "v4": jax_entropy.BitstreamHeader(64, 64, 1, 5, 1.0, 0.5, 0.75),
        "v5": jax_entropy.BitstreamHeader(384, 512, 0, 5, 1.0, 0.5,
                                          gamma_grid=grid),
    }


@pytest.mark.parametrize("version", ["v3", "v3-unset", "v4", "v5"])
def test_port_reads_jax_bitstreams_and_back(version):
    hdr = _headers()[version]
    streams = [b"z-payload", bytes(range(200))]
    blob = jax_entropy.write_bitstream(hdr, streams)
    assert blob[4] == int(version[1])
    got, got_streams = entropy.read_bitstream(blob)
    assert got_streams == streams
    for field in ("height", "width", "quality_id", "steps", "guidance"):
        assert getattr(got, field) == getattr(hdr, field)
    assert got.gamma_or_none == hdr.gamma_or_none
    assert got.quality_f_or_none == hdr.quality_f_or_none
    if hdr.gamma_grid is None:
        assert got.gamma_grid is None
    else:
        np.testing.assert_array_equal(got.gamma_grid, hdr.gamma_grid)
    # ...and the port's writer produces the same bytes.
    assert entropy.write_bitstream(got, got_streams) == blob


def test_port_rejects_corrupt_stream():
    blob = bytearray(jax_entropy.write_bitstream(
        _headers()["v3"], [b"abcdef", b"ghijkl"]))
    blob[-2] ^= 0xFF
    with pytest.raises(ValueError, match="crc"):
        entropy.read_bitstream(bytes(blob))


def test_gaussian_tables_and_indexes_match_jax():
    jg, tg = JaxGaussian(), GaussianConditional()
    jt, tt = jg.cdf_tables(), tg.cdf_tables()
    for k in ("cdfs", "cdf_lengths", "offsets"):
        np.testing.assert_array_equal(tt[k], jt[k])
    table = np.asarray(tg.scale_table, np.float32)
    rng = np.random.default_rng(0)
    scales = np.concatenate([
        np.exp(rng.uniform(np.log(0.05), np.log(400.0), 5000)),
        table, np.nextafter(table, 0), np.nextafter(table, np.inf),
    ]).astype(np.float32)
    want = np.asarray(jg.build_indexes(scales))
    got = tg.build_indexes(torch.from_numpy(scales)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native", [True, False])
def test_port_rans_decodes_jax_encoded_symbols(native):
    tables = JaxGaussian().cdf_tables()
    rng = np.random.default_rng(1)
    n = 4000 if native else 600
    idx = rng.integers(0, len(tables["cdf_lengths"]), n).astype(np.int32)
    # Mostly in-range values plus some escapes.
    vals = np.round(rng.standard_normal(n) * (idx + 1)).astype(np.int32)
    vals[::97] += 500
    blob = jax_entropy.RansCodec(tables).encode(vals, idx)
    dec = entropy.RansCodec(tables, use_native=native).decode(blob, idx)
    np.testing.assert_array_equal(dec, vals)
    # ...and the port's encoder writes the JAX coder's bytes.
    assert entropy.RansCodec(tables, use_native=native).encode(
        vals, idx) == blob


@pytest.fixture(scope="module")
def flagship():
    cfg, jmodel, params = flagship_jax()
    return jmodel, params, torch_model(cfg, params)


def test_z_tables_match_jax_exactly(flagship):
    jmodel, params, tm = flagship
    want = jmodel.apply(params, method=JaxCDCModel.factorized_tables)
    got = tm.factorized_tables()
    for k in ("cdfs", "cdf_lengths", "offsets"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(
        tm.z_medians().numpy(),
        np.asarray(jmodel.apply(params, method=JaxCDCModel.z_medians)))


def test_sidecar_tables_load_in_port(flagship):
    """The runtime's own coder tables equal the JAX runtime's export and the
    tables stored in the fixture, entry for entry: no sidecar is needed."""
    jmodel, params, tm = flagship
    from tpucdc_torch.presets import flagship_serving
    jrt = JaxRuntime.__new__(JaxRuntime)      # tables only: skip jit set-up
    jrt._z_tables = jmodel.apply(params, method=JaxCDCModel.factorized_tables)
    jrt._y_tables = JaxGaussian().cdf_tables()
    want = jrt.export_cdf_tables()
    rt = CodecRuntime(flagship_serving(), tm, device="cpu")
    fixture = np.load(FIXTURES / "flagship_384x512.npz")
    for prefix, codec in (("z", rt.z_codec), ("y", rt.y_codec)):
        assert codec.native
        for k in ("cdfs", "cdf_lengths", "offsets"):
            got = getattr(codec, k)
            np.testing.assert_array_equal(got, np.asarray(want[f"{prefix}_{k}"]))
            np.testing.assert_array_equal(got, fixture[f"{prefix}_{k}"])
