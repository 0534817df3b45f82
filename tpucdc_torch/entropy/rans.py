"""ctypes binding to the C++ rANS host coder, with a Python fallback.

ctypes drops the GIL for the duration of every foreign call, so host entropy
coding can run while another thread queues work on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpucdc_torch.entropy import _build
from tpucdc_torch.entropy import rans_py
from tpucdc_torch.utils.profiling import span

_lib = None
_lib_checked = False


def _load():
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    so = _build.build_library()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tpucdc_rans_encode.restype = ctypes.c_int64
    lib.tpucdc_rans_encode.argtypes = [
        i32p, ctypes.c_int64, i32p, i32p, ctypes.c_int32, i32p, i32p,
        ctypes.c_int32, u8p, ctypes.c_int64]
    lib.tpucdc_rans_decode.restype = ctypes.c_int64
    lib.tpucdc_rans_decode.argtypes = [
        u8p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, ctypes.c_int32,
        i32p, i32p, ctypes.c_int32, i32p]
    lib.tpucdc_rans_abi_version.restype = ctypes.c_int32
    if lib.tpucdc_rans_abi_version() != 3:
        raise RuntimeError("rANS library ABI mismatch (want v3)")
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


class RansCodec:
    """Encode/decode integer symbol arrays against a quantized CDF table.

    tables: dict with 'cdfs' [R, L] int32, 'cdf_lengths' [R], 'offsets' [R]
    (the cdf_utils.py spec). ``use_native=None`` auto-selects C++.
    """

    def __init__(self, tables, use_native: bool | None = None):
        self.cdfs = _as_i32(tables["cdfs"])
        self.cdf_lengths = _as_i32(tables["cdf_lengths"])
        self.offsets = _as_i32(tables["offsets"])
        if use_native is None:
            use_native = native_available()
        elif use_native and not native_available():
            raise RuntimeError("native rANS library unavailable")
        self.native = use_native

    def encode(self, values, indexes) -> bytes:
        with span("rans.encode", symbols=np.size(values)) as s:
            data = self._encode(values, indexes)
            s.add("bytes", len(data))
            return data

    def _encode(self, values, indexes) -> bytes:
        values = _as_i32(values).ravel()
        indexes = _as_i32(indexes).ravel()
        if values.shape != indexes.shape:
            raise ValueError("values/indexes shape mismatch")
        if len(values) and (indexes.min() < 0
                            or indexes.max() >= len(self.cdf_lengths)):
            raise ValueError("cdf row index out of range")
        if not self.native:
            return rans_py.encode(values, indexes, self.cdfs,
                                  self.cdf_lengths, self.offsets)
        lib = _load()
        cap = len(values) * 12 + 64
        out = np.empty(cap, np.uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = lib.tpucdc_rans_encode(
            values.ctypes.data_as(i32p), len(values),
            indexes.ctypes.data_as(i32p),
            self.cdfs.ctypes.data_as(i32p), self.cdfs.shape[1],
            self.cdf_lengths.ctypes.data_as(i32p),
            self.offsets.ctypes.data_as(i32p), len(self.cdf_lengths),
            out.ctypes.data_as(u8p), cap)
        if n < 0:
            raise RuntimeError(f"rans encode failed (code {n})")
        return out[:n].tobytes()

    def decode(self, data: bytes, indexes) -> np.ndarray:
        with span("rans.decode", symbols=np.size(indexes), bytes=len(data)):
            return self._decode(data, indexes)

    def _decode(self, data: bytes, indexes) -> np.ndarray:
        indexes = _as_i32(indexes)
        shape = indexes.shape
        flat = indexes.ravel()
        if len(flat) and (flat.min() < 0
                          or flat.max() >= len(self.cdf_lengths)):
            raise ValueError("cdf row index out of range")
        if not self.native:
            return rans_py.decode(data, flat, self.cdfs, self.cdf_lengths,
                                  self.offsets).reshape(shape)
        lib = _load()
        buf = np.frombuffer(data, np.uint8)
        out = np.empty(len(flat), np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = lib.tpucdc_rans_decode(
            buf.ctypes.data_as(u8p), len(buf),
            flat.ctypes.data_as(i32p), len(flat),
            self.cdfs.ctypes.data_as(i32p), self.cdfs.shape[1],
            self.cdf_lengths.ctypes.data_as(i32p),
            self.offsets.ctypes.data_as(i32p), len(self.cdf_lengths),
            out.ctypes.data_as(i32p))
        if rc != 0:
            raise RuntimeError(f"rans decode failed (code {rc})")
        return out.reshape(shape)
