"""Bitstream container format — the port's copy of tpucdc/entropy/bitstream.py.

The byte layout is shared with the JAX package: a container written by
either package parses with the other.

Layout (little-endian):
  magic   4 bytes  b"TCDC"
  version u8
  header: height u16, width u16, quality_id u8 (λ index), steps u16,
          guidance f32, gamma f32 (v3; NaN = unset),
          quality_f f32 (v4; NaN = unset), n_streams u8
  then per stream: length u32 + crc32 u32 + payload bytes.
Stream 0 is the factorized-coded ẑ, stream 1 the Gaussian-coded ŷ.

v3 (r4) adds the distortion-perception blend γ to the header so a
bitstream can carry its own serving dial: the ENCODER holds the original
image and can pick the per-image γ (CodecRuntime.compress
``optimize_gamma``), and any decoder then serves x̂ = x̄ + γ·(x₀ − x̄)
without an out-of-band per-rate table. NaN means "unset — use the
decoder's configured default"; v2 bitstreams parse as gamma-unset.

v4 (r4) adds the CONTINUOUS variable-rate quality: a float index into the
trained gain ladder (CodecRuntime.quality_gains interpolates adjacent
gain vectors in log domain), so a single VR model serves any rate between
its trained points and ``compress_to_bpp`` can hit a bpp target exactly.
NaN = unset — decode uses the integer ``quality_id`` as before. The
writer only emits v4 when quality_f IS set: integral-quality bitstreams
stay v3 so v3-era decoders keep parsing them (they hard-reject unknown
versions — a v4 container is only produced when its content genuinely
needs the new field; quality_id then carries the nearest trained row for
tooling that groups by ladder index).

v5 (r5) adds an optional SPATIAL serving dial: a coarse per-tile γ grid
(u8-quantized γ/255 over a gh×gw grid spanning the PADDED canvas, one
node per 128-px tile) appended after the v4 header as gh u8 + gw u8 +
gh·gw bytes. The decoder bilinearly upsamples the grid to the padded
resolution and blends per-pixel: x̂ = x̄ + γ(p)·(x₀ − x̄). The blend is
linear in γ, so the ENCODER fits the grid in closed form per tile
(γ* = Σd·r / Σd·d with d = x_refined − x̄, r = x_orig − x̄) from the two
decodes it already has — no candidate search. A 768×512 image carries a
4×6 grid = 26 bytes ≈ 0.0005 bpp. Same emit-only-when-needed rule: the
writer produces v5 only when a grid is present (scalar-γ streams stay
v3/v4), and the grid coexists with the scalar γ field, which serves as
the fallback for decode paths that don't support the grid (tiled/
sharded decode).

The per-stream CRC32 (v2) turns mid-payload corruption into a loud
ValueError at parse time: rANS decode of a flipped-bit payload otherwise
"succeeds" with garbage symbols (entropy-coded data has no internal
redundancy to fail on).
"""

from __future__ import annotations

import dataclasses
import math
import struct
import zlib

MAGIC = b"TCDC"
VERSION = 5
_HEADER_V2 = struct.Struct("<HHBHfB")
_HEADER_V3 = struct.Struct("<HHBHffB")
_HEADER_V4 = struct.Struct("<HHBHfffB")
# v5 = the v4 fixed header + gh u8 + gw u8 + gh*gw grid bytes before
# n_streams; reuse the v4 struct minus its trailing n_streams byte.
_HEADER_V5_FIXED = struct.Struct("<HHBHfff")


@dataclasses.dataclass
class BitstreamHeader:
    height: int
    width: int
    quality_id: int = 0
    steps: int = 100
    guidance: float = 1.0
    # Serving blend dial carried in-band (v3). NaN = unset; use
    # ``gamma_or_none`` to read it — a raw NaN compare is always False.
    gamma: float = float("nan")
    # Continuous VR quality (v4): float index into the gain ladder.
    # NaN = unset (decode by the integer quality_id).
    quality_f: float = float("nan")
    # Spatial serving dial (v5): u8 [gh, gw] per-tile γ grid over the
    # padded canvas (γ = value / 255). None = unset (scalar γ applies).
    gamma_grid: "object" = None        # np.ndarray(uint8) | None

    @property
    def gamma_or_none(self) -> float | None:
        return None if math.isnan(self.gamma) else self.gamma

    @property
    def gamma_grid_f(self):
        """Float γ grid in [0, 1], or None."""
        if self.gamma_grid is None:
            return None
        import numpy as np
        return np.asarray(self.gamma_grid, dtype=np.float32) / 255.0

    @property
    def quality_f_or_none(self) -> float | None:
        return None if math.isnan(self.quality_f) else self.quality_f


def write_bitstream(header: BitstreamHeader, streams: list[bytes]) -> bytes:
    if len(streams) > 255:
        raise ValueError("too many streams")
    if header.gamma_grid is not None:
        # Spatial γ grid → v5 (emit-only-when-needed, as with v4 below).
        import numpy as np
        grid = np.ascontiguousarray(header.gamma_grid, dtype=np.uint8)
        if grid.ndim != 2 or not (1 <= grid.shape[0] <= 255
                                  and 1 <= grid.shape[1] <= 255):
            raise ValueError(f"gamma_grid must be 2-D u8 with dims in "
                             f"[1, 255], got shape {grid.shape}")
        parts = [MAGIC, bytes([5]),
                 _HEADER_V5_FIXED.pack(header.height, header.width,
                                       header.quality_id, header.steps,
                                       header.guidance, header.gamma,
                                       header.quality_f),
                 bytes([grid.shape[0], grid.shape[1]]),
                 grid.tobytes(), bytes([len(streams)])]
    elif math.isnan(header.quality_f):
        # No continuous quality → emit v3: older decoders reject unknown
        # versions outright, so only pay the version bump when needed.
        parts = [MAGIC, bytes([3]),
                 _HEADER_V3.pack(header.height, header.width,
                                 header.quality_id, header.steps,
                                 header.guidance, header.gamma,
                                 len(streams))]
    else:
        parts = [MAGIC, bytes([4]),
                 _HEADER_V4.pack(header.height, header.width,
                                 header.quality_id, header.steps,
                                 header.guidance, header.gamma,
                                 header.quality_f, len(streams))]
    for s in streams:
        parts.append(struct.pack("<II", len(s), zlib.crc32(s) & 0xFFFFFFFF))
        parts.append(s)
    return b"".join(parts)


def read_bitstream(data: bytes) -> tuple[BitstreamHeader, list[bytes]]:
    if len(data) < 5 or data[:4] != MAGIC:
        raise ValueError("not a tpucdc bitstream (bad magic)")
    version = data[4]
    if version not in (2, 3, 4, 5):
        raise ValueError(f"unsupported bitstream version {version}")
    off = 5
    try:
        quality_f = float("nan")
        gamma_grid = None
        if version == 2:
            h, w, q, steps, guidance, n_streams = _HEADER_V2.unpack_from(
                data, off)
            gamma = float("nan")
            off += _HEADER_V2.size
        elif version == 3:
            (h, w, q, steps, guidance, gamma,
             n_streams) = _HEADER_V3.unpack_from(data, off)
            off += _HEADER_V3.size
        elif version == 4:
            (h, w, q, steps, guidance, gamma, quality_f,
             n_streams) = _HEADER_V4.unpack_from(data, off)
            off += _HEADER_V4.size
        else:
            (h, w, q, steps, guidance, gamma,
             quality_f) = _HEADER_V5_FIXED.unpack_from(data, off)
            off += _HEADER_V5_FIXED.size
            gh, gw = data[off], data[off + 1]
            off += 2
            if gh < 1 or gw < 1:
                raise ValueError(f"bad gamma_grid dims {gh}x{gw}")
            raw = bytes(data[off:off + gh * gw])
            if len(raw) != gh * gw:
                raise ValueError("bitstream truncated (gamma_grid)")
            import numpy as np
            gamma_grid = np.frombuffer(raw, np.uint8).reshape(gh, gw)
            off += gh * gw
            n_streams = data[off]
            off += 1
        streams = []
        for i in range(n_streams):
            length, crc = struct.unpack_from("<II", data, off)
            off += 8
            payload = bytes(data[off:off + length])
            if len(payload) != length:
                raise ValueError("bitstream truncated")
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                raise ValueError(f"stream {i} corrupt (crc mismatch)")
            streams.append(payload)
            off += length
    except (struct.error, IndexError) as e:
        raise ValueError(f"bitstream truncated ({e})") from None
    return BitstreamHeader(h, w, q, steps, guidance, gamma,
                           quality_f, gamma_grid), streams


def with_header_gamma(data: bytes, gamma: float) -> bytes:
    """Return ``data`` with the header γ replaced (streams untouched).

    Full parse + re-pack — revalidates every CRC; the result re-packs at
    v3 unless quality_f is set (v4), matching write_bitstream's
    NaN-gated version selection. Used by the
    encode-time γ search
    (CodecRuntime.compress optimize_gamma), which rewrites the header of
    an already-coded bitstream instead of re-running the entropy coder.
    """
    header, streams = read_bitstream(data)
    header.gamma = float(gamma)
    return write_bitstream(header, streams)


def with_header_gamma_grid(data: bytes, grid, fallback_gamma: float) -> bytes:
    """Return ``data`` with a v5 spatial γ grid attached (streams
    untouched). ``grid`` is a u8 [gh, gw] array (γ = value/255);
    ``fallback_gamma`` lands in the scalar γ field so decode paths without
    grid support (tiled/sharded) still serve a sensible dial. Pass
    ``grid=None`` to strip an existing grid (re-packs at v3/v4)."""
    header, streams = read_bitstream(data)
    header.gamma_grid = grid
    header.gamma = float(fallback_gamma)
    return write_bitstream(header, streams)
