# Frozen copy of the port's entropy/rans_py.py (its plain path), the benchmark's
# reference: imports rewritten, nothing of the port imported.
"""Pure-Python rANS coder — fallback & cross-check oracle.

Bit-exact mirror of the port/entropy/cpp/rans.cc (same constants, same bypass
scheme); property tests assert C++ ∘ Python interop both directions. Slow —
production paths use the C++ library.
"""

from __future__ import annotations

import numpy as np

PROB_BITS = 16
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 23
BYPASS_SCALE = 1 << (PROB_BITS - 4)


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1


def _unzigzag(u: int) -> int:
    return (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1)


def encode(values, indexes, cdfs, cdf_lengths, offsets) -> bytes:
    values = np.asarray(values, np.int64)
    indexes = np.asarray(indexes, np.int64)
    out = bytearray()          # bytes emitted in reverse; reversed at the end
    state = RANS_L

    def put(cf: int, f: int):
        nonlocal state
        x_max = ((RANS_L >> PROB_BITS) << 8) * f
        while state >= x_max:
            out.append(state & 0xFF)
            state >>= 8
        state = ((state // f) << PROB_BITS) + (state % f) + cf

    def put_bypass(u: int):
        chunks = []
        while True:
            payload = u & 7
            u >>= 3
            chunks.append((8 if u else 0) | payload)
            if not u:
                break
        for c in reversed(chunks):
            put(c * BYPASS_SCALE, BYPASS_SCALE)

    for i in range(len(values) - 1, -1, -1):
        r = int(indexes[i])
        row = cdfs[r]
        length = int(cdf_lengths[r])
        esc = length - 2
        s = int(values[i]) - int(offsets[r])
        if s < 0 or s >= esc:
            raw = s if s < 0 else s - esc
            put_bypass(_zigzag(raw))
            put(int(row[esc]), int(row[esc + 1] - row[esc]))
        else:
            put(int(row[s]), int(row[s + 1] - row[s]))

    for shift in (24, 16, 8, 0):          # flush, high byte last-emitted
        out.append((state >> shift) & 0xFF)
    return bytes(reversed(out))


def decode(data: bytes, indexes, cdfs, cdf_lengths, offsets) -> np.ndarray:
    indexes = np.asarray(indexes, np.int64)
    n = len(indexes)
    pos = 0

    def get_byte():
        nonlocal pos
        if pos >= len(data):
            raise ValueError("rans bitstream truncated")
        b = data[pos]
        pos += 1
        return b

    # Flush wrote the state little-endian.
    state = 0
    for shift in (0, 8, 16, 24):
        state |= get_byte() << shift

    def advance(cf: int, f: int):
        nonlocal state
        state = f * (state >> PROB_BITS) + (state & (PROB_SCALE - 1)) - cf
        while state < RANS_L:
            state = (state << 8) | get_byte()

    def get_bypass() -> int:
        # Mirrors rans.cc: 32-bit accumulator semantics, continuation loop
        # capped at shift 30 so corrupted streams decode identically to C++.
        u, shift = 0, 0
        while True:
            c = (state & (PROB_SCALE - 1)) // BYPASS_SCALE
            advance(c * BYPASS_SCALE, BYPASS_SCALE)
            u = (u | ((c & 7) << shift)) & 0xFFFFFFFF
            if not (c & 8) or shift >= 30:
                break
            shift += 3
        return u

    values = np.zeros(n, np.int32)
    for i in range(n):
        r = int(indexes[i])
        row = cdfs[r]
        length = int(cdf_lengths[r])
        esc = length - 2
        cum = state & (PROB_SCALE - 1)
        s = int(np.searchsorted(row[:length], cum, side="right")) - 1
        advance(int(row[s]), int(row[s + 1] - row[s]))
        if s == esc:
            raw = _unzigzag(get_bypass())
            v = (raw if raw < 0 else raw + esc) + int(offsets[r])
        else:
            v = s + int(offsets[r])
        values[i] = v
    return values


def encode_fast(values, indexes, cdfs, cdf_lengths, offsets) -> bytes:
    """``encode``'s bytes, with each symbol's (cumulative, frequency) looked
    up by numpy before the sequential state loop: the reference writes the
    decode cells' bitstreams with it in set-up."""
    values = np.asarray(values, np.int64).ravel()
    indexes = np.asarray(indexes, np.int64).ravel()
    cdfs = np.asarray(cdfs, np.int64)
    lengths = np.asarray(cdf_lengths, np.int64)[indexes]
    s = values - np.asarray(offsets, np.int64)[indexes]
    esc = lengths - 2
    escaped = (s < 0) | (s >= esc)
    slot = np.where(escaped, esc, s)
    cf = cdfs[indexes, slot]
    freq = cdfs[indexes, slot + 1] - cf
    raw = np.where(s < 0, s, s - esc)
    out = bytearray()
    state = RANS_L
    top = (RANS_L >> PROB_BITS) << 8
    for c, f, e, r in zip(cf[::-1].tolist(), freq[::-1].tolist(),
                          escaped[::-1].tolist(), raw[::-1].tolist()):
        if e:
            u = _zigzag(r)
            chunks = []
            while True:
                payload = u & 7
                u >>= 3
                chunks.append((8 if u else 0) | payload)
                if not u:
                    break
            for ch in reversed(chunks):
                x_max = top * BYPASS_SCALE
                while state >= x_max:
                    out.append(state & 0xFF)
                    state >>= 8
                state = (((state // BYPASS_SCALE) << PROB_BITS)
                         + (state % BYPASS_SCALE) + ch * BYPASS_SCALE)
        x_max = top * f
        while state >= x_max:
            out.append(state & 0xFF)
            state >>= 8
        state = ((state // f) << PROB_BITS) + (state % f) + c
    for shift in (24, 16, 8, 0):
        out.append((state >> shift) & 0xFF)
    return bytes(reversed(out))
