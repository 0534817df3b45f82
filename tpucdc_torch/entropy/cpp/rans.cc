// Host-side rANS range coder: the PyTorch port's own copy of
// tpucdc/entropy/cpp/rans.cc, byte for byte the same coder (bitstreams
// written by either package decode with the other).
//
// Byte-wise rANS with 16-bit quantized probabilities, matching the table
// spec frozen in tpucdc_torch/codec/cdf_utils.py:
//   * each CDF row r has cdf_lengths[r] int32 entries: 0 = c_0 < ... <
//     c_{L} = 1<<16; the row codes L symbols, the LAST of which is the
//     ESCAPE symbol;
//   * element i is coded with row indexes[i]; its in-range coded symbol is
//     values[i] - offsets[r]; out-of-range values are coded as escape
//     followed by 4-bit bypass chunks of the zigzagged raw symbol.
//
// rANS is LIFO: the encoder walks the element array BACKWARD emitting bytes
// backward; the decoder reads forward. Exposed as a plain C ABI consumed via
// ctypes (the GIL is dropped for the duration of every call, so host entropy
// decode can overlap device work queued from another thread).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 23;  // renormalization lower bound
constexpr uint32_t kBypassBits = 4;    // bypass chunk width
constexpr uint32_t kBypassScale = 1u << (kProbBits - kBypassBits);

// Exact division-free x/f for the encoder's state update: with
// M = ceil(2^48 / f), q = (x * M) >> 48 equals floor(x / f) for all
// x < 2^31 (the rANS state invariant: state < kRansL << 8 = 2^31) and
// 1 <= f <= 2^16. Proof: M = (2^48 + e)/f exactly with e = (-2^48) mod f,
// so x*M/2^48 = x/f + x*e/(f*2^48); the error term is < 2^31/2^48 = 2^-17
// while frac(x/f) <= 1 - 1/f <= 1 - 2^-16, so the floor never crosses.
constexpr uint32_t kRecipBits = 48;

inline uint64_t recip_magic(uint32_t f) {
  return (((static_cast<uint64_t>(1) << kRecipBits) + f - 1) / f);
}

struct Encoder {
  uint8_t* begin;   // buffer start (capacity guard)
  uint8_t* ptr;     // writes move DOWN from buffer end
  uint32_t state = kRansL;
  bool overflow = false;

  inline void put_byte(uint8_t b) {
    if (ptr == begin) { overflow = true; return; }
    *--ptr = b;
  }

  // Encode symbol with frequency f at cumulative cf; m = recip_magic(f).
  inline void put(uint32_t cf, uint32_t f, uint64_t m) {
    uint32_t x_max = ((kRansL >> kProbBits) << 8) * f;
    while (state >= x_max) {
      put_byte(static_cast<uint8_t>(state & 0xff));
      state >>= 8;
    }
    const uint32_t q = static_cast<uint32_t>(
        (static_cast<unsigned __int128>(state) * m) >> kRecipBits);
    state = (q << kProbBits) + (state - q * f) + cf;
  }

  inline void flush() {
    put_byte(static_cast<uint8_t>((state >> 24) & 0xff));
    put_byte(static_cast<uint8_t>((state >> 16) & 0xff));
    put_byte(static_cast<uint8_t>((state >> 8) & 0xff));
    put_byte(static_cast<uint8_t>(state & 0xff));
  }
};

struct Decoder {
  const uint8_t* ptr;
  const uint8_t* end;
  uint32_t state = 0;
  bool underflow = false;

  inline uint8_t get_byte() {
    if (ptr == end) { underflow = true; return 0; }
    return *ptr++;
  }

  inline void init() {
    // Flush wrote the state little-endian (lowest byte at lowest address).
    state = get_byte();
    state |= static_cast<uint32_t>(get_byte()) << 8;
    state |= static_cast<uint32_t>(get_byte()) << 16;
    state |= static_cast<uint32_t>(get_byte()) << 24;
  }

  inline uint32_t peek() const { return state & (kProbScale - 1); }

  inline void advance(uint32_t cf, uint32_t f) {
    state = f * (state >> kProbBits) + (state & (kProbScale - 1)) - cf;
    while (state < kRansL) state = (state << 8) | get_byte();
  }
};

inline uint32_t zigzag(int64_t v) {
  return static_cast<uint32_t>((v << 1) ^ (v >> 63));
}

inline int64_t unzigzag(uint32_t u) {
  return static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
}

// Bypass chunks for value u: little-endian 3-bit payload + continuation bit
// per 4-bit chunk. Encoder emits them in REVERSE (rANS LIFO) so the decoder
// reads them low-chunk-first.
inline void put_bypass(Encoder& enc, uint32_t u) {
  // kBypassScale is compile-time, so its magic multiplier is too.
  constexpr uint64_t kBypassMagic =
      ((static_cast<uint64_t>(1) << kRecipBits) + kBypassScale - 1)
      / kBypassScale;
  uint32_t chunks[16];
  int n = 0;
  for (;;) {
    uint32_t payload = u & 7u;
    u >>= 3;
    chunks[n++] = (u ? 8u : 0u) | payload;
    if (!u) break;
  }
  for (int i = n - 1; i >= 0; --i) {
    enc.put(chunks[i] * kBypassScale, kBypassScale, kBypassMagic);
  }
}

inline uint32_t get_bypass(Decoder& dec) {
  uint32_t u = 0;
  uint32_t shift = 0;
  for (;;) {
    uint32_t c = dec.peek() / kBypassScale;
    dec.advance(c * kBypassScale, kBypassScale);
    u |= (c & 7u) << shift;
    // u is 32-bit: valid streams never pass shift 30 (11 chunks max, the
    // encoder stops once u is exhausted). Cap the continuation loop there so
    // corrupted input cannot push shift to >= 32, which would be undefined
    // behavior on the uint32 accumulator (ADVICE r1).
    if (!(c & 8u) || shift >= 30) break;
    shift += 3;
  }
  return u;
}

// Symbol-search acceleration: per CDF row, a 256-bucket table mapping
// cum>>kLutShift to the LARGEST s with row[s] <= bucket_start. Decode then
// scans forward at most a few entries instead of binary-searching the whole
// row per symbol (measured 14.6 -> ~40+ Msym/s on the flagship payload; the
// build cost is ~(256+len) per row, amortized over n symbols per call).
constexpr uint32_t kLutBits = 8;
constexpr uint32_t kLutShift = kProbBits - kLutBits;
constexpr uint32_t kLutSize = 1u << kLutBits;

inline void build_row_lut(const int32_t* row, int32_t len, int32_t* lut) {
  // row has `len` entries: 0 = row[0] < ... < row[len-1] = 1<<16, coding
  // len-1 symbols. For each bucket b, lut[b] = max s : row[s] <= (b<<shift).
  int32_t s = 0;
  for (uint32_t b = 0; b < kLutSize; ++b) {
    const int32_t cum_b = static_cast<int32_t>(b << kLutShift);
    while (s + 2 < len && row[s + 1] <= cum_b) ++s;
    lut[b] = s;
  }
}

}  // namespace

extern "C" {

// Encode n values. Returns the byte length written to `out` (front-aligned),
// or -1 on buffer overflow / -2 on bad arguments.
// num_rows = len(cdf_lengths) (ABI v3): the per-(row,symbol) reciprocal
// magics are precomputed up front — one 64-bit division per TABLE entry
// instead of one 32-bit division per coded SYMBOL.
int64_t tpucdc_rans_encode(
    const int32_t* values, int64_t n, const int32_t* indexes,
    const int32_t* cdfs, int32_t cdf_stride, const int32_t* cdf_lengths,
    const int32_t* offsets, int32_t num_rows, uint8_t* out,
    int64_t capacity) {
  if (n < 0 || capacity < 8 || num_rows < 0) return -2;
  Encoder enc;
  enc.begin = out;
  enc.ptr = out + capacity;

  std::vector<uint64_t> magic(
      static_cast<size_t>(num_rows) * cdf_stride, 0);
  for (int32_t r = 0; r < num_rows; ++r) {
    const int32_t* row = cdfs + static_cast<int64_t>(r) * cdf_stride;
    uint64_t* mrow = magic.data() + static_cast<size_t>(r) * cdf_stride;
    for (int32_t s = 0; s + 1 < cdf_lengths[r]; ++s) {
      const uint32_t f = static_cast<uint32_t>(row[s + 1] - row[s]);
      // The table spec (cdf_utils.pmf_to_quantized_cdf) guarantees every
      // coded symbol f >= 1; a zero here is a corrupt/hand-built table.
      // Fail loudly — the old state/f division trapped; q=0 would instead
      // emit a bitstream that only fails at the far decoder.
      if (f == 0) return -2;
      mrow[s] = recip_magic(f);
    }
  }

  // LIFO: walk elements backward.
  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t r = indexes[i];
    if (r < 0 || r >= num_rows) return -2;
    const int32_t* row = cdfs + static_cast<int64_t>(r) * cdf_stride;
    const uint64_t* mrow = magic.data() + static_cast<size_t>(r) * cdf_stride;
    const int32_t len = cdf_lengths[r];      // len-1 symbols
    const int32_t esc = len - 2;             // escape symbol index
    int64_t s = static_cast<int64_t>(values[i]) - offsets[r];
    if (s < 0 || s >= esc) {
      // Bypass payload first (decoder reads it after the escape symbol).
      int64_t raw = (s < 0) ? s : (s - esc);  // re-center around the gap
      put_bypass(enc, zigzag(raw));
      enc.put(static_cast<uint32_t>(row[esc]),
              static_cast<uint32_t>(row[esc + 1] - row[esc]), mrow[esc]);
    } else {
      enc.put(static_cast<uint32_t>(row[s]),
              static_cast<uint32_t>(row[s + 1] - row[s]), mrow[s]);
    }
    if (enc.overflow) return -1;
  }
  enc.flush();
  if (enc.overflow) return -1;
  const int64_t nbytes = (out + capacity) - enc.ptr;
  std::memmove(out, enc.ptr, static_cast<size_t>(nbytes));
  return nbytes;
}

// Decode n values from `in`. Returns 0, or -1 on truncated input.
// num_rows = number of CDF rows (len(cdf_lengths)); rows are LUT-indexed
// up front, so callers must pass the full table row count (ABI v2).
int64_t tpucdc_rans_decode(
    const uint8_t* in, int64_t in_len, const int32_t* indexes, int64_t n,
    const int32_t* cdfs, int32_t cdf_stride, const int32_t* cdf_lengths,
    const int32_t* offsets, int32_t num_rows, int32_t* values_out) {
  if (n < 0 || in_len < 4 || num_rows < 0) return -2;
  Decoder dec;
  dec.ptr = in;
  dec.end = in + in_len;
  dec.init();

  std::vector<int32_t> lut(static_cast<size_t>(num_rows) * kLutSize);
  for (int32_t r = 0; r < num_rows; ++r) {
    build_row_lut(cdfs + static_cast<int64_t>(r) * cdf_stride,
                  cdf_lengths[r], lut.data() + static_cast<size_t>(r) * kLutSize);
  }

  for (int64_t i = 0; i < n; ++i) {
    const int32_t r = indexes[i];
    if (r < 0 || r >= num_rows) return -2;
    const int32_t* row = cdfs + static_cast<int64_t>(r) * cdf_stride;
    const int32_t len = cdf_lengths[r];
    const int32_t esc = len - 2;
    const uint32_t cum = dec.peek();

    // LUT bucket start, then a short forward scan: largest s, row[s] <= cum.
    int32_t s = lut[static_cast<size_t>(r) * kLutSize + (cum >> kLutShift)];
    while (static_cast<uint32_t>(row[s + 1]) <= cum) ++s;
    dec.advance(static_cast<uint32_t>(row[s]),
                static_cast<uint32_t>(row[s + 1] - row[s]));

    int64_t value;
    if (s == esc) {
      const int64_t raw = unzigzag(get_bypass(dec));
      value = ((raw < 0) ? raw : (raw + esc)) + offsets[r];
    } else {
      value = static_cast<int64_t>(s) + offsets[r];
    }
    values_out[i] = static_cast<int32_t>(value);
    if (dec.underflow) return -1;
  }
  return 0;
}

// Version tag so the Python side can assert ABI compatibility.
// v2: tpucdc_rans_decode takes num_rows before values_out (LUT decode).
// v3: tpucdc_rans_encode takes num_rows before out (reciprocal encode).
int32_t tpucdc_rans_abi_version() { return 3; }

}  // extern "C"
