// Exact softmax attention for the UNet's low-resolution levels, for Hopper
// (sm_90a).
//
// Replaces: tpucdc/ops/pallas/flash_attention.py::flash_attention_pallas
// (_run, kernel _attn_kernel). Same function: q [B,H,Nq,d], k/v [B,H,Nk,d],
// bf16 or f32; f32 scores, f32 softmax, P rounded to the V dtype before PV,
// PV accumulated in f32 and divided by the f32 row sum; output in q's dtype.
// Unlike the Pallas kernel it takes any Nq, Nk and any d <= 128: ragged q
// rows and k tiles are masked, and d is zero-padded inside the kernel to
// the next of 16/32/64/128 (the bf16 tensor-core k-width is 16), not to
// 128.
//
// What bounds it on the H100: at the flagship's shape (1,4,1536,24) it moves
// 1.2 MB of bf16 and does 0.9 GFLOP, under 1 µs either way at peak rates, so
// launch latency and the issue rate of this kernel's FMA loop bound it. This
// first version does the inner products on the FMA units, not the tensor
// cores (wgmma is a later change).
//
// Design: one block of 128 threads per (b·h, tile of query rows). Each query
// row is owned by DPAD/8 threads that each hold 8 of its q dims and 8 of its
// output accumulator dims in registers; a row's score is their partial dots
// summed by an xor butterfly (every lane ends with the bit-identical sum, so
// the row's online-softmax state stays uniform). K/V stream through shared
// memory in tiles of BK keys, converted to f32 once per tile. The softmax is
// online: a running max m and running sum l in f32; when a score raises m,
// l and the accumulator are rescaled by exp(m_old - m_new).
// Rounding note: P is rounded to the V dtype as exp(s - m_running), against
// the running max and before the final normalization, where the reference
// rounds softmax weights normalized by the final max and sum. In bf16 the
// two differ by a few bf16 ulps of P, well inside the 5e-2 bf16 tolerance;
// in f32 the rounding is the identity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDimsPerThread = 8;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// P rounded to the V dtype, as the reference casts softmax weights.
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f32<T>(from_f32<T>(p));
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 int Nq, int Nk, int d, float scale) {
  constexpr int TPR = DPAD / kDimsPerThread;  // threads per query row
  constexpr int ROWS = kThreads / TPR;        // query rows per block
  constexpr int BK = DPAD <= 64 ? 64 : 32;    // keys per shared tile
  __shared__ float ks[BK][DPAD];
  __shared__ float vs[BK][DPAD];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * kDimsPerThread;
  const long long qoff = ((long long)bh * Nq + row) * d;
  const long long kvoff = (long long)bh * Nk * d;

  float qr[kDimsPerThread], acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const int dd = d0 + i;
    qr[i] = (row < Nq && dd < d) ? to_f32(q[qoff + dd]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < Nk; j0 += BK) {
    const int nk = min(BK, Nk - j0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * DPAD; i += kThreads) {
      const int j = i / DPAD, dd = i % DPAD;
      const bool ok = j < nk && dd < d;
      const long long idx = kvoff + (long long)(j0 + j) * d + dd;
      ks[j][dd] = ok ? to_f32(k[idx]) : 0.f;
      vs[j][dd] = ok ? to_f32(v[idx]) : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) s += qr[i] * ks[j][d0 + i];
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      s *= scale;
      if (s > m) {
        const float corr = expf(m - s);
        l *= corr;
#pragma unroll
        for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= corr;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      const float pr = round_p<T>(p);
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) acc[i] += pr * vs[j][d0 + i];
    }
  }

  if (row < Nq) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int dd = d0 + i;
      if (dd < d) out[qoff + dd] = from_f32<T>(acc[i] * inv);
    }
  }
}

template <typename T, int DPAD>
int launch_padded(const void* q, const void* k, const void* v, void* out,
                  int BH, int Nq, int Nk, int d, float scale,
                  cudaStream_t stream) {
  constexpr int ROWS = kThreads / (DPAD / kDimsPerThread);
  const dim3 grid((Nq + ROWS - 1) / ROWS, BH);
  attention_kernel<T, DPAD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Nq, Nk, d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Nq, int Nk, int d, float scale, cudaStream_t stream) {
  if (d <= 16) return launch_padded<T, 16>(q, k, v, out, BH, Nq, Nk, d, scale, stream);
  if (d <= 32) return launch_padded<T, 32>(q, k, v, out, BH, Nq, Nk, d, scale, stream);
  if (d <= 64) return launch_padded<T, 64>(q, k, v, out, BH, Nq, Nk, d, scale, stream);
  return launch_padded<T, 128>(q, k, v, out, BH, Nq, Nk, d, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int tpucdc_attention(const void* q, const void* k, const void* v,
                                void* out, int BH, int Nq, int Nk, int d,
                                float scale, int dtype, void* stream) {
  if (BH < 1 || Nq < 1 || Nk < 1 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, BH, Nq, Nk, d, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, BH, Nq, Nk, d, scale, st);
  return (int)cudaErrorInvalidValue;
}
