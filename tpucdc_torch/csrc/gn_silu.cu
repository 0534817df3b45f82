// Fused GroupNorm + affine + SiLU over an NHWC slab, for Hopper (sm_90a).
//
// Replaces: tpucdc/ops/pallas/gn_silu.py::gn_silu_pallas (kernel
// _gn_silu_kernel). Same function: x [B, N, C] (bf16 or f32), gamma/beta
// [C] f32, G contiguous channel groups; f32 statistics; out = SiLU(GN(x)) in
// the input dtype.
//
// What bounds it on the H100: bytes. Per element it reads x twice (once
// for the statistics, once to normalize) and writes once, with ~10 flops;
// at 3.35 TB/s that is far below the ~295 flop/byte ridge. At the
// flagship's shapes a slab is 0.4-1.5 MB, so the second read comes from the
// 50 MB L2, and launch latency weighs as much as DRAM traffic.
//
// What the design does about it: the TPU kernel ran one program per image
// (the grid is sequential there). Here a per-image program would give B*1
// blocks on 132 SMs, so both passes are split across blocks:
//   1. gn_stats_kernel, grid (S, G, B): each block takes one row segment of
//      one (image, group) and writes (count, mean, M2) of that segment. The
//      segment is read twice (sum, then sum of squared deviations), the
//      second time from L1/L2, so the variance is a true two-pass one and
//      does not cancel like E[x²]-μ² when |μ| ≫ σ.
//   2. gn_apply_kernel, grid (tiles, B): each block merges the S partials of
//      every group of its image (Chan's parallel variance formula; S·G is a
//      few hundred floats, read from L2), folds mean, rstd, gamma and beta
//      into per-channel (mean, scale, beta) in shared memory, and streams its
//      row tile with coalesced loads: y = (x-mean)·scale + beta, y·σ(y).
// The partials buffer [B, G, S, 3] f32 is allocated by the caller.
// The group reads in pass 1 are strided (C/G contiguous channels per row);
// the other groups' blocks use the rest of each 32-byte sector through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// Sum of v over the block; every thread gets the same total.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // earlier readers of red[] are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < nwarps; ++w) total += red[w];
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                int N, int C, int G, int S) {
  __shared__ float red[32];
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int cg = C / G;
  const int rows_per = (N + S - 1) / S;
  const int r0 = min(N, s * rows_per);
  const int r1 = min(N, r0 + rows_per);
  const int count = (r1 - r0) * cg;
  const T* base = x + ((long long)b * N + r0) * C + (long long)g * cg;

  float sum = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int r = i / cg;
    sum += to_f32(base[(long long)r * C + (i - r * cg)]);
  }
  sum = block_sum(sum, red);
  const float mean = count > 0 ? sum / (float)count : 0.f;

  float m2 = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int r = i / cg;
    const float dv = to_f32(base[(long long)r * C + (i - r * cg)]) - mean;
    m2 += dv * dv;
  }
  m2 = block_sum(m2, red);

  if (threadIdx.x == 0) {
    float* p = partials + (((long long)b * G + g) * S + s) * 3;
    p[0] = (float)count;
    p[1] = mean;
    p[2] = m2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta,
                const float* __restrict__ partials, T* __restrict__ out,
                int N, int C, int G, int S, int rows_per_tile, float eps) {
  extern __shared__ float sm[];
  float* cmean = sm;           // [C]
  float* cscale = sm + C;      // [C]
  float* cbeta = sm + 2 * C;   // [C]
  float* gmean = sm + 3 * C;   // [G]
  float* grstd = gmean + G;    // [G]
  const int b = blockIdx.y;

  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float* p = partials + ((long long)b * G + g) * S * 3;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float nb = p[3 * s];
      if (nb == 0.f) continue;
      const float nt = n + nb;
      const float delta = p[3 * s + 1] - mean;
      mean += delta * (nb / nt);
      m2 += p[3 * s + 2] + delta * delta * (n * nb / nt);
      n = nt;
    }
    gmean[g] = mean;
    grstd[g] = 1.f / sqrtf(m2 / n + eps);
  }
  __syncthreads();
  const int cg = C / G;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    cmean[c] = gmean[g];
    cscale[c] = grstd[g] * gamma[c];
    cbeta[c] = beta[c];
  }
  __syncthreads();

  const int r0 = blockIdx.x * rows_per_tile;
  const int r1 = min(N, r0 + rows_per_tile);
  const long long off = ((long long)b * N + r0) * C;
  const int count = (r1 - r0) * C;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int c = i % C;
    float y = (to_f32(x[off + i]) - cmean[c]) * cscale[c] + cbeta[c];
    y = y / (1.f + expf(-y));
    out[off + i] = from_f32<T>(y);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out,
           void* partials, int B, int N, int C, int G, int S, float eps,
           cudaStream_t stream) {
  const dim3 sgrid(S, G, B);
  gn_stats_kernel<T><<<sgrid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partials), N, C, G, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_per_tile = C >= 2048 ? 1 : 2048 / C;  // ~2048 elements/block
  const dim3 agrid((N + rows_per_tile - 1) / rows_per_tile, B);
  const size_t smem = (3 * (size_t)C + 2 * (size_t)G) * sizeof(float);
  gn_apply_kernel<T><<<agrid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(partials),
      static_cast<T*>(out), N, C, G, S, rows_per_tile, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int tpucdc_gn_silu(const void* x, const void* gamma,
                              const void* beta, void* out, void* partials,
                              int B, int N, int C, int G, int S, float eps,
                              int dtype, void* stream) {
  if (B < 1 || N < 1 || C < 1 || G < 1 || S < 1 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, beta, out, partials, B, N, C, G, S, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, out, partials, B, N, C, G, S,
                                 eps, st);
  return (int)cudaErrorInvalidValue;
}
