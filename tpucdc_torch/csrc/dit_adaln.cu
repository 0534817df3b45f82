// The DiT block's adaLN norm chain in one pass, for Hopper (sm_90a): the
// gated residual add, LayerNorm, the adaLN modulation and the rounding to
// the compute dtype.
//
// Replaces no TPU kernel: the JAX package has no DiT (the port added DiT-XL/2
// as a second refiner), so there is none to port. It was added because the
// DiT decode ran this chain as separate PyTorch passes over the f32 residual
// stream ([1, 6144, 1152], 28.3 MB): LayerNorm, 1 + scale, addcmul, the bf16
// cast of the next product's input, the gate's mul and the residual add, 80
// bytes an element a block where the same mathematics needs 28.
//
// Function, per token row of x [B, N, C] f32, with the modulation rows
// gate, shift, scale [B, C] f32 of its image (any batch stride):
//   kRes:   x' = x + gate * y     (y [B, N, C], f32 or bf16; __fmul_rn then
//                                  __fadd_rn, so x' is bit-equal to
//                                  PyTorch's x + g * y)
//   kNorm:  h  = LN(x') * (1 + scale) + shift, rounded once to H (f32 or
//                bf16); LN over C at eps, no affine, f32 throughout
// (x' is x where kRes is off). The wrapper is ops/adaln.py.
//
// What bounds it on the H100: bytes. Per element it reads 4-6 bytes and
// writes 2-6, against ~10 flops, far under the ~295 flop/byte ridge. At the
// DiT-XL/2 decode's shape the three calls of a block move 6, 12 and 10 bytes
// an element: 12.7, 25.4 and 21.1 µs at 3.35 TB/s.
//
// What the design does about it: each byte crosses the bus once. A warp owns
// a token row; each lane loads runs of 4 channels (x as a float4, y as a
// float4 or four bf16 in 8 bytes), a warp's loads of one run index
// contiguous, and keeps the row in registers: kRuns = 9 runs a lane hold
// 1152 channels, DiT-XL/2's width and the widest row taken. The mean and the
// variance are two passes over those registers, reduced by warp shuffles, so
// nothing is read twice and the variance is taken about the mean (no
// E[x^2] - mean^2 cancellation). The three
// modulation rows of the block's image are staged in shared memory once a
// block of kWarps rows, with 1 + scale added there (rounded as PyTorch's
// 1.0 + scale is). No atomics, no scratch, no allocation, no
// synchronisation: a CUDA graph captures it as it does any kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // token rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRun = 4;    // channels a lane loads at once
constexpr int kRuns = 9;   // runs a lane: DiT-XL/2's 1152 channels, at most
constexpr int kMaxHidden = kRuns * 32 * kRun;

__device__ __forceinline__ void load4(const float* p, float (&v)[kRun]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[kRun]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[kRun]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[kRun]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// grid (row blocks, B); shared memory: [gate | shift | 1 + scale], C floats
// each, the rows a flag leaves out taking no room.
template <typename TY, typename TH, bool kRes, bool kNorm>
__global__ void __launch_bounds__(kThreads) dit_adaln_kernel(
    const float* __restrict__ x, const TY* __restrict__ y,
    const float* __restrict__ gate, const float* __restrict__ shift,
    const float* __restrict__ scale, long long gate_stride,
    long long shift_stride, long long scale_stride, float* __restrict__ x_out,
    TH* __restrict__ h, int N, int C, float eps) {
  extern __shared__ float4 smem4[];
  float* s_gate = reinterpret_cast<float*>(smem4);
  float* s_shift = s_gate + (kRes ? C : 0);
  float* s_scale = s_shift + C;
  const long long b = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    if constexpr (kRes) s_gate[c] = gate[b * gate_stride + c];
    if constexpr (kNorm) {
      s_shift[c] = shift[b * shift_stride + c];
      s_scale[c] = __fadd_rn(1.0f, scale[b * scale_stride + c]);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;
  const size_t base = (static_cast<size_t>(b) * N + row) * C;

  // The row, all its loads in flight before any is used.
  float v[kRuns][kRun];
  float w[kRuns][kRun];
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    const int c = (k * 32 + lane) * kRun;
    if (c < C) {
      load4(x + base + c, v[k]);
      if constexpr (kRes) load4(y + base + c, w[k]);
    }
  }

  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    const int c = (k * 32 + lane) * kRun;
    if (c < C) {
      if constexpr (kRes) {
        const float4 g = *reinterpret_cast<const float4*>(s_gate + c);
        v[k][0] = __fadd_rn(v[k][0], __fmul_rn(g.x, w[k][0]));
        v[k][1] = __fadd_rn(v[k][1], __fmul_rn(g.y, w[k][1]));
        v[k][2] = __fadd_rn(v[k][2], __fmul_rn(g.z, w[k][2]));
        v[k][3] = __fadd_rn(v[k][3], __fmul_rn(g.w, w[k][3]));
        store4(x_out + base + c, v[k]);
      }
      sum += (v[k][0] + v[k][1]) + (v[k][2] + v[k][3]);
    }
  }
  if constexpr (kNorm) {
    const float mean = warp_sum(sum) / static_cast<float>(C);
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      const int c = (k * 32 + lane) * kRun;
      if (c < C) {
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          v[k][i] -= mean;
          sq = fmaf(v[k][i], v[k][i], sq);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(C) + eps);
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      const int c = (k * 32 + lane) * kRun;
      if (c < C) {
        const float4 s = *reinterpret_cast<const float4*>(s_scale + c);
        const float4 t = *reinterpret_cast<const float4*>(s_shift + c);
        float o[kRun];
        o[0] = fmaf(v[k][0] * rstd, s.x, t.x);
        o[1] = fmaf(v[k][1] * rstd, s.y, t.y);
        o[2] = fmaf(v[k][2] * rstd, s.z, t.z);
        o[3] = fmaf(v[k][3] * rstd, s.w, t.w);
        store4(h + base + c, o);
      }
    }
  }
}

template <typename TY, typename TH, bool kRes, bool kNorm>
int launch(const void* x, const void* y, const void* gate, const void* shift,
           const void* scale, long long gate_stride, long long shift_stride,
           long long scale_stride, void* x_out, void* h, int B, int N, int C,
           float eps, cudaStream_t st) {
  const dim3 grid((N + kWarps - 1) / kWarps, B);
  const size_t smem = ((kRes ? 1 : 0) + (kNorm ? 2 : 0)) * C * sizeof(float);
  dit_adaln_kernel<TY, TH, kRes, kNorm><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const TY*>(y),
      static_cast<const float*>(gate), static_cast<const float*>(shift),
      static_cast<const float*>(scale), gate_stride, shift_stride,
      scale_stride, static_cast<float*>(x_out), static_cast<TH*>(h), N, C,
      eps);
  return (int)cudaGetLastError();
}

template <bool kRes, bool kNorm, typename TY>
int launch_h(int h_dtype, const void* x, const void* y, const void* gate,
             const void* shift, const void* scale, long long gs, long long ss,
             long long cs, void* x_out, void* h, int B, int N, int C,
             float eps, cudaStream_t st) {
  if constexpr (kNorm) {
    if (h_dtype == 1)
      return launch<TY, __nv_bfloat16, kRes, kNorm>(
          x, y, gate, shift, scale, gs, ss, cs, x_out, h, B, N, C, eps, st);
  }
  return launch<TY, float, kRes, kNorm>(x, y, gate, shift, scale, gs, ss, cs,
                                        x_out, h, B, N, C, eps, st);
}

}  // namespace

// y_dtype / h_dtype: -1 = not computed (no residual / no norm), 0 = float32,
// 1 = bfloat16. Strides are the modulation rows' batch strides, in floats.
// Returns cudaGetLastError() after the launch.
extern "C" int tpucdc_dit_adaln(const void* x, const void* y,
                                const void* gate, const void* shift,
                                const void* scale, long long gate_stride,
                                long long shift_stride,
                                long long scale_stride, void* x_out, void* h,
                                int B, int N, int C, float eps, int y_dtype,
                                int h_dtype, void* stream) {
  const bool res = y_dtype >= 0, norm = h_dtype >= 0;
  if (B < 1 || B > 65535 || N < 1 || C < 8 || C > kMaxHidden || C % 8 != 0 ||
      y_dtype < -1 || y_dtype > 1 || h_dtype < -1 || h_dtype > 1 ||
      !(res || norm))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!res)
    return launch_h<false, true, float>(h_dtype, x, y, gate, shift, scale,
                                        gate_stride, shift_stride,
                                        scale_stride, x_out, h, B, N, C, eps,
                                        st);
  if (y_dtype == 0)
    return norm ? launch_h<true, true, float>(h_dtype, x, y, gate, shift,
                                              scale, gate_stride, shift_stride,
                                              scale_stride, x_out, h, B, N, C,
                                              eps, st)
                : launch_h<true, false, float>(h_dtype, x, y, gate, shift,
                                               scale, gate_stride,
                                               shift_stride, scale_stride,
                                               x_out, h, B, N, C, eps, st);
  return norm ? launch_h<true, true, __nv_bfloat16>(
                    h_dtype, x, y, gate, shift, scale, gate_stride,
                    shift_stride, scale_stride, x_out, h, B, N, C, eps, st)
              : launch_h<true, false, __nv_bfloat16>(
                    h_dtype, x, y, gate, shift, scale, gate_stride,
                    shift_stride, scale_stride, x_out, h, B, N, C, eps, st);
}
