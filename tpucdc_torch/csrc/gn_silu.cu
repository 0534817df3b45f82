// Fused GroupNorm + affine + SiLU over an NHWC slab, for Hopper (sm_90a).
//
// Replaces: tpucdc/ops/pallas/gn_silu.py::gn_silu_pallas (kernel
// _gn_silu_kernel). Same function: x [B, N, C] (bf16 or f32), gamma/beta
// [C] f32, G contiguous channel groups; f32 statistics; out = SiLU(GN(x)) in
// the input dtype.
//
// What bounds it on the H100: bytes, and below a few MB latency. Per element
// it reads x, writes out and does ~15 flops, far under the ~295 flop/byte
// ridge. The flagship's slabs are 0.1-4.7 MB in bf16, 2-3 µs of HBM time at
// most, so the number of launches, the barrier between the two passes and the
// width of each access weigh as much as the DRAM traffic.
//
// What the design does about it: one cooperative launch. The TPU kernel ran
// one program per image (its grid is sequential); here an image's rows are
// split over S blocks, all co-resident, and the statistics cross blocks
// through a small global scratch and one grid barrier:
//   1. Statistics. A thread owns a fixed run of V channels (16 bytes: 8 bf16
//      or 4 f32) and walks rows of its block's row range, so its channel
//      index never needs a division or a modulo per element. It keeps a
//      running (count, mean, M2) per channel (Welford; one reciprocal per
//      row, shared by the V channels). The block folds its threads'
//      per-channel statistics into per-group ones in shared memory, a team
//      of lanes per group and all groups at once, with two plain sums: a
//      weighted mean, and then the M2 about that mean,
//      M2 = sum(M2_t + n_t (mean_t - mean)^2), every term non-negative, so
//      nothing cancels as E[x^2] - mean^2 does when |mean| >> sigma. It
//      writes (count, mean, M2, 0) per group to scratch [B, G, S] of float4.
//   2. grid.sync().
//   3. Apply. Each block merges the S partials of its image's groups the
//      same way (a team of lanes per group, lanes over S, several loads in
//      flight per lane), then every thread folds
//      mean, rstd, gamma and beta of its V channels into registers once and
//      goes over its rows again: y = (x - mean) * scale + beta, y * sigmoid(y).
//      This second read hits the 50 MB L2 (the largest slab is a tenth of
//      it), so device memory is read once. (Keeping the rows in registers
//      between the passes instead measured no faster.)
// SiLU divides and exponentiates with the fast intrinsics (a few ulp of y,
// inside the 1e-5 the f32 check allows): with 8 channels a thread the exact
// division alone took more instruction slots than the loads and stores.
// A thread has few rows, so it waits for the latency of a load, not for
// bandwidth: it starts the loads of kInFlight rows before it uses the first.
// Where C * itemsize is not a multiple of 16, or x or out is not 16-byte
// aligned, the same kernel runs with V = 1 (scalar loads and stores). More
// channel runs than threads (C > 2048 in bf16) are taken in passes. The
// per-thread statistics of a block live in two shared arrays of kMaxEntries
// floats, which is what limits C to 3072.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEntries = 3072;  // (row lanes) x C per block, at most
constexpr int kMaxDevices = 64;
constexpr int kMergeLoads = 4;  // partials a lane loads before it uses one
constexpr int kInFlight = 4;    // rows a thread loads before it uses one

// V channels of one row: Raw is what one load brings, unpack widens it to f32.
template <typename T, int V> struct Run;

template <> struct Run<float, 1> {
  typedef float Raw;
  static __device__ __forceinline__ void unpack(Raw r, float (&v)[1]) { v[0] = r; }
  static __device__ __forceinline__ Raw pack(const float (&v)[1]) { return v[0]; }
};

template <> struct Run<__nv_bfloat16, 1> {
  typedef __nv_bfloat16 Raw;
  static __device__ __forceinline__ void unpack(Raw r, float (&v)[1]) {
    v[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[1]) {
    return __float2bfloat16_rn(v[0]);
  }
};

template <> struct Run<float, 4> {
  typedef float4 Raw;
  static __device__ __forceinline__ void unpack(Raw r, float (&v)[4]) {
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Run<__nv_bfloat16, 8> {
  typedef uint4 Raw;
  static __device__ __forceinline__ void unpack(Raw r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Sum over each aligned team of `team` lanes (a power of two up to 32); the
// whole warp calls it.
__device__ __forceinline__ float team_sum(float v, int team) {
  for (int o = team >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One more row into a channel's running (mean, M2); rn = 1 / rows so far.
template <int V>
__device__ __forceinline__ void welford(const float (&v)[V], float rn,
                                        float (&mean)[V], float (&m2)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float dv = v[i] - mean[i];
    mean[i] += dv * rn;
    m2[i] += dv * (v[i] - mean[i]);
  }
}

// partials is written before the grid barrier and read after it by other
// blocks, so it is neither const nor __restrict__.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_silu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, float4* partials,
               T* __restrict__ out, int B, int N, int C, int G, int S,
               float eps) {
  typedef typename Run<T, V>::Raw Raw;
  // bufm/bufq: per (row lane, channel) mean and M2 in pass 1; per group mean
  // and rstd in pass 2. bufn: rows seen per row lane.
  __shared__ float bufm[kMaxEntries];
  __shared__ float bufq[kMaxEntries];
  __shared__ float bufn[kThreads];

  const int tid = threadIdx.x;
  const int cpg = C / G;                  // channels per group
  const int runs = C / V;                 // channel runs per row
  const int txb = min(runs, kThreads);    // runs taken side by side
  const int ty_n = kThreads / txb;        // row lanes
  const int tx = tid % txb, ty = tid / txb;
  const bool active = ty < ty_n;
  const int rows_per = (N + S - 1) / S;
  const int items = B * S;                // (image, row range) pairs
  // Lanes that fold one group's statistics: the most that lets all G groups
  // be folded at once, a power of two so that a team sits inside a warp.
  int team = 32;
  while (team > 1 && team * G > kThreads) team >>= 1;
  const int teams = kThreads / team;
  const int tl = tid & (team - 1), tg = tid / team;
  const long long step = (long long)ty_n * C;  // elements between a thread's rows
  Raw rows[kInFlight];

  // ---- pass 1: statistics of each (image, row range) ----
  for (int wi = blockIdx.x; wi < items; wi += gridDim.x) {
    const int b = wi / S, s = wi - b * S;
    const int r0 = min(N, s * rows_per), r1 = min(N, r0 + rows_per);
    if (active) {
      for (int run = tx; run < runs; run += txb) {
        const int c0 = run * V;
        float mean[V], m2[V];
#pragma unroll
        for (int i = 0; i < V; ++i) mean[i] = 0.f, m2[i] = 0.f;
        float n = 0.f;
        const T* px = x + ((long long)b * N + r0 + ty) * C + c0;
        // kInFlight rows at a time: every load started before one is used.
        for (int r = r0 + ty; r < r1; r += kInFlight * ty_n, px += kInFlight * step) {
#pragma unroll
          for (int j = 0; j < kInFlight; ++j)
            if (r + j * ty_n < r1)
              rows[j] = *reinterpret_cast<const Raw*>(px + j * step);
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            if (r + j * ty_n < r1) {
              float v[V];
              Run<T, V>::unpack(rows[j], v);
              n += 1.f;
              welford<V>(v, __frcp_rn(n), mean, m2);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          bufm[ty * C + c0 + i] = mean[i];
          bufq[ty * C + c0 + i] = m2[i];
        }
        if (run == tx) bufn[ty] = n;
      }
    }
    __syncthreads();
    // A team of lanes per group, all groups at once where they fit: the
    // entries of a group are (row lane, channel of the group).
    for (int gb = 0; gb < G; gb += teams) {
      const int g = gb + tg;
      const bool valid = g < G;
      const float ref = valid ? bufm[g * cpg] : 0.f;  // row lane 0 has a row
      float wsum = 0.f;
      if (valid) {
        for (int y = tl; y < ty_n; y += team) {
          const float* pm = bufm + y * C + g * cpg;
          float part = 0.f;
          for (int c = 0; c < cpg; ++c) part += pm[c] - ref;
          wsum += bufn[y] * part;
        }
      }
      wsum = team_sum(wsum, team);
      const float count = (float)(r1 - r0) * (float)cpg;
      const float mu = count > 0.f ? ref + wsum / count : 0.f;
      float q = 0.f;
      if (valid) {
        for (int y = tl; y < ty_n; y += team) {
          const float* pm = bufm + y * C + g * cpg;
          const float* pq = bufq + y * C + g * cpg;
          float m2 = 0.f, dev2 = 0.f;
          for (int c = 0; c < cpg; ++c) {
            const float dm = pm[c] - mu;
            m2 += pq[c];
            dev2 += dm * dm;
          }
          q += m2 + bufn[y] * dev2;
        }
      }
      q = team_sum(q, team);
      if (valid && tl == 0)
        partials[((long long)b * G + g) * S + s] =
            make_float4(count, mu, count > 0.f ? q : 0.f, 0.f);
    }
    __syncthreads();  // the buffers are reused by the next item
  }

  cg::this_grid().sync();  // also orders the partials' writes before the reads

  // ---- pass 2: merge the partials, normalize, SiLU ----
  for (int wi = blockIdx.x; wi < items; wi += gridDim.x) {
    const int b = wi / S, s = wi - b * S;
    const int r0 = min(N, s * rows_per), r1 = min(N, r0 + rows_per);
    for (int gb = 0; gb < G; gb += teams) {
      const int g = gb + tg;
      const bool valid = g < G;
      const float4* p = partials + ((long long)b * G + (valid ? g : 0)) * S;
      const float ref = p[0].y;  // row range 0 is never empty
      float wsum = 0.f, count = 0.f;
      // kMergeLoads partials a lane at a time, so that their L2 latencies
      // overlap; .x = count, .y = mean, .z = M2.
      for (int i0 = tl; i0 < S; i0 += kMergeLoads * team) {
        float4 part[kMergeLoads];
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          const int i = i0 + u * team;
          part[u] = i < S ? p[i] : make_float4(0.f, ref, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          wsum += part[u].x * (part[u].y - ref);
          count += part[u].x;
        }
      }
      wsum = team_sum(wsum, team);
      count = team_sum(count, team);
      const float mu = ref + wsum / count;
      float q = 0.f;
      for (int i0 = tl; i0 < S; i0 += kMergeLoads * team) {
        float4 part[kMergeLoads];
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          const int i = i0 + u * team;
          part[u] = i < S ? p[i] : make_float4(0.f, mu, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          const float dm = part[u].y - mu;
          q += part[u].z + part[u].x * dm * dm;
        }
      }
      q = team_sum(q, team);
      if (valid && tl == 0) {
        bufm[g] = mu;
        bufq[g] = 1.f / sqrtf(q / count + eps);
      }
    }
    __syncthreads();
    if (active) {
      for (int run = tx; run < runs; run += txb) {
        const int c0 = run * V;
        float mu[V], sc[V], bt[V];
        int g = c0 / cpg, left = cpg - (c0 - g * cpg);  // channels left in g
#pragma unroll
        for (int i = 0; i < V; ++i) {
          mu[i] = bufm[g];
          sc[i] = bufq[g] * gamma[c0 + i];
          bt[i] = beta[c0 + i];
          if (--left == 0) ++g, left = cpg;
        }
        const long long off = ((long long)b * N + r0 + ty) * C + c0;
        const T* px = x + off;
        T* po = out + off;
        auto apply = [&](Raw raw, T* dst) {
          float v[V];
          Run<T, V>::unpack(raw, v);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float y = (v[i] - mu[i]) * sc[i] + bt[i];
            v[i] = __fdividef(y, 1.f + __expf(-y));
          }
          *reinterpret_cast<Raw*>(dst) = Run<T, V>::pack(v);
        };
        for (int r = r0 + ty; r < r1; r += kInFlight * ty_n,
                                      px += kInFlight * step,
                                      po += kInFlight * step) {
#pragma unroll
          for (int j = 0; j < kInFlight; ++j)
            if (r + j * ty_n < r1)
              rows[j] = *reinterpret_cast<const Raw*>(px + j * step);
#pragma unroll
          for (int j = 0; j < kInFlight; ++j)
            if (r + j * ty_n < r1) apply(rows[j], po + j * step);
        }
      }
    }
    __syncthreads();  // bufm/bufq are rewritten by the next item
  }
}

// Blocks of this kernel that one device holds at once: a cooperative launch
// takes no more. Asked once per device and kernel.
template <typename T, int V> int resident_blocks(int* blocks) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gn_silu_kernel<T, V>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms < 1) return (int)cudaErrorLaunchOutOfResources;
    cached[dev] = per_sm * sms;
  }
  *blocks = cached[dev];
  return 0;
}

template <typename T, int V>
int launch(const void* x, const void* gamma, const void* beta, void* out,
           void* partials, int B, int N, int C, int G, int S, float eps,
           cudaStream_t stream) {
  int resident = 0;
  const int rc = resident_blocks<T, V>(&resident);
  if (rc != 0) return rc;
  const long long items = (long long)B * S;
  const int grid = (int)(items < resident ? items : resident);
  void* args[] = {&x, &gamma, &beta, &partials, &out, &B, &N, &C, &G, &S, &eps};
  // (partials is a void* here and a float4* in the kernel: one pointer.)
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(gn_silu_kernel<T, V>), dim3(grid), dim3(kThreads),
      args, 0, stream);
}

template <typename T, int V>
int launch_vec_or_scalar(const void* x, const void* gamma, const void* beta,
                         void* out, void* partials, int B, int N, int C, int G,
                         int S, float eps, cudaStream_t stream) {
  const bool vec = (C * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    return launch<T, V>(x, gamma, beta, out, partials, B, N, C, G, S, eps, stream);
  return launch<T, 1>(x, gamma, beta, out, partials, B, N, C, G, S, eps, stream);
}

}  // namespace

// x, out: [B, N, C] contiguous; gamma, beta: [C] f32; partials: 16-byte
// aligned scratch of B*G*S*4 floats; S: row ranges per image, 1 <= S <= N.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int tpucdc_gn_silu(const void* x, const void* gamma,
                              const void* beta, void* out, void* partials,
                              int B, int N, int C, int G, int S, float eps,
                              int dtype, void* stream) {
  if (B < 1 || N < 1 || C < 1 || G < 1 || S < 1 || S > N || C % G != 0 ||
      C > kMaxEntries || (long long)B * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vec_or_scalar<float, 4>(x, gamma, beta, out, partials, B, N,
                                          C, G, S, eps, st);
  if (dtype == 1)
    return launch_vec_or_scalar<__nv_bfloat16, 8>(x, gamma, beta, out, partials,
                                                  B, N, C, G, S, eps, st);
  return (int)cudaErrorInvalidValue;
}
