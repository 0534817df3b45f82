// Exact softmax attention for Hopper (sm_90a): the UNet's low-resolution
// levels (d <= 64) and the DiT refiner's blocks (d = 72).
//
// Replaces: tpucdc/ops/pallas/flash_attention.py::flash_attention_pallas
// (_run, kernel _attn_kernel). Same function: q [B,H,Nq,d], k/v [B,H,Nk,d],
// bf16 or f32; f32 scores, f32 softmax, P rounded to the V dtype before PV,
// PV accumulated in f32 and divided by the f32 row sum; output in q's dtype.
// Unlike the Pallas kernel it takes any Nq, any Nk >= 1 and any d <= 128, and
// reads q, k, v and writes out through element strides for the batch, head
// and row dimensions (last dimension contiguous), so the head view of a
// [B,N,H*d] projection is read in place and the output is written as
// [B,N,H,d] with no transposing copy around the launch.
//
// Dispatch (tpucdc_attention): f32 takes attention_fma_kernel; bf16 with
// d <= 64 takes attention_mma_kernel<16|32|64, 4, 4>; bf16 with d > 64 takes
// attention_mma_kernel_sm90 (attention_sm90.cu) where every pointer and
// stride is 16-byte aligned, d % 8 == 0 and the scale is positive, and
// attention_mma_kernel<128, 2, 2> otherwise. The two bf16 designs answer
// opposite bounds.
//
// bf16, d <= 64 (attention_mma_kernel): latency. At the flagship's shape
// (1,4,1536,24) a launch moves 1.2 MB and does 0.9 GFLOP, under 1 µs either
// way at peak rates; what is scarce is warps in flight: 6144 query rows are
// 384 warps of 16 rows for 528 warp schedulers. Both products run on the
// tensor cores with mma.sync.m16n8k16 (bf16 in, f32 accumulate). A block is
// ROWW x KS warps: ROWW row-warps of 16 query rows each, and the keys of
// every staged tile split over KS warps (4 x 4 here), so that the flagship's
// launch has 4x as many warps as row tiles; the KS partial (max, sum, O) of
// a row are merged through shared memory at the end. K and V tiles stay bf16
// in shared memory, arrive by 16-byte cp.async into two buffers (the next
// tile loads while this one is used), with a row pitch of DK+8 elements so
// that ldmatrix reads hit 32 distinct banks. Q fragments live in registers
// for the whole kernel; d is zero-padded to DK in {16,32,64,128} on the QK^T
// side only; the PV side skips output tiles past d (d=24: three n8 tiles).
// The softmax is online per 64-key tile, in f32 on the accumulator
// fragments: row max and row sum reduce over the 4 threads of a quad by
// shuffle, one rescale per tile, exp2 with log2(e) folded into the scale.
// Ragged key columns are set to -inf before the max; ragged query rows are
// computed and not stored. P is rounded to bf16 straight out of the S
// accumulators into A fragments (the m16n8 C layout of two neighbouring
// tiles is the m16k16 A layout) and never touches shared memory; V's B
// fragments come from ldmatrix.trans. Where a pointer or a stride is not
// 16-byte aligned, or d is not a multiple of 8, the same kernel loads and
// stores element by element.
//
// bf16, d > 64 (attention_mma_kernel_sm90, attention_sm90.cu): throughput.
// At the DiT's shape (1,16,6144,72) a launch does 174 GFLOP (0.176 ms at 989
// TFLOP/s) on 57 MB, so the tensor cores bound it; behind them come exp2 on
// the special-function units (one per score, at d = 72 nearly as long as the
// products) and the K and V tiles that every 128-row block streams again
// from L2 (1.4 GB a launch; on an H100 the loads alone take 0.29 ms of the
// kernel's 0.40). The design is Hopper's: wgmma on 64-row warpgroups (S =
// Q·Kᵀ from shared memory at depth 80, not 128; O += P·V with P in
// registers), K and V tiles brought by TMA into a ring of mbarrier-signalled
// stages by a producer warpgroup that gives its registers to the two
// consumer warpgroups, and the consumers' products issued in turns, so that
// one's softmax overlaps the other's products. Its arithmetic is the d <= 64
// design's: f32 scores, running max and sum, exp2 with log2(e) folded into
// the scale, P rounded to bf16 against the running max, f32 O divided by the
// f32 sum of the unrounded P; only the key tile differs (128 keys, 64 at
// d > 96, and no split).
//
// f32 design (attention_fma_kernel): full f32 on the FMA units (TF32's 10-bit
// mantissa cannot hold the 2e-5 bound). One query row is owned by DPAD/8
// threads with 8 dims each; K/V stream through shared memory in tiles
// (float4 loads where aligned); keys are taken four at a time, so that four
// butterfly reductions overlap and the running max is updated once per four.
//
// Rounding note: P is rounded to the V dtype as exp(s - m_running), against
// the running max and before the final normalization, where the plain
// version rounds softmax weights normalized by the final max and sum. In
// bf16 the two differ by a few bf16 steps of P; the kernel is checked
// against the plain version to 2e-2 * max|reference|. In f32 the rounding is
// the identity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>


// The Hopper kernel for bf16 at d > 64 (attention_sm90.cu); -1 where it
// does not apply.
extern "C" int tpucdc_attention_sm90(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int Nq, int Nk, int d,
                                     const long long* strides, float scale,
                                     void* stream);

namespace {

typedef __nv_bfloat16 bf16;

// Shape and element strides (batch, head, row) of one launch.
struct AttnParams {
  int H, Nq, Nk, d, tiles;
  long long qs[3], ks[3], vs[3], os[3];
  float scale;
  int vec;  // 16-byte loads and paired stores are safe
};

// ---------------------------------------------------------------- bf16 ----

constexpr int kBK = 64;  // keys per warp per staged tile
// Row-warps and key splits of a block for d <= 64 (d <= 128 takes 2 x 2 to
// keep its stage buffers inside one SM's shared memory). 4 x 4 was the
// fastest of eight block shapes tried at the flagship's shape on an H100,
// ahead of 2 x 4, 4 x 2 and 2 x 2; no key split (4 x 1, 8 x 1) and one
// row-warp (1 x 4) took nearly twice as long.
constexpr int kRowWarps = 4;
constexpr int kKeySplits = 4;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring q elements (col, col+1) of one row as an A-fragment word.
__device__ __forceinline__ uint32_t load_q_pair(const bf16* row, bool row_ok,
                                                int col, int d, bool vec) {
  if (!row_ok || col >= d) return 0u;
  if (vec) return *reinterpret_cast<const uint32_t*>(row + col);
  const uint32_t lo = __bfloat16_as_ushort(row[col]);
  const uint32_t hi = col + 1 < d ? __bfloat16_as_ushort(row[col + 1]) : 0u;
  return lo | (hi << 16);
}

template <int DK, int ROWW, int KS>
__global__ void __launch_bounds__(32 * ROWW * KS)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     const AttnParams p) {
  constexpr int NTHREADS = 32 * ROWW * KS;
  constexpr int KT = KS * kBK;      // keys per staged tile
  constexpr int PITCH = DK + 8;     // elements; PITCH*2/16 is odd
  constexpr int NT = kBK / 8;       // S n-tiles per warp
  constexpr int KSTEPS = DK / 16;   // k-steps of QK^T
  constexpr int NV = DK / 8;        // output n-tiles (those past d are skipped)
  constexpr int NREG = NV * 4 + 4;  // merged registers per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ksm = reinterpret_cast<bf16*>(smem_raw);  // [2][KT][PITCH]
  bf16* vsm = ksm + 2 * KT * PITCH;               // [2][KT][PITCH]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ws = warp % KS, rw = warp / KS;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x % p.tiles, bh = blockIdx.x / p.tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int d = p.d, Nq = p.Nq, Nk = p.Nk;
  const bool vec = p.vec != 0;
  const bf16* qb = q + b * p.qs[0] + h * p.qs[1];
  const bf16* kb = k + b * p.ks[0] + h * p.ks[1];
  const bf16* vb = v + b * p.vs[0] + h * p.vs[1];
  bf16* ob = out + b * p.os[0] + h * p.os[1];
  const long long krow = p.ks[2], vrow = p.vs[2];

  // The K columns d..DK-1 multiply q's zero padding: zero them once (the
  // loads below never write them), so that stale shared memory cannot be NaN.
  if (vec) {
    const int padc = (DK - d) / 8;
    for (int c = tid; c < 2 * KT * padc; c += NTHREADS) {
      const int row = c / padc, ch = c - row * padc;
      *reinterpret_cast<uint4*>(ksm + row * PITCH + d + ch * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  auto load_tile = [&](int it, int buf) {
    const int j0 = it * KT;
    bf16* kd = ksm + buf * KT * PITCH;
    bf16* vd = vsm + buf * KT * PITCH;
    if (vec) {
      const int cpr = d / 8;  // 16-byte chunks per row
      for (int c = tid; c < KT * cpr; c += NTHREADS) {
        const int row = c / cpr, ch = c - row * cpr;
        const int key = j0 + row;
        bf16* kdst = kd + row * PITCH + ch * 8;
        bf16* vdst = vd + row * PITCH + ch * 8;
        if (key < Nk) {
          cp_async16(kdst, kb + key * krow + ch * 8);
          cp_async16(vdst, vb + key * vrow + ch * 8);
        } else {
          *reinterpret_cast<uint4*>(kdst) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vdst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int e = tid; e < KT * DK; e += NTHREADS) {
        const int row = e / DK, dd = e % DK;
        const int key = j0 + row;
        const bool ok = key < Nk && dd < d;
        kd[row * PITCH + dd] = ok ? kb[key * krow + dd] : zero;
        vd[row * PITCH + dd] = ok ? vb[key * vrow + dd] : zero;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // Q fragments: rows r0 = g and r1 = g+8 of this warp's 16 query rows.
  const int row0 = (tile * ROWW + rw) * 16 + g, row1 = row0 + 8;
  const bf16* q0 = qb + row0 * p.qs[2];
  const bf16* q1 = qb + row1 * p.qs[2];
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_q_pair(q0, row0 < Nq, c, d, vec);
    qf[kk][1] = load_q_pair(q1, row1 < Nq, c, d, vec);
    qf[kk][2] = load_q_pair(q0, row0 < Nq, c + 8, d, vec);
    qf[kk][3] = load_q_pair(q1, row1 < Nq, c + 8, d, vec);
  }

  float o[NV][4];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nv][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale * 1.4426950408889634f;  // scores in log2 units

  const int iters = (Nk + KT - 1) / KT;
  load_tile(0, 0);
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) {
      load_tile(it + 1, (it + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();

    const int j0 = it * KT + ws * kBK;  // this warp's first key of the tile
    if (j0 < Nk) {
      const bf16* kt = ksm + ((it & 1) * KT + ws * kBK) * PITCH;
      const bf16* vt = vsm + ((it & 1) * KT + ws * kBK) * PITCH;

      // S = Q K^T, 16 rows x 64 keys per warp.
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          // Matrices: (keys nt, dims kk*16), (nt, +8), (nt+1, kk*16), (nt+1, +8).
          const int mi = lane >> 3;
          uint32_t r[4];
          ldmatrix_x4(r, kt + ((nt + (mi >> 1)) * 8 + (lane & 7)) * PITCH +
                             kk * 16 + (mi & 1) * 8);
          mma_bf16(s[nt], qf[kk], r[0], r[1]);
          mma_bf16(s[nt + 1], qf[kk], r[2], r[3]);
        }
      }

      // Online softmax on the fragments, in log2 units.
      const int nvalid = Nk - j0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] *= sl2;
      if (nvalid < kBK) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = nt * 8 + 2 * t;
          if (c >= nvalid) s[nt][0] = s[nt][2] = -INFINITY;
          if (c + 1 >= nvalid) s[nt][1] = s[nt][3] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // Key j0 is valid, so the new maxima are finite.
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        o[nv][0] *= corr0;
        o[nv][1] *= corr0;
        o[nv][2] *= corr1;
        o[nv][3] *= corr1;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - mn0);
        s[nt][1] = exp2f(s[nt][1] - mn0);
        s[nt][2] = exp2f(s[nt][2] - mn1);
        s[nt][3] = exp2f(s[nt][3] - mn1);
        l0 += s[nt][0] + s[nt][1];
        l1 += s[nt][2] + s[nt][3];
      }

      // O += P V, P rounded to bf16 in registers.
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int nv = 0; nv < NV; nv += 2) {
          if (nv * 8 < d) {
            // Matrices: (keys +0..7, dims nv), (keys +8..15, nv), then nv+1.
            uint32_t r[4];
            ldmatrix_x4_trans(r, vt + (kk * 16 + (lane & 15)) * PITCH +
                                     nv * 8 + (lane >> 4) * 8);
            mma_bf16(o[nv], a, r[0], r[1]);
            if ((nv + 1) * 8 < d) mma_bf16(o[nv + 1], a, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed before its buffer is refilled
  }

  // Row sums over the quad.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // Merge the KS key splits of each row-warp through shared memory (the
  // stage buffers are free after the loop's last barrier). Lane i of split s
  // holds the same fragment positions as lane i of split 0.
  if (KS > 1) {
    float* ms = reinterpret_cast<float*>(smem_raw);
    if (ws > 0) {
      float* dst = ms + ((rw * (KS - 1) + (ws - 1)) * NREG) * 32 + lane;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[(nv * 4 + i) * 32] = o[nv][i];
      dst[(NV * 4 + 0) * 32] = m0;
      dst[(NV * 4 + 1) * 32] = m1;
      dst[(NV * 4 + 2) * 32] = l0;
      dst[(NV * 4 + 3) * 32] = l1;
    }
    __syncthreads();
    if (ws == 0) {
      // Split 0 saw key 0, so m0 and m1 are finite; a split that saw no key
      // has m = -inf and weighs 0.
      for (int sp = 0; sp < KS - 1; ++sp) {
        const float* src = ms + ((rw * (KS - 1) + sp) * NREG) * 32 + lane;
        const float ms0 = src[(NV * 4 + 0) * 32], ms1 = src[(NV * 4 + 1) * 32];
        const float mt0 = fmaxf(m0, ms0), mt1 = fmaxf(m1, ms1);
        const float a0 = exp2f(m0 - mt0), b0 = exp2f(ms0 - mt0);
        const float a1 = exp2f(m1 - mt1), b1 = exp2f(ms1 - mt1);
        l0 = l0 * a0 + src[(NV * 4 + 2) * 32] * b0;
        l1 = l1 * a1 + src[(NV * 4 + 3) * 32] * b1;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          o[nv][0] = o[nv][0] * a0 + src[(nv * 4 + 0) * 32] * b0;
          o[nv][1] = o[nv][1] * a0 + src[(nv * 4 + 1) * 32] * b0;
          o[nv][2] = o[nv][2] * a1 + src[(nv * 4 + 2) * 32] * b1;
          o[nv][3] = o[nv][3] * a1 + src[(nv * 4 + 3) * 32] * b1;
        }
        m0 = mt0;
        m1 = mt1;
      }
    }
  }

  if (ws == 0) {
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    bf16* o0 = ob + row0 * p.os[2];
    bf16* o1 = ob + row1 * p.os[2];
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const int c = nv * 8 + 2 * t;
      if (c >= d) continue;
      if (vec) {
        if (row0 < Nq)
          *reinterpret_cast<uint32_t*>(o0 + c) =
              pack_bf16(o[nv][0] * inv0, o[nv][1] * inv0);
        if (row1 < Nq)
          *reinterpret_cast<uint32_t*>(o1 + c) =
              pack_bf16(o[nv][2] * inv1, o[nv][3] * inv1);
      } else {
        if (row0 < Nq) {
          o0[c] = __float2bfloat16_rn(o[nv][0] * inv0);
          if (c + 1 < d) o0[c + 1] = __float2bfloat16_rn(o[nv][1] * inv0);
        }
        if (row1 < Nq) {
          o1[c] = __float2bfloat16_rn(o[nv][2] * inv1);
          if (c + 1 < d) o1[c + 1] = __float2bfloat16_rn(o[nv][3] * inv1);
        }
      }
    }
  }
}

template <int DK, int ROWW, int KS>
int launch_mma(const void* q, const void* k, const void* v, void* out, int BH,
               AttnParams p, cudaStream_t stream) {
  constexpr int KT = KS * kBK;
  constexpr size_t smem = (size_t)2 * 2 * KT * (DK + 8) * sizeof(bf16);
  static_assert(smem >= (size_t)ROWW * (KS - 1) * (DK / 2 + 4) * 32 * 4,
                "the merge buffer reuses the stage buffers");
  p.tiles = (p.Nq + ROWW * 16 - 1) / (ROWW * 16);
  if ((long long)p.tiles * BH > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = attention_mma_kernel<DK, ROWW, KS>;
  // Above 48 KB of shared memory needs the opt-in, once per device.
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  kernel<<<p.tiles * BH, 32 * ROWW * KS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), p);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32 ----

constexpr int kFmaThreads = 128;
constexpr int kDimsPerThread = 8;
constexpr int kKeysPerStep = 4;

template <int DPAD>
__global__ void __launch_bounds__(kFmaThreads)
attention_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     const AttnParams p) {
  constexpr int TPR = DPAD / kDimsPerThread;  // threads per query row
  constexpr int ROWS = kFmaThreads / TPR;     // query rows per block
  constexpr int BK = DPAD <= 64 ? 64 : 32;    // keys per shared tile
  __shared__ __align__(16) float ks[BK][DPAD];
  __shared__ __align__(16) float vs[BK][DPAD];

  const int tile = blockIdx.x % p.tiles, bh = blockIdx.x / p.tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int d = p.d, Nq = p.Nq, Nk = p.Nk;
  const int row = tile * ROWS + threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * kDimsPerThread;
  const float* qr_ptr = q + b * p.qs[0] + h * p.qs[1] + row * p.qs[2];
  const float* kb = k + b * p.ks[0] + h * p.ks[1];
  const float* vb = v + b * p.vs[0] + h * p.vs[1];
  const long long krow = p.ks[2], vrow = p.vs[2];

  float qr[kDimsPerThread], acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const int dd = d0 + i;
    qr[i] = (row < Nq && dd < d) ? qr_ptr[dd] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < Nk; j0 += BK) {
    const int nk = min(BK, Nk - j0);
    __syncthreads();  // the previous tile is consumed
    if (p.vec) {
      for (int i = threadIdx.x; i < BK * (DPAD / 4); i += kFmaThreads) {
        const int j = i / (DPAD / 4), dd = (i % (DPAD / 4)) * 4;
        const bool ok = j < nk && dd < d;  // d % 4 == 0 on this path
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(&ks[j][dd]) =
            ok ? *reinterpret_cast<const float4*>(kb + (j0 + j) * krow + dd) : zero;
        *reinterpret_cast<float4*>(&vs[j][dd]) =
            ok ? *reinterpret_cast<const float4*>(vb + (j0 + j) * vrow + dd) : zero;
      }
    } else {
      for (int i = threadIdx.x; i < BK * DPAD; i += kFmaThreads) {
        const int j = i / DPAD, dd = i % DPAD;
        const bool ok = j < nk && dd < d;
        ks[j][dd] = ok ? kb[(j0 + j) * krow + dd] : 0.f;
        vs[j][dd] = ok ? vb[(j0 + j) * vrow + dd] : 0.f;
      }
    }
    __syncthreads();

    // Four keys a step (BK is a multiple of 4; keys past nk are masked).
    for (int j = 0; j < nk; j += kKeysPerStep) {
      float s[kKeysPerStep];
#pragma unroll
      for (int u = 0; u < kKeysPerStep; ++u) {
        s[u] = 0.f;
#pragma unroll
        for (int i = 0; i < kDimsPerThread; ++i) s[u] += qr[i] * ks[j + u][d0 + i];
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kKeysPerStep; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kKeysPerStep; ++u) {
        s[u] = j + u < nk ? s[u] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      if (mx > m) {
        const float corr = expf(m - mx);
        l *= corr;
#pragma unroll
        for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= corr;
        m = mx;
      }
#pragma unroll
      for (int u = 0; u < kKeysPerStep; ++u) {
        const float pr = expf(s[u] - m);
        l += pr;
#pragma unroll
        for (int i = 0; i < kDimsPerThread; ++i) acc[i] += pr * vs[j + u][d0 + i];
      }
    }
  }

  if (row < Nq) {
    const float inv = 1.f / l;
    float* orow = out + b * p.os[0] + h * p.os[1] + row * p.os[2];
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int dd = d0 + i;
      if (dd < d) orow[dd] = acc[i] * inv;
    }
  }
}

template <int DPAD>
int launch_fma(const void* q, const void* k, const void* v, void* out, int BH,
               AttnParams p, cudaStream_t stream) {
  constexpr int ROWS = kFmaThreads / (DPAD / kDimsPerThread);
  p.tiles = (p.Nq + ROWS - 1) / ROWS;
  if ((long long)p.tiles * BH > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attention_fma_kernel<DPAD><<<p.tiles * BH, kFmaThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// q [B,H,Nq,d], k/v [B,H,Nk,d], out [B,H,Nq,d], each with the element strides
// of its batch, head and row dimensions in strides[0..2] (q), [3..5] (k),
// [6..8] (v), [9..11] (out); the last dimension is contiguous.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int tpucdc_attention(const void* q, const void* k, const void* v,
                                void* out, int B, int H, int Nq, int Nk, int d,
                                const long long* strides, float scale,
                                int dtype, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || d < 1 || d > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  AttnParams p;
  p.H = H, p.Nq = Nq, p.Nk = Nk, p.d = d, p.tiles = 0, p.scale = scale;
  const int per16 = dtype == 1 ? 8 : 4;  // elements in 16 bytes
  bool vec = d % per16 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(out);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i], p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i], p.os[i] = strides[9 + i];
  }
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % per16 == 0;
  p.vec = vec ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (dtype == 1) {
    constexpr int R = kRowWarps, S = kKeySplits;
    if (d <= 16) return launch_mma<16, R, S>(q, k, v, out, BH, p, st);
    if (d <= 32) return launch_mma<32, R, S>(q, k, v, out, BH, p, st);
    if (d <= 64) return launch_mma<64, R, S>(q, k, v, out, BH, p, st);
    if (vec && scale > 0.f && isfinite(scale)) {
      const int rc = tpucdc_attention_sm90(q, k, v, out, B, H, Nq, Nk, d,
                                           strides, scale, stream);
      if (rc != -1) return rc;
    }
    return launch_mma<128, 2, 2>(q, k, v, out, BH, p, st);
  }
  if (d <= 16) return launch_fma<16>(q, k, v, out, BH, p, st);
  if (d <= 32) return launch_fma<32>(q, k, v, out, BH, p, st);
  if (d <= 64) return launch_fma<64>(q, k, v, out, BH, p, st);
  return launch_fma<128>(q, k, v, out, BH, p, st);
}
