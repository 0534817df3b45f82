// Exact softmax attention in bf16 at 64 < d <= 128, for Hopper (sm_90a): the
// DiT refiner's blocks (d = 72). attention.cu's tpucdc_attention calls it for
// bf16 at d > 64 where every pointer and stride is 16-byte aligned and the
// scale is positive; its header says what bounds the kernel and why it is
// built as it is. Kept in a file of its own so that nvcc compiles it beside
// attention.cu, not after it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxDevices = 64;

// Shape and element strides (batch, head, row) of one call.
struct S90Args {
  int H, Nq, Nk, d;
  long long qs[3], ks[3], vs[3], os[3];
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// attention_mma_kernel_sm90<WB, BN>: a block owns kS90Rows = 128 query rows
// of one (batch, head) and streams its keys in tiles of BN. Warpgroup 0 is
// the producer: one thread issues every TMA load (Q once, then K and V tiles
// into a ring of kS90Stages stages, K and V each with a full and an empty
// mbarrier per stage), and the warpgroup gives its registers to the others
// (setmaxnreg). Warpgroups 1 and 2 are consumers of 64 rows each: S = Q·Kᵀ
// by wgmma with both operands in shared memory, the online softmax on the
// accumulator fragments, O += P·V by wgmma with P as the register operand.
// Per key tile j a consumer issues QKᵀ(j) and P·V(j-1) in one turn; the two
// consumers take turns (named barriers 1 and 2), so that one's softmax runs
// while the other's products keep the tensor cores busy.
//
// Shared-memory layouts. Every row of q, k and v is split into part A, the
// columns 0..63 (128 bytes, 128-byte swizzle), and part B, the columns
// 64..64+WB-1 (WB in {16, 32, 64}: 32-, 64- or 128-byte swizzle), each a
// TMA box of its own; TMA zero-fills the columns past d and the rows past N,
// within the (batch, head) of the box. QKᵀ reads both parts K-major, so its
// depth is 64 + WB (80 at d = 72); P·V reads V's parts MN-major as two
// products of N = 64 and N = WB.

constexpr int kS90Stages = 2;     // K and V tiles in flight
constexpr int kS90Consumers = 2;  // consumer warpgroups of 64 rows
constexpr int kS90Rows = 64 * kS90Consumers;
constexpr int kS90Threads = 128 * (kS90Consumers + 1);

struct S90Maps {  // TMA descriptors, parts A and B of q, k and v
  CUtensorMap qa, qb, ka, kb, va, vb;
};

struct S90Params {
  int H, Nq, Nk, d, tiles;
  long long os[3];
  float sl2;  // scale * log2(e)
};

// Registers a thread of the producer and of a consumer holds after
// setmaxnreg: what the producer gives up covers what the consumers take.
constexpr int kS90ProducerRegs = 24, kS90ConsumerRegs = 240;
static_assert(kS90ProducerRegs * 128 + kS90ConsumerRegs * 128 * kS90Consumers <=
                  65536 / kS90Threads / 8 * 8 * kS90Threads,
              "the consumers' registers fit the block's");

template <int WB, int BN>
struct S90Shape {
  static constexpr int kPartA = 128, kPartB = 2 * WB;  // bytes per row
  static constexpr int kQA = 0;
  static constexpr int kQB = kQA + kS90Rows * kPartA;
  static constexpr int kTileA = BN * kPartA;
  static constexpr int kTile = BN * (kPartA + kPartB);  // K or V
  static constexpr int kStage0 = kS90Rows * (kPartA + kPartB);
  static constexpr int kBars = kStage0 + kS90Stages * 2 * kTile;
  // q, then kfull, vfull, kempty, vempty per stage
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kS90Stages) + 1024;
  // wgmma layout type of part B: 3 = 32-byte, 2 = 64-byte, 1 = 128-byte
  static constexpr uint32_t kLayoutB = WB == 16 ? 3u : WB == 32 ? 2u : 1u;
  static_assert(WB == 16 || WB == 32 || WB == 64, "part B is 16, 32 or 64");
  static_assert(BN == 64 || BN == 128, "a wgmma N of QKᵀ");
  static_assert(kQB % 1024 == 0 && kStage0 % 1024 == 0 && kTile % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d map (columns, rows, head, batch) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle of the layout.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A·B, A and B K-major in shared memory.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "n"(SCALE_D));
}

// D[64 x 128] (+)= A·B, A and B K-major in shared memory.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "n"(SCALE_D));
}

// D[64 x 16] += A·B, A (bf16) in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// D[64 x 32] += A·B, A (bf16) in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// D[64 x 64] += A·B, A (bf16) in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

template <int WB, int BN>
__global__ void __launch_bounds__(kS90Threads, 1)
    attention_mma_kernel_sm90(const __grid_constant__ S90Maps maps,
                              bf16* __restrict__ out, const S90Params p) {
  using L = S90Shape<WB, BN>;
  constexpr int KB = WB / 16;  // k-steps of QKᵀ in part B
  extern __shared__ __align__(1024) unsigned char s90_smem[];
  const uint32_t base = (smem_addr(s90_smem) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBars;
  auto kfull = [&](int s) { return bar_q + 8u * (1 + s); };
  auto vfull = [&](int s) { return bar_q + 8u * (1 + kS90Stages + s); };
  auto kempty = [&](int s) { return bar_q + 8u * (1 + 2 * kS90Stages + s); };
  auto vempty = [&](int s) { return bar_q + 8u * (1 + 3 * kS90Stages + s); };
  auto kaddr = [&](int s) { return base + L::kStage0 + 2u * L::kTile * s; };
  auto vaddr = [&](int s) { return kaddr(s) + L::kTile; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x % p.tiles, bh = blockIdx.x / p.tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int n_tiles = (p.Nk + BN - 1) / BN;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kS90Stages; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(vfull(s), 1);
      mbar_init(kempty(s), 4 * kS90Consumers);  // one arrival per consumer warp
      mbar_init(vempty(s), 4 * kS90Consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {  // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kS90ProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(bar_q, L::kStage0);
      tma_load(base + L::kQA, &maps.qa, bar_q, 0, tile * kS90Rows, h, b);
      tma_load(base + L::kQB, &maps.qb, bar_q, 64, tile * kS90Rows, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kS90Stages;
        const uint32_t free_parity = ((j / kS90Stages) & 1) ^ 1;
        const int key = j * BN;
        if (j >= kS90Stages) mbar_wait(kempty(s), free_parity);
        mbar_expect_tx(kfull(s), L::kTile);
        tma_load(kaddr(s), &maps.ka, kfull(s), 0, key, h, b);
        tma_load(kaddr(s) + L::kTileA, &maps.kb, kfull(s), 64, key, h, b);
        if (j >= kS90Stages) mbar_wait(vempty(s), free_parity);
        mbar_expect_tx(vfull(s), L::kTile);
        tma_load(vaddr(s), &maps.va, vfull(s), 0, key, h, b);
        tma_load(vaddr(s) + L::kTileA, &maps.vb, vfull(s), 64, key, h, b);
      }
    }
  } else {  // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kS90ConsumerRegs));
    const int cw = (warp >> 2) - 1, wi = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t qa = base + L::kQA + cw * 64 * L::kPartA;
    const uint32_t qb = base + L::kQB + cw * 64 * L::kPartB;
    const float sl2 = p.sl2;

    float sacc[BN / 2];        // S, 64 rows x BN keys over the warpgroup
    float oa[32], ob[WB / 2];  // O, columns 0..63 and 64..64+WB-1
    uint32_t pf[BN / 16][4];   // P in bf16, as A fragments per 16 keys
#pragma unroll
    for (int i = 0; i < 32; ++i) oa[i] = 0.f;
#pragma unroll
    for (int i = 0; i < WB / 2; ++i) ob[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    auto issue_qk = [&](int s) {
      const uint32_t ka = kaddr(s), kb = ka + L::kTileA;
      wgmma_ss<0>(sacc, gmma_desc(qa, 16, 1024, 1), gmma_desc(ka, 16, 1024, 1));
#pragma unroll
      for (int kk = 1; kk < 4; ++kk)
        wgmma_ss<1>(sacc, gmma_desc(qa + 32 * kk, 16, 1024, 1),
                    gmma_desc(ka + 32 * kk, 16, 1024, 1));
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
        wgmma_ss<1>(sacc, gmma_desc(qb + 32 * kk, 16, 8 * L::kPartB, L::kLayoutB),
                    gmma_desc(kb + 32 * kk, 16, 8 * L::kPartB, L::kLayoutB));
    };
    auto issue_pv = [&](int s) {
      const uint32_t va = vaddr(s), vb = va + L::kTileA;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_rs(oa, pf[kk], gmma_desc(va + kk * 16 * L::kPartA, 1024, 1024, 1));
        wgmma_rs(ob, pf[kk],
                 gmma_desc(vb + kk * 16 * L::kPartB, 8 * L::kPartB,
                           8 * L::kPartB, L::kLayoutB));
      }
    };
    // The online softmax of tile j on sacc, in log2 units; sacc becomes the
    // unrounded P. Returns the rescale of the rows' earlier O in c0, c1.
    auto softmax = [&](int j, float& c0, float& c1) {
      const int nvalid = p.Nk - j * BN;
      if (nvalid < BN) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int c = i * 8 + 2 * t;
          if (c >= nvalid) sacc[4 * i] = sacc[4 * i + 2] = -INFINITY;
          if (c + 1 >= nvalid) sacc[4 * i + 1] = sacc[4 * i + 3] = -INFINITY;
        }
      }
      // Four partial maxima and sums a row, so that no reduction is one chain.
      float pm0[4], pm1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pm0[u] = fmaxf(sacc[4 * u], sacc[4 * u + 1]);
        pm1[u] = fmaxf(sacc[4 * u + 2], sacc[4 * u + 3]);
      }
#pragma unroll
      for (int i = 4; i < BN / 8; ++i) {
        pm0[i % 4] = fmaxf(pm0[i % 4], fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        pm1[i % 4] = fmaxf(pm1[i % 4], fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
      float mx0 = fmaxf(fmaxf(pm0[0], pm0[1]), fmaxf(pm0[2], pm0[3]));
      float mx1 = fmaxf(fmaxf(pm1[0], pm1[1]), fmaxf(pm1[2], pm1[3]));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // sl2 > 0, so the largest scaled score is the largest score scaled; key
      // j * BN is valid, so the new maxima are finite.
      const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
      c0 = exp2f(m0 - mn0);
      c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float r0[4] = {0.f, 0.f, 0.f, 0.f}, r1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        sacc[4 * i] = exp2f(fmaf(sacc[4 * i], sl2, -mn0));
        sacc[4 * i + 1] = exp2f(fmaf(sacc[4 * i + 1], sl2, -mn0));
        sacc[4 * i + 2] = exp2f(fmaf(sacc[4 * i + 2], sl2, -mn1));
        sacc[4 * i + 3] = exp2f(fmaf(sacc[4 * i + 3], sl2, -mn1));
        r0[i % 4] += sacc[4 * i] + sacc[4 * i + 1];
        r1[i % 4] += sacc[4 * i + 2] + sacc[4 * i + 3];
      }
      l0 = l0 * c0 + ((r0[0] + r0[1]) + (r0[2] + r0[3]));
      l1 = l1 * c1 + ((r1[0] + r1[1]) + (r1[2] + r1[3]));
    };
    auto rescale_o = [&](float c0, float c1) {
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        oa[i] *= c0;
        oa[i + 1] *= c0;
        oa[i + 2] *= c1;
        oa[i + 3] *= c1;
      }
#pragma unroll
      for (int i = 0; i < WB / 2; i += 4) {
        ob[i] *= c0;
        ob[i + 1] *= c0;
        ob[i + 2] *= c1;
        ob[i + 3] *= c1;
      }
    };
    // P rounded to bf16 into A fragments: the m64nN accumulator layout of two
    // neighbouring 8-key blocks is the m64k16 register layout of A.
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pf[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    // Turns: consumer cw issues after named barrier 1 + cw, then lets the
    // next one go. The last consumer opens the first turn and does not pass
    // on its last, so that every barrier is completed as often as waited.
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
    };
    auto turn_pass = [&](bool more) {
      if (more || cw != kS90Consumers - 1)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (cw + 1) % kS90Consumers)
                     : "memory");
    };
    if (cw == kS90Consumers - 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

    mbar_wait(bar_q, 0);
    mbar_wait(kfull(0), 0);
    __syncwarp();
    reg_fence(sacc);
    turn_wait();
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    turn_pass(true);
    wgmma_wait<0>();
    reg_fence(sacc);
    if (lane == 0) mbar_arrive(kempty(0));
    float c0, c1;
    softmax(0, c0, c1);
    pack_p();

    // Per tile j: QKᵀ(j) and P·V(j-1) are issued in one turn; O is brought
    // to tile j-1's running max just before P·V(j-1).
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kS90Stages, sp = (j - 1) % kS90Stages;
      mbar_wait(kfull(s), (j / kS90Stages) & 1);
      mbar_wait(vfull(sp), ((j - 1) / kS90Stages) & 1);
      __syncwarp();
      reg_fence(sacc);
      turn_wait();
      wgmma_fence();
      issue_qk(s);
      wgmma_commit();
      rescale_o(c0, c1);
      reg_fence(oa);
      reg_fence(ob);
      wgmma_fence();
      issue_pv(sp);
      wgmma_commit();
      turn_pass(true);
      wgmma_wait<1>();  // QKᵀ(j) is done
      reg_fence(sacc);
      if (lane == 0) mbar_arrive(kempty(s));
      softmax(j, c0, c1);
      wgmma_wait<0>();  // P·V(j-1) is done: its P registers may be rewritten
      reg_fence(oa);
      reg_fence(ob);
      if (lane == 0) mbar_arrive(vempty(sp));
      pack_p();
    }
    {
      const int s = (n_tiles - 1) % kS90Stages;
      mbar_wait(vfull(s), ((n_tiles - 1) / kS90Stages) & 1);
      __syncwarp();
      rescale_o(c0, c1);
      reg_fence(oa);
      reg_fence(ob);
      turn_wait();
      wgmma_fence();
      issue_pv(s);
      wgmma_commit();
      turn_pass(false);
      wgmma_wait<0>();
      reg_fence(oa);
      reg_fence(ob);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int row0 = tile * kS90Rows + cw * 64 + wi * 16 + g, row1 = row0 + 8;
    bf16* o0 = out + b * p.os[0] + h * p.os[1] + row0 * p.os[2];
    bf16* o1 = o0 + 8 * p.os[2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = i * 8 + 2 * t;
      if (row0 < p.Nq)
        *reinterpret_cast<uint32_t*>(o0 + c) =
            pack_bf16(oa[4 * i] * inv0, oa[4 * i + 1] * inv0);
      if (row1 < p.Nq)
        *reinterpret_cast<uint32_t*>(o1 + c) =
            pack_bf16(oa[4 * i + 2] * inv1, oa[4 * i + 3] * inv1);
    }
#pragma unroll
    for (int i = 0; i < WB / 8; ++i) {
      const int c = 64 + i * 8 + 2 * t;  // d % 8 == 0: c < d means c + 1 < d
      if (c >= p.d) continue;
      if (row0 < p.Nq)
        *reinterpret_cast<uint32_t*>(o0 + c) =
            pack_bf16(ob[4 * i] * inv0, ob[4 * i + 1] * inv0);
      if (row1 < p.Nq)
        *reinterpret_cast<uint32_t*>(o1 + c) =
            pack_bf16(ob[4 * i + 2] * inv1, ob[4 * i + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library links against nothing but the runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// The map of one part of a [B,H,N,d] bf16 view with element strides
// s[0..2] (batch, head, row): boxes of `cols` columns by `rows` rows.
bool encode_part(CUtensorMap* map, const void* ptr, int B, int H, int N, int d,
                 const long long* s, int cols, int rows, CUtensorMapSwizzle sw) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)N, (cuuint64_t)H,
                              (cuuint64_t)B};
  // Bytes; a dimension of extent 1 is never stepped, so any valid stride.
  const cuuint64_t row = 2ull * s[2];
  const cuuint64_t strides[3] = {row, H > 1 ? 2ull * s[1] : row,
                                 B > 1 ? 2ull * s[0] : row};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1u, 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches the Hopper kernel; returns -1 where it does not apply (the caller
// then takes the general kernel).
template <int WB, int BN>
int launch_sm90(const void* q, const void* k, const void* v, void* out, int B,
                const S90Args& ap, cudaStream_t stream) {
  using L = S90Shape<WB, BN>;
  constexpr CUtensorMapSwizzle kSwB =
      WB == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
               : WB == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  constexpr CUtensorMapSwizzle kSwA = CU_TENSOR_MAP_SWIZZLE_128B;
  const int H = ap.H, Nq = ap.Nq, Nk = ap.Nk, d = ap.d;
  S90Maps maps;
  if (!encode_part(&maps.qa, q, B, H, Nq, d, ap.qs, 64, kS90Rows, kSwA) ||
      !encode_part(&maps.qb, q, B, H, Nq, d, ap.qs, WB, kS90Rows, kSwB) ||
      !encode_part(&maps.ka, k, B, H, Nk, d, ap.ks, 64, BN, kSwA) ||
      !encode_part(&maps.kb, k, B, H, Nk, d, ap.ks, WB, BN, kSwB) ||
      !encode_part(&maps.va, v, B, H, Nk, d, ap.vs, 64, BN, kSwA) ||
      !encode_part(&maps.vb, v, B, H, Nk, d, ap.vs, WB, BN, kSwB))
    return -1;
  S90Params p;
  p.H = H, p.Nq = Nq, p.Nk = Nk, p.d = d;
  p.tiles = (Nq + kS90Rows - 1) / kS90Rows;
  for (int i = 0; i < 3; ++i) p.os[i] = ap.os[i];
  p.sl2 = ap.scale * 1.4426950408889634f;
  const long long blocks = (long long)p.tiles * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = attention_mma_kernel_sm90<WB, BN>;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  kernel<<<(unsigned)blocks, kS90Threads, L::kBytes, stream>>>(
      maps, static_cast<bf16*>(out), p);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,Nq,d], k/v [B,H,Nk,d], out [B,H,Nq,d] in bf16, with the element
// strides of tpucdc_attention (batch, head, row of q, k, v, out). Returns a
// cudaError_t (0 = launched), or -1 where this kernel does not apply: d % 8
// != 0, or a map TMA cannot take (the caller then takes the general kernel).
extern "C" int tpucdc_attention_sm90(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int Nq, int Nk, int d,
                                     const long long* strides, float scale,
                                     void* stream) {
  if (d <= 64 || d > 128 || d % 8 != 0) return -1;
  S90Args a;
  a.H = H, a.Nq = Nq, a.Nk = Nk, a.d = d, a.scale = scale;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i], a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i], a.os[i] = strides[9 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Keys per tile: 128, and 64 where part B is 64 columns wide, so that S, P
  // and O fit the consumers' registers.
  if (d <= 80) return launch_sm90<16, 128>(q, k, v, out, B, a, st);
  if (d <= 96) return launch_sm90<32, 128>(q, k, v, out, B, a, st);
  return launch_sm90<64, 64>(q, k, v, out, B, a, st);
}
