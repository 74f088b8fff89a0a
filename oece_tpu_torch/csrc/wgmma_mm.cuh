// The Hopper int8 GEMM of the raw negacyclic products, for sm_90a:
//
//   out[b, m, k*T + t] = sum_x dig[b, x] * key(x, m*T + t | k)
//
// int32 [B, M, N], T = 128, nt = N/T, R digit rows, RT = R*T, x = j*RT +
// r*T + u in [0, K = nt*RT), M = 16 or 8 planes.  The key entry is the
// reversed-diagonal block's, rev[(nt-1-k)*RT + x, m*T + t] =
// ext[r, m, ((k - j)*T + t - u) mod 2N] (keys.rev_block).  It serves
// Pallas kernels #3 (diag_matmul_pallas, the block given) and #5
// (negacyclic_matmul_pallas, no block) of oece_tpu/fhe/pallas_kernels.py;
// negacyclic.cu holds their entries.  Its TMA, mbarrier, descriptor and
// wgmma helpers also serve the rotation GEMMs of rot_step.cu (#11, #12).
//
// wgmma takes 8-bit operands from shared memory only K-major, so both
// operands come in as [rows][128 contraction bytes] tiles in the 128-byte
// swizzle:
//   * the digits dig [B, K] are K-major already: one TMA box of 128 gates
//     x 128 bytes per stage, rows >= B filled with zeros by the TMA unit;
//   * #3: a pre-pass (transpose_kernel) writes the block transposed,
//     blockT [M*T, (2nt-1)*RT]; a TMA box of 256 columns x 128 bytes of it
//     at contraction offset (nt-1-k)*RT + 128c is stage c of output tile k;
//   * #5: no block.  With the reversed planes er[r, m, i] = ext[r, m, -i
//     mod 2N], column (m, t)'s 128 bytes of stage c (j = c / R, r = c % R)
//     are er[r, m, p(t) .. p(t)+127] (mod 2N), p(t) = ((j - k)*T - t) mod
//     2N: one window per column, one byte further back per t.  A pre-pass
//     (phase_expand_kernel) writes V = 32 shifted copies F[r, m, v, i] =
//     er[r, m, (i - v) mod 2N], i < 2N + 128 (4.5 MB at STD128_OPT,
//     L2-resident).  Then the windows of t0 + v (v < V, t0 % V == 0) all
//     start at x = p(t0) in copy v, so the V rows are one TMA box of F
//     [R*M*V rows, 2N + 128 bytes] at (x, (r*M + m)*V): 8 boxes per stage,
//     the padding keeps every window inside its row, and every box starts
//     32-byte aligned (16 copies gave 16-byte aligned boxes, which the TMA
//     unit reads markedly slower; 128 copies, aligned rows, would be a
//     block's worth of bytes again).
//
// Kernel (raw_gemm_kernel): persistent blocks of 384 threads walk tiles of
// 128 gates x 256 columns (two planes of one output tile k).  One thread of
// warpgroup 0 issues the TMA boxes into a ring of 4 stages of 48 KB, with a
// full and an empty mbarrier per stage; warpgroups 1 and 2 each run
// wgmma.m64n256k32.s32.s8.s8 on 64 gates, 4 per stage, one stage in
// flight while the next is waited for, and store their int32 accumulators
// straight from registers (8-byte stores; 32 contiguous bytes per row and
// warp instruction) while the loader already fills the next tile's
// stages.  setmaxnreg gives the loader 40 registers, the math 232.
//
// The sum is exact in int32: |sum| <= K * 128 * 128 <= 2**27.
// Bound on the H100 at STD128_OPT, B = 2048: 275 G int8 operations, 0.139
// ms at the 1,979 TOPS peak, against 134 MB of output (40 us of HBM):
// operations bound; the stages stream 48 KB per 8.4 M operations from L2.
// TMA boxes: at most 256 rows; the 128-byte swizzle takes 128-byte rows.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "int8_mm.cuh"

namespace {
namespace wgmm {

constexpr int T = 128;
constexpr int BM = 128;                   // gates per tile (2 x 64)
constexpr int BN = 256;                   // columns per tile (2 planes x T)
constexpr int BK = 128;                   // contraction bytes per stage
constexpr int STAGES = 4;
constexpr int V = 32;                     // #5's shifted key copies
constexpr int A_BYTES = BM * BK;          // 16 KB
constexpr int B_BYTES = BN * BK;          // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 384;              // warpgroup 0 loads, 1-2 compute
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The box of `map` at (x, y) (x the contiguous byte) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// The box of the 4D `map` at (x, y, z, w).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y, int z, int w) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(x), "r"(y), "r"(z), "r"(w)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused; the tile starts 1024-byte aligned, and +2 in the
// address field steps 32 contraction bytes (one k32 slice) inside it.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// The compiler must not move accumulator reads or writes across the
// asynchronous wgmma and its waits.
template <int NR>
__device__ __forceinline__ void fence_acc(int (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma_s8<N>: d (+)= A[64 x 32] * B[N x 32]^T, int8 -> int32, N/2
// accumulators a thread; scale_d = 0 overwrites.  N is any multiple of 16
// from 16 to 256: the gate tiles of the step GEMMs (step_gemm.cuh) and 8NB
// of their split GEMM, and 256 for raw_gemm_kernel.  WGMMA_S8(N, K, ...)
// below makes the instance of N from K = N/16 groups of 8 accumulator
// operands (%0 .. %(N/2 - 1)), then da, db and scale_d (%(N/2) ..
// %(N/2 + 2)).
template <int N>
__device__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

#define WG_S0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_S1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define WG_S2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define WG_S3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_S4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define WG_S5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define WG_S6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define WG_S7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_S8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define WG_S9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define WG_S10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define WG_S11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define WG_S12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define WG_S13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define WG_S14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define WG_S15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define WG_O8(i)                                                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]),     \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define WG_REGS1 WG_S0
#define WG_OUTS1 WG_O8(0)
#define WG_REGS2 WG_REGS1 ", " WG_S1
#define WG_OUTS2 WG_OUTS1, WG_O8(8)
#define WG_REGS3 WG_REGS2 ", " WG_S2
#define WG_OUTS3 WG_OUTS2, WG_O8(16)
#define WG_REGS4 WG_REGS3 ", " WG_S3
#define WG_OUTS4 WG_OUTS3, WG_O8(24)
#define WG_REGS5 WG_REGS4 ", " WG_S4
#define WG_OUTS5 WG_OUTS4, WG_O8(32)
#define WG_REGS6 WG_REGS5 ", " WG_S5
#define WG_OUTS6 WG_OUTS5, WG_O8(40)
#define WG_REGS7 WG_REGS6 ", " WG_S6
#define WG_OUTS7 WG_OUTS6, WG_O8(48)
#define WG_REGS8 WG_REGS7 ", " WG_S7
#define WG_OUTS8 WG_OUTS7, WG_O8(56)
#define WG_REGS9 WG_REGS8 ", " WG_S8
#define WG_OUTS9 WG_OUTS8, WG_O8(64)
#define WG_REGS10 WG_REGS9 ", " WG_S9
#define WG_OUTS10 WG_OUTS9, WG_O8(72)
#define WG_REGS11 WG_REGS10 ", " WG_S10
#define WG_OUTS11 WG_OUTS10, WG_O8(80)
#define WG_REGS12 WG_REGS11 ", " WG_S11
#define WG_OUTS12 WG_OUTS11, WG_O8(88)
#define WG_REGS13 WG_REGS12 ", " WG_S12
#define WG_OUTS13 WG_OUTS12, WG_O8(96)
#define WG_REGS14 WG_REGS13 ", " WG_S13
#define WG_OUTS14 WG_OUTS13, WG_O8(104)
#define WG_REGS15 WG_REGS14 ", " WG_S14
#define WG_OUTS15 WG_OUTS14, WG_O8(112)
#define WG_REGS16 WG_REGS15 ", " WG_S15
#define WG_OUTS16 WG_OUTS15, WG_O8(120)

#define WGMMA_S8(N, K, A, B, P)                                                                  \
  template <>                                                                                    \
  __device__ __forceinline__ void wgmma_s8<N>(int(&d)[N / 2], uint64_t da, uint64_t db,          \
                                              int scale_d) {                                     \
    static_assert(8 * K == N / 2 && A == N / 2 && B == A + 1 && P == A + 2, "operand numbers");  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                               \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" WG_REGS##K "}, %" #A   \
                 ", %" #B ", p;\n}\n"                                                            \
                 : WG_OUTS##K                                                                    \
                 : "l"(da), "l"(db), "r"(scale_d));                                              \
  }

WGMMA_S8(16, 1, 8, 9, 10)
WGMMA_S8(32, 2, 16, 17, 18)
WGMMA_S8(48, 3, 24, 25, 26)
WGMMA_S8(64, 4, 32, 33, 34)
WGMMA_S8(80, 5, 40, 41, 42)
WGMMA_S8(96, 6, 48, 49, 50)
WGMMA_S8(112, 7, 56, 57, 58)
WGMMA_S8(128, 8, 64, 65, 66)
WGMMA_S8(144, 9, 72, 73, 74)
WGMMA_S8(160, 10, 80, 81, 82)
WGMMA_S8(176, 11, 88, 89, 90)
WGMMA_S8(192, 12, 96, 97, 98)
WGMMA_S8(208, 13, 104, 105, 106)
WGMMA_S8(224, 14, 112, 113, 114)
WGMMA_S8(240, 15, 120, 121, 122)
WGMMA_S8(256, 16, 128, 129, 130)

struct GemmShape {
  int B, N, R, M;        // gates, ring size, digit rows, planes
  int tiles, gate_tiles;  // tiles = gate_tiles * nt * (M/2)
};

// tile -> (gate tile, output tile k, column tile ct), gate tile fastest.
__device__ __forceinline__ void tile_coords(const GemmShape& g, int tile, int& gt, int& k, int& ct) {
  gt = tile % g.gate_tiles;
  const int rest = tile / g.gate_tiles;
  ct = rest % (g.M / 2);
  k = rest / (g.M / 2);
}

// kPhase = false: #3, key_map is blockT's; true: #5, key_map is the
// shifted copies F's.  out int32 [B, M, N].
template <bool kPhase>
__global__ void __launch_bounds__(THREADS, 1) raw_gemm_kernel(
    const __grid_constant__ CUtensorMap dig_map, const __grid_constant__ CUtensorMap key_map,
    int* __restrict__ out, GemmShape g) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t full0 = ring + STAGES * STAGE_BYTES, empty0 = full0 + STAGES * 8;
  const int tid = threadIdx.x;
  const int nt = g.N / T, chunks = nt * g.R, two_n = 2 * g.N;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the loader
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid != 0) return;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      int gt, k, ct;
      tile_coords(g, tile, gt, k, ct);
      for (int c = 0; c < chunks; ++c) {
        const uint32_t a_s = ring + s * STAGE_BYTES, b_s = a_s + A_BYTES;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load(a_s, &dig_map, full, c * BK, gt * BM);
        if (!kPhase) {
          tma_load(b_s, &key_map, full, (nt - 1 - k) * g.R * T + c * BK, ct * BN);
        } else {
          const int j = c / g.R, r = c % g.R;
          for (int h = 0; h < 2; ++h)  // plane 2ct + h, rows t = V*a .. V*a + V-1
            for (int a = 0; a < T / V; ++a)
              tma_load(b_s + (h * T + V * a) * BK, &key_map, full,
                       ((j - k) * T - V * a) & (two_n - 1), (r * g.M + 2 * ct + h) * V);
        }
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // the math: warpgroup wg = 0 or 1 takes gates wg*64 .. +63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = tid / 128 - 1, lt = tid % 128, warp = lt / 32, lane = lt % 32;
  int d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    int gt, k, ct;
    tile_coords(g, tile, gt, k, ct);
    int prev = 0;
    for (int c = 0; c < chunks; ++c) {
      const uint32_t a_s = ring + s * STAGE_BYTES, b_s = a_s + A_BYTES;
      mbar_wait(full0 + 8 * s, ph);
      const uint64_t da = smem_desc(a_s + wg * 64 * BK), db = smem_desc(b_s);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8<256>(d, da + 2 * kk, db + 2 * kk, c > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(d);
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
      if (c > 0 && lt == 0) mbar_arrive(empty0 + 8 * prev);  // stage c-1 is read
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if (lt == 0) mbar_arrive(empty0 + 8 * prev);

    // accumulator i: row 16*warp + lane/4 (+8 for i & 2), column
    // 8*(i/4) + 2*(lane%4) + (i & 1) of the tile
    const int b_lo = gt * BM + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int m = 2 * ct + jj / 16, t = 8 * (jj % 16) + 2 * (lane % 4);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int b = b_lo + 8 * hi;
        if (b < g.B)
          *(int2*)(out + ((long long)b * g.M + m) * g.N + k * T + t) =
              make_int2(d[4 * jj + 2 * hi], d[4 * jj + 2 * hi + 1]);
      }
    }
  }
}

// block int8 [rows, cols] -> blockT [cols, rows], rows and cols multiples
// of 128: one 128 x 128 tile per block of 256 threads through shared
// memory.  Thread (word column w, row group q) reads 16 words down its
// column and transposes each 4 x 4 byte block with __byte_perm into 4
// output rows of 16 bytes; the 8 threads of one w are neighbours, so each
// warp store writes 4 whole 128-byte rows.  Words of row r sit XORed by
// 4*(r/16 % 8), so those reads hit 32 banks.  Bytes bound (each byte read
// and written once).
__global__ void __launch_bounds__(256) transpose_kernel(const int8_t* __restrict__ in,
                                                        int8_t* __restrict__ outT, int rows,
                                                        int cols) {
  __shared__ __align__(16) uint32_t tile[128 * 32];
  const int r0 = blockIdx.y * 128, c0 = blockIdx.x * 128, tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = tid + 256 * i, row = e / 8, c16 = e % 8;
    *(int4*)(tile + row * 32 + 4 * (c16 ^ ((row / 16) % 8))) =
        __ldg((const int4*)(in + (long long)(r0 + row) * cols + c0 + c16 * 16));
  }
  __syncthreads();
  const int q = (tid % 32) / 4, w = (tid / 32) * 4 + tid % 4;  // rows 16q.., columns 4w..
  uint32_t col[4][4];                                           // [column cb][rows 4a .. 4a+3]
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const uint32_t* src = tile + (16 * q + 4 * a) * 32 + (w ^ (4 * q));
    const uint32_t x[4] = {src[0], src[32], src[64], src[96]};
    uint32_t c[4];
    transpose4x4(x, c);
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) col[cb][a] = c[cb];
  }
#pragma unroll
  for (int cb = 0; cb < 4; ++cb)
    *(int4*)(outT + (long long)(c0 + 4 * w + cb) * rows + r0 + 16 * q) =
        make_int4((int)col[cb][0], (int)col[cb][1], (int)col[cb][2], (int)col[cb][3]);
}

// ext int8 [R*M planes, 2N] -> F [R*M, V, L], F[pl, v, i] = ext[pl,
// (v - i) mod 2N] for i < L = 2N + 128: one thread per 16 output bytes.
__global__ void phase_expand_kernel(const int8_t* __restrict__ ext, int8_t* __restrict__ F,
                                    int planes, int two_n) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_copy = (two_n + T) / 16;
  if (gid >= (long long)planes * V * per_copy) return;
  const int i0 = (int)(gid % per_copy) * 16, v = (int)((gid / per_copy) % V);
  const long long pl = gid / ((long long)V * per_copy);
  const uint8_t* src = (const uint8_t*)ext + pl * two_n;
  uint32_t w[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    w[a] = 0;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
      w[a] |= (uint32_t)src[(v - i0 - 4 * a - bb) & (two_n - 1)] << (8 * bb);
  }
  *(int4*)(F + gid * 16) = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda.so.1, which the process has
// loaded (so the library needs no -lcuda at link time).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h != nullptr) fn = (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// An int8 map of `rank` dimensions (dims[0] the contiguous bytes; strides
// in bytes of dims 1 .. rank-1, in any order), box `box` (box[0] = 128
// bytes), 128-byte swizzle, out-of-bounds elements read as zeros, no L2
// promotion (the operands are L2-resident; promotion read slower).
inline bool make_map_nd(CUtensorMap* map, const void* base, int rank, const long long* dims,
                        const long long* strides, const int* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rank > 5) return false;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    elem[i] = 1;
    if (i > 0) st[i - 1] = (cuuint64_t)strides[i - 1];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), d, st, bx, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2D int8 map of [rows, row_bytes] (row stride row_bytes), box [box_rows,
// 128 bytes], as make_map_nd.
inline bool make_map(CUtensorMap* map, const void* base, long long rows, long long row_bytes,
                     int box_rows) {
  const long long dims[2] = {row_bytes, rows}, strides[1] = {row_bytes};
  const int box[2] = {BK, box_rows};
  return make_map_nd(map, base, 2, dims, strides, box);
}

// dig int8 [B, nt*R*T] against key (kPhase: F [R, M, V, 2N + 128]; else
// blockT [M*T, (2nt-1)*R*T]) -> out int32 [B, M, N]; 0 or a cudaError_t.
template <bool kPhase>
int raw_gemm(const void* dig, const void* key, void* out, int B, int N, int R, int M,
             cudaStream_t st) {
  if (M != 16 && M != 8) return (int)cudaErrorInvalidValue;
  const int nt = N / T;
  const long long K = (long long)nt * R * T;
  CUtensorMap dig_map, key_map;
  const bool maps =
      make_map(&dig_map, dig, B, K, BM) &&
      (kPhase ? make_map(&key_map, key, (long long)R * M * V, 2LL * N + T, V)
              : make_map(&key_map, key, (long long)M * T, (2LL * nt - 1) * R * T, BN));
  if (!maps) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        raw_gemm_kernel<kPhase>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  GemmShape g{B, N, R, M, 0, (B + BM - 1) / BM};
  g.tiles = g.gate_tiles * nt * (M / 2);
  const int grid = g.tiles < sms ? g.tiles : sms;
  raw_gemm_kernel<kPhase><<<grid, THREADS, SMEM_BYTES, st>>>(dig_map, key_map, (int*)out, g);
  return (int)cudaGetLastError();
}

}  // namespace wgmm
}  // namespace
