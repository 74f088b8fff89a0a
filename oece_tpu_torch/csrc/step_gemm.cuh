// The pieces that the step loops of the rotated GINX form (rot_step.cu,
// #11 and #12) and of the binary-base AP rotation (ap_step.cu, #13) share,
// for Hopper (sm_90a): programmatic dependent launch, the gadget digits of
// four coefficients packed into words, the wgmma GEMMs' tile shapes (64
// key columns, the 4 limbs of 16 coefficients, on wgmma's M and NB gates
// on its N), the limb combine of the staged sums, and the launch helpers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "int8_mm.cuh"
#include "wgmma_mm.cuh"

namespace {

// Programmatic dependent launch: each kernel of a step loop is launched
// while its predecessor still runs, waits here until the predecessor has
// finished and its writes are visible, and lets its own successor launch.
__device__ __forceinline__ void pdl_wait_and_release() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

constexpr int MAX_DIGITS = 4;  // d_used <= 4: ceil(27 / 7) digits of base 2**7

// The gadget digits of d (gadget_digits of int8_mm.cuh), digit g into
// byte j of w[g].
__device__ __forceinline__ void pack_digits(int d, uint32_t (&w)[MAX_DIGITS], int j, int d_used,
                                            int log_bg, int shift, int Q) {
  const int bg = 1 << log_bg, half = bg >> 1;
  int cur = d;
  if (shift > 0) {
    const int cen = d >= (Q + 1) / 2 ? d - Q : d;
    cur = (cen + (1 << (shift - 1))) >> shift;
  }
#pragma unroll
  for (int g = 0; g < MAX_DIGITS; ++g) {
    if (g >= d_used) break;
    int r = cur;
    if (g < d_used - 1) {
      if (shift > 0) {
        r = ((cur + half) & (bg - 1)) - half;
      } else {
        r = cur & (bg - 1);
        if (r >= half) r -= bg;
      }
      cur = (cur - r) >> log_bg;
    }
    w[g] |= (uint32_t)(uint8_t)(int8_t)r << (8 * j);
  }
}

namespace rotg {

constexpr int COLS = 64;   // key columns per math warpgroup: 4 limbs x 16 coefficients
constexpr int CHUNK = 16;  // coefficients per math warpgroup
constexpr int SMEM_MAX = 232448;

// The tiled GEMMs' shapes: NB gates per tile, MW math warpgroups (64 key
// columns each) sharing the digit tile, as many stages as fit (at most 8)
// beside EXTRA bytes of the kernel's own, the epilogue's staging buffer
// of [64 columns x EPI_G gates] per warpgroup.
template <int NB, int MW, int EXTRA = 0>
struct Cfg {
  static constexpr int A_BYTES = MW * COLS * wgmm::BK;
  static constexpr int STAGE = A_BYTES + NB * wgmm::BK;
  static constexpr int EPI_G = NB < 64 ? NB : 64;
  static constexpr int EPI_PITCH = EPI_G + 1;  // int32 words
  static constexpr int EPI_BYTES = MW * COLS * EPI_PITCH * 4;
  static constexpr int FIT = (SMEM_MAX - 1024 - EPI_BYTES - EXTRA) / (STAGE + 16);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int THREADS = 128 * (1 + MW);
  static constexpr int SMEM = 1024 + STAGES * (STAGE + 16) + EPI_BYTES + EXTRA;
  static_assert(STAGES >= 2, "the ring needs two stages");
};

// A tiled step GEMM's geometry (for AP, B is the step's live gates and
// row_bytes is unused).
struct Shape {
  int B, N, Q;
  int row_bytes;  // contraction bytes per key column: (2nt-1)*2RT
  int R2T;        // contraction bytes per diagonal: 2RT (AP: RT)
  int chunks;     // stages per tile: K / 128
  int gate_tiles, col_tiles, tiles;
};

// tile -> (gate tile, output tile k, column tile ct), gate tile fastest.
__device__ __forceinline__ void tile_coords(const Shape& g, int tile, int& gt, int& k, int& ct) {
  gt = tile % g.gate_tiles;
  const int rest = tile / g.gate_tiles;
  ct = rest % g.col_tiles;
  k = rest / g.col_tiles;
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// The Horner combine mod Q of the 4 limb sums of coefficient t, gate
// column gg, from the epilogue's staging buffer cs (limb l at row
// l*CHUNK + t).
__device__ __forceinline__ int combine_staged(const int* cs, int pitch, int t, int gg, int Q) {
  int comb = mod_q(cs[(3 * CHUNK + t) * pitch + gg], Q);
#pragma unroll
  for (int l = 2; l >= 0; --l) {
    comb = mul_pow8_mod(comb, Q) + mod_q(cs[(l * CHUNK + t) * pitch + gg], Q);
    if (comb >= Q) comb -= Q;
  }
  return comb;
}

// Launch with programmatic dependent launch (pdl_wait_and_release).
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), int grid, int threads, int smem, cudaStream_t st,
                   A&&... args) {
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{dim3(grid), dim3(threads), (size_t)smem, st, pdl, 1};
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
}

// Let `kernel` use all the shared memory of a block; `done` is the
// caller's flag for that kernel instance.
inline cudaError_t allow_smem(const void* kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  done = e == cudaSuccess;
  return e;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace rotg
}  // namespace
