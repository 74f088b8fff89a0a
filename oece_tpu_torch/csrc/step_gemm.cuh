// The pieces that the step loops of the rotated GINX form (rot_step.cu,
// #11 and #12), of the standard GINX form on prebuilt rev blocks
// (rev_step.cu, #8 and #9) and of the binary-base AP rotation (ap_step.cu,
// #13) share, for Hopper (sm_90a): programmatic dependent launch, the
// gadget digits of four coefficients packed into words, the wgmma GEMMs'
// tile shapes (64 key columns, the 4 limbs of 16 coefficients, on wgmma's
// M and NB gates on its N), the limb combine of the staged sums, the
// launch helpers, and the two GEMMs over a K-major prebuilt key
// (gemm_tiled, gemm_split: the bodies of rot_step.cu's and rev_step.cu's
// kernels; their design is described in rot_step.cu).

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

// The gadget digits of d in [0, Q) (pallas_kernels.py::_decompose_lanes),
// digit g into byte j of w[g]: shift > 0 is the approximate gadget
// (centre, round away `shift` bits, d_used signed digits), shift == 0 the
// exact one (signed digits, unsigned top digit).
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

// The tiled GEMMs' shapes: NB gates per tile (a multiple of 16), MW math
// warpgroups (64 key columns each) sharing the digit tile, as many stages
// as fit (at most 8) beside EXTRA bytes of the kernel's own, the
// epilogue's staging buffer of [64 columns x EPI_G gates] per warpgroup,
// which the epilogue fills EPI_PASSES times (the last pass NB % 64 gates
// where 64 does not divide NB).
template <int NB, int MW, int EXTRA = 0>
struct Cfg {
  static constexpr int A_BYTES = MW * COLS * wgmm::BK;
  static constexpr int STAGE = A_BYTES + NB * wgmm::BK;
  static constexpr int EPI_G = NB < 64 ? NB : 64;
  static constexpr int EPI_PASSES = (NB + EPI_G - 1) / EPI_G;
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
  int row_bytes;  // contraction bytes per key column: (2nt-1)*2RT (rev: (2nt-1)*RT)
  int R2T;        // contraction bytes per diagonal: 2RT (AP, rev: RT)
  int chunks;     // stages per tile: K / 128
  int gate_tiles, col_tiles, tiles;
  int polys;      // output polys per gate (4 key planes each): rot 2, rev 4 or 2
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


// The tiled GEMM of one step (the body of rot_step.cu's rot_gemm_kernel and
// rev_step.cu's rev_gemm_kernel, launched with Cfg<NB, MW>::THREADS
// threads and Cfg<NB, MW>::SMEM bytes): persistent blocks walk tiles of
// (output tile k, MW column chunks, NB gates) over the digits (dig_map, [B,
// K]) and the K-major key (key_map, [steps, planes, T, row_bytes]) at key
// step `step`.  kAdd: out = red31(acc_in + comb), acc_in and out [B, 2, N]
// (rot); else out = comb in [0, Q), out [B, polys, N] (rev), acc_in unused.
template <int NB, int MW, bool kAdd>
__device__ __forceinline__ void gemm_tiled(const CUtensorMap* dig_map, const CUtensorMap* key_map,
                                           const int* __restrict__ acc_in, int* __restrict__ out,
                                           const Shape& g, int step) {
  using C = Cfg<NB, MW>;
  static_assert(C::STAGES >= 4, "every gate tile keeps at least 4 stages in flight");
  constexpr int BK = wgmm::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wgmm::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t full0 = ring + C::STAGES * C::STAGE, empty0 = full0 + C::STAGES * 8;
  int* epi = (int*)(smem_raw + (ring - raw) + C::STAGES * (C::STAGE + 16));
  const int tid = threadIdx.x;
  const int nt = g.N / T;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      wgmm::mbar_init(full0 + 8 * s, 1);
      wgmm::mbar_init(empty0 + 8 * s, MW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  pdl_wait_and_release();  // the digits and acc_in are complete from here

  if (tid < 128) {  // the loader
    if constexpr (MW == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid != 0) return;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      int gt, k, ct;
      tile_coords(g, tile, gt, k, ct);
      const int x0 = (nt - 1 - k) * g.R2T;
      for (int c = 0; c < g.chunks; ++c) {
        const uint32_t a_s = ring + s * C::STAGE, b_s = a_s + C::A_BYTES;
        const uint32_t full = full0 + 8 * s;
        wgmm::mbar_wait(empty0 + 8 * s, ph ^ 1);
        wgmm::mbar_expect_tx(full, C::STAGE);
        for (int w = 0; w < MW; ++w) {  // planes 4o .. 4o+3, coefficients t0 .. t0+15
          const int cc = ct * MW + w, o = cc / (T / CHUNK), t0 = cc % (T / CHUNK) * CHUNK;
          wgmm::tma_load_4d(a_s + w * COLS * BK, key_map, full, x0 + c * BK, t0, 4 * o, step);
        }
        wgmm::tma_load(b_s, dig_map, full, c * BK, gt * NB);
        if (++s == C::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // the math: warpgroup wg takes key columns (ct*MW + wg) of each tile
  if constexpr (MW == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = tid / 128 - 1, lt = tid % 128, warp = lt / 32, lane = lt % 32;
  int* cs = epi + wg * COLS * C::EPI_PITCH;
  int d[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) d[i] = 0;
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    int gt, k, ct;
    tile_coords(g, tile, gt, k, ct);
    const int cc = ct * MW + wg, o = cc / (T / CHUNK), t0 = cc % (T / CHUNK) * CHUNK;
    // element r of this thread is coefficient t0 + lt%16 of gate
    // gt*NB + lt/16 + 8r; with kAdd its old accumulator values are loaded
    // while the products run
    const long long at0 = (long long)o * g.N + k * T + t0 + lt % CHUNK;
    const long long gate_stride = (long long)g.polys * g.N;
    int old[kAdd ? NB / 8 : 1];
    if constexpr (kAdd) {
#pragma unroll
      for (int r = 0; r < NB / 8; ++r) {
        const int b = gt * NB + lt / CHUNK + 8 * r;
        old[r] = b < g.B ? acc_in[b * gate_stride + at0] : 0;
      }
    }
    int prev = 0;
    for (int c = 0; c < g.chunks; ++c) {
      const uint32_t a_s = ring + s * C::STAGE, b_s = a_s + C::A_BYTES;
      wgmm::mbar_wait(full0 + 8 * s, ph);
      const uint64_t da = wgmm::smem_desc(a_s + wg * COLS * BK), db = wgmm::smem_desc(b_s);
      wgmm::fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmm::wgmma_s8<NB>(d, da + 2 * kk, db + 2 * kk, c > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmm::fence_acc(d);
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      wgmm::fence_acc(d);
      if (c > 0 && lt == 0) wgmm::mbar_arrive(empty0 + 8 * prev);  // stage c-1 is read
      prev = s;
      if (++s == C::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    wgmm::fence_acc(d);
    if (lt == 0) wgmm::mbar_arrive(empty0 + 8 * prev);

    // accumulator i: key column 16*warp + lane/4 (+8 for i & 2) of the
    // warpgroup's 64 (limb = warp), gate 8*(i/4) + 2*(lane%4) + (i & 1)
#pragma unroll
    for (int q = 0; q < C::EPI_PASSES; ++q) {
      wg_sync(wg);  // the previous pass has read cs
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) {  // this pass's gates: i / (EPI_G/2) == q
        if (i / (C::EPI_G / 2) != q) continue;
        const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1) - q * C::EPI_G;
        cs[row * C::EPI_PITCH + col] = d[i];
      }
      wg_sync(wg);
      const int t = lt % CHUNK;
#pragma unroll
      for (int it = 0; it < C::EPI_G / 8; ++it) {  // one (gate, coefficient t) each
        if (q * C::EPI_G + 8 * it >= NB) break;     // the last pass's NB % 64 gates
        const int gg = lt / CHUNK + 8 * it, b = gt * NB + q * C::EPI_G + gg;
        if (b >= g.B) continue;
        const int comb = combine_staged(cs, C::EPI_PITCH, t, gg, g.Q);
        if constexpr (kAdd)
          out[b * gate_stride + at0] = red31(old[q * C::EPI_G / 8 + it] + comb, g.Q);
        else
          out[b * gate_stride + at0] = comb;
      }
    }
  }
}

// The split GEMM's digit chunks in shared memory for NB gates.  With
// NB = 8 a chunk's 8 rows are one 8-row group of the swizzle, so the
// chunks lie chunk-major, [jj][substage][NB][128 bytes]: one box of all
// substages loads a chunk, only the chunks j in [0, nt) are loaded (the
// math warpgroup zeroes the others), and wgmma steps from chunk to chunk
// by the descriptor's 8-row group offset (SBO).  With NB = 16 they lie
// substage-major, [substage][jj][NB][128 bytes], one box of dpg + 7
// chunks per substage, and the TMA unit reads the chunks outside [0, nt)
// as zeros.
__host__ __device__ constexpr bool chunk_major(int NB) { return NB == 8; }

// wgmm::smem_desc with 8-row groups `sbo` bytes apart.
__device__ __forceinline__ uint64_t smem_desc_sbo(uint32_t addr, uint32_t sbo) {
  return (wgmm::smem_desc(addr) & ~(0x3FFFull << 32)) | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// The split GEMM of narrow batches (B <= NB <= 16; the body of
// rot_step.cu's rot_gemm_split_kernel and rev_step.cu's
// rev_gemm_split_kernel, 256 threads, split_smem bytes): block (column
// chunk cc = blockIdx % (polys*T/16), diagonal group blockIdx /
// (polys*T/16)) owns `dpg` consecutive diagonals d' of the block and reads
// each of their key tiles once.  Stage (d', s) of 128 contraction bytes
// serves every output tile k, against digit chunk j = d' - (nt-1-k) at
// substage s (SUB = R2T / 128 substages per chunk).  The block keeps the
// digits it needs in shared memory as [s][jj][NB gates] with jj = j -
// (d_lo - nt + 1), chunks of j outside [0, nt) read as zeros by the TMA
// unit (dig_map: [SUB, nt, B, 128 bytes], boxes of dpg+7 chunks x NB
// gates), so the B tile of stage (d', s) for k = 0 .. 7 is the 8*NB
// consecutive rows from (s, d' - d_lo): one wgmma.m64n(8NB)k32 per 32
// bytes computes all output tiles at once (column k*NB + b; columns of
// k >= nt are not used).  The epilogue combines each k's limb sums mod Q
// (the combine is linear mod Q, so partial sums combine as the whole
// does) and adds them atomically into sum [B, polys, N]: with at most 8
// groups, sum < 8Q.  With `early` the key is read-only for the whole call
// (the prebuilt key of a rotation), so the loader issues its first EARLY
// ring stages before it waits for the digits kernel: the key stream starts
// while that kernel runs, not after it.
template <int NB>
__device__ __forceinline__ void gemm_split(const CUtensorMap* dig_map, const CUtensorMap* key_map,
                                           int* __restrict__ sum, const Shape& g, int step, int dpg,
                                           int early) {
  constexpr int BK = wgmm::BK, A_BYTES = COLS * BK, STAGES = 8, EPI_PITCH = NB + 1;
  // ring stages issued before the wait: 8 slowed the digits kernel of 8
  // lanes (the 8 MB stream beside it) by more than the GEMM gained, 2 left
  // the GEMM 1 us slower (PERF.md, section 6)
  constexpr int EARLY = 4;
  constexpr int TILE_B = NB * BK;  // one digit chunk of the NB gates
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x, nt = g.N / T, sub = g.R2T / BK, jjs = dpg + 7;
  const uint32_t raw = wgmm::smem_addr(smem_raw);
  const uint32_t digits = (raw + 1023) & ~1023u;
  const uint32_t ring = digits + sub * jjs * TILE_B;
  const uint32_t full0 = ring + STAGES * A_BYTES, empty0 = full0 + STAGES * 8;
  const uint32_t dig_bar = empty0 + STAGES * 8;
  int* cs = (int*)(smem_raw + (dig_bar + 8 - raw));
  const int chunks = g.polys * (T / CHUNK);
  const int cc = blockIdx.x % chunks, grp = blockIdx.x / chunks;
  const int o = cc / (T / CHUNK), t0 = cc % (T / CHUNK) * CHUNK;
  const int d_lo = grp * dpg, d_hi = min(d_lo + dpg, 2 * nt - 1);
  // the digit tile of chunk jj (j = d_lo - nt + 1 + jj) at substage c; the
  // chunks jj in [jlo, jhi) have j in [0, nt)
  constexpr bool kChunks = chunk_major(NB);
  const auto dig_at = [&](int c, int jj) {
    return digits + (kChunks ? jj * sub + c : c * jjs + jj) * TILE_B;
  };
  const int jlo = max(0, nt - 1 - d_lo), jhi = min(jjs, 2 * nt - 1 - d_lo);
  // key stage q: diagonal d_lo + q / sub, substage q % sub
  const int stages = (d_hi - d_lo) * sub, pre = early ? min(stages, EARLY) : 0;
  const auto load_key = [&](int q) {
    const int s = q % STAGES;
    wgmm::mbar_wait(empty0 + 8 * s, ((q / STAGES) & 1) ^ 1);
    wgmm::mbar_expect_tx(full0 + 8 * s, A_BYTES);
    wgmm::tma_load_4d(ring + s * A_BYTES, key_map, full0 + 8 * s,
                      (d_lo + q / sub) * g.R2T + q % sub * BK, t0, 4 * o, step);
  };

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      wgmm::mbar_init(full0 + 8 * i, 1);
      wgmm::mbar_init(empty0 + 8 * i, 1);
    }
    wgmm::mbar_init(dig_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int q = 0; q < pre; ++q) load_key(q);  // no kernel writes the key
  pdl_wait_and_release();  // the digits are complete from here

  if (tid < 128) {  // the loader: the digit chunks once, then the key tiles
    if (tid != 0) return;
    if constexpr (kChunks) {  // chunk jj, all its substages
      wgmm::mbar_expect_tx(dig_bar, (jhi - jlo) * sub * TILE_B);
      for (int jj = jlo; jj < jhi; ++jj)
        wgmm::tma_load_4d(dig_at(0, jj), dig_map, dig_bar, 0, 0, d_lo - nt + 1 + jj, 0);
    } else {
      wgmm::mbar_expect_tx(dig_bar, sub * jjs * TILE_B);
      for (int c = 0; c < sub; ++c)  // chunks j = d_lo - nt + 1 .. +jjs-1 of substage c
        wgmm::tma_load_4d(dig_at(c, 0), dig_map, dig_bar, 0, 0, d_lo - nt + 1, c);
    }
    for (int q = pre; q < stages; ++q) load_key(q);
    return;
  }

  const int lt = tid - 128, warp = lt / 32, lane = lt % 32;
  int d[4 * NB];  // [64 columns x 8*NB (k, gate)]
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) d[i] = 0;
  if constexpr (kChunks) {  // zeros in the chunks outside [0, nt), which wgmma reads
    for (int jj = 0; jj < jjs; ++jj) {
      if (jj >= jlo && jj < jhi) continue;
      int4* z = (int4*)(smem_raw + (dig_at(0, jj) - raw));
      for (int v = lt; v < sub * TILE_B / 16; v += 128) z[v] = make_int4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
    wg_sync(0);
  }
  wgmm::mbar_wait(dig_bar, 0);
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int dd = d_lo; dd < d_hi; ++dd)
    for (int c = 0; c < sub; ++c) {
      wgmm::mbar_wait(full0 + 8 * s, ph);
      const uint64_t da = wgmm::smem_desc(ring + s * A_BYTES);
      const uint64_t db = smem_desc_sbo(dig_at(c, dd - d_lo), kChunks ? sub * TILE_B : 1024);
      wgmm::fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmm::wgmma_s8<8 * NB>(d, da + 2 * kk, db + 2 * kk, 1);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmm::fence_acc(d);
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      wgmm::fence_acc(d);
      if ((dd > d_lo || c > 0) && lt == 0) wgmm::mbar_arrive(empty0 + 8 * prev);  // stage read
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  wgmm::fence_acc(d);

  // accumulator i: key column 16*warp + lane/4 (+8 for i & 2), column
  // 8*(i/4) + 2*(lane%4) + (i & 1) = k*NB + gate, so k = i / (NB/2)
  const int t = lt % CHUNK;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= nt) break;
    wg_sync(0);  // the previous k has read cs
#pragma unroll
    for (int i = 0; i < 4 * NB; ++i) {
      if (i / (NB / 2) != k) continue;
      cs[(16 * warp + lane / 4 + 8 * ((i >> 1) & 1)) * EPI_PITCH + 8 * (i / 4) + 2 * (lane % 4) +
         (i & 1) - k * NB] = d[i];
    }
    wg_sync(0);
#pragma unroll
    for (int it = 0; it < NB / 8; ++it) {
      const int b = lt / CHUNK + 8 * it;
      if (b >= g.B) continue;
      const int comb = combine_staged(cs, EPI_PITCH, t, b, g.Q);
      atomicAdd(sum + ((long long)b * g.polys + o) * g.N + k * T + t0 + t, comb);
    }
  }
}

// Shared memory of the split GEMM: the digit chunks (sub = R2T / 128
// substages of dpg+7 chunks of NB gates), 8 stages of key tiles, their
// barriers, the epilogue's staging buffer.
inline int split_smem(int NB, int sub, int dpg) {
  return 1024 + sub * (dpg + 7) * NB * wgmm::BK + 8 * (COLS * wgmm::BK + 16) + 8 + COLS * (NB + 1) * 4;
}

constexpr int SPLIT_BLOCKS = 128;  // the split GEMM's blocks, at most: one wave on 132 SMs

// Diagonals per group of the split GEMM (rot.py: split_groups): the 2nt-1
// diagonals in at most SPLIT_BLOCKS / (polys * T/16) groups, one block per
// (group, column chunk).
inline int split_dpg(int N, int polys) {
  const int ndiag = 2 * (N / T) - 1, groups = SPLIT_BLOCKS / (polys * (T / CHUNK));
  return (ndiag + groups - 1) / groups;
}

// Whether a split GEMM block of `smem` bytes runs at N: its shared memory
// fits and one wgmma's 8NB columns hold every output tile (nt <= 8).
inline bool split_fits(int N, int smem) { return N / T <= 8 && smem <= SMEM_MAX; }

// The gate tile of a step GEMM of B gates, rot.py's gemm_config, for the
// AP step loop, which chooses per live step: the split GEMM at NB = 8 or
// 16 where fits[NB == 16] (split_fits at that NB), else the tiled GEMM on
// ceil(B / 256) gate tiles of NB = 16 * ceil(B / (16 * tiles)) gates (at
// least 32), two math warpgroups above 256 gates.
inline int gemm_tile(int B, const bool (&fits)[2]) {
  if (B <= 16 && fits[B > 8]) return B <= 8 ? 8 : 16;
  const int tiles = (B + 255) / 256, nb = 16 * ((B + 16 * tiles - 1) / (16 * tiles));
  return nb < 32 ? 32 : nb;
}

// One instance of the step GEMMs: NB gates per tile, MW math warpgroups.
template <int NB_, int MW_>
struct Tile {
  static constexpr int NB = NB_, MW = MW_;
  static constexpr bool SPLIT = NB <= 16;
};

// The narrowest gate tile of the rule above 256 gates (257 in two tiles),
// so the narrowest two-warpgroup instance.
constexpr int NB_TWO_WG = 144;

// f(Tile<NB, MW>{}) for the tiled GEMM's NB = nb (one of 32, 48, .. 256),
// two math warpgroups above 256 gates.
template <int NB, typename F>
int with_tiled(int nb, int B, F& f) {
  if (nb != NB) {
    if constexpr (NB < 256) return with_tiled<NB + 16>(nb, B, f);
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 256) return f(Tile<NB, 1>{});
  if constexpr (NB >= NB_TWO_WG) return f(Tile<NB, 2>{});
  return (int)cudaErrorInvalidValue;
}

// f(Tile<NB, MW>{}) for the gate tile NB that the caller was given or
// chose (gemm_tile): the split GEMM at NB = 8 or 16 for B <= NB gates
// where it `fits` (split_fits), the tiled GEMM at NB = 32, 48, .. 256,
// with two math warpgroups above 256 gates (NB >= NB_TWO_WG there).
// cudaErrorInvalidValue for any other tile, or a split that does not fit.
template <typename F>
int with_tile(int NB, int B, bool fits, F&& f) {
  if (NB <= 16 && (B > NB || !fits)) return (int)cudaErrorInvalidValue;
  if (NB == 8) return f(Tile<8, 1>{});
  if (NB == 16) return f(Tile<16, 1>{});
  return with_tiled<32>(NB, B, f);
}

// The TMA maps of a step GEMM: the key keyT as [steps, planes, T,
// row_bytes], boxes of 4 planes x 16 coefficients x 128 bytes; the digits
// dig as [dig_rows, K] with boxes of NB gates x 128 bytes (dpg = 0, the
// tiled GEMM), or for the split GEMM as [SUB substages, nt chunks j,
// dig_rows, 128 bytes] (strides 128, R2T, K) with boxes of NB gates x
// dpg+7 chunks, or (chunk_major) NB gates x all SUB substages of one
// chunk.  dig_rows runs to the end of the last NB-gate tile where the
// digits are the step loop's scratch, rows from B on zero.
inline bool make_maps(const void* keyT, int key_steps, int planes, const void* dig, int dig_rows,
                      const Shape& g, int NB, int dpg, CUtensorMap* dig_map, CUtensorMap* key_map) {
  const long long K = (long long)g.chunks * wgmm::BK, BK = wgmm::BK;
  const long long kdims[4] = {g.row_bytes, T, planes, key_steps};
  const long long kstrides[3] = {g.row_bytes, (long long)T * g.row_bytes,
                                 (long long)planes * T * g.row_bytes};
  const int kbox[4] = {wgmm::BK, CHUNK, 4, 1};
  const long long sdims[4] = {BK, dig_rows, g.N / T, g.R2T / BK};
  const long long sstrides[3] = {K, g.R2T, BK};
  const int sbox[4] = {wgmm::BK, NB, chunk_major(NB) ? 1 : dpg + 7,
                       chunk_major(NB) ? g.R2T / wgmm::BK : 1};
  return wgmm::make_map_nd(key_map, keyT, 4, kdims, kstrides, kbox) &&
         (dpg ? wgmm::make_map_nd(dig_map, dig, 4, sdims, sstrides, sbox)
              : wgmm::make_map(dig_map, dig, dig_rows, K, NB));
}

// A step GEMM's geometry for B gates, N, R2T contraction bytes per
// diagonal, `polys` output polys, NB gates per tile and MW warpgroups.
inline Shape step_shape(int B, int N, int Q, int R2T, int polys, int NB, int MW) {
  const int nt = N / T;
  Shape g{B, N, Q, (2 * nt - 1) * R2T, R2T, nt * R2T / wgmm::BK, (B + NB - 1) / NB,
          polys * (T / CHUNK) / MW, 0, polys};
  g.tiles = g.gate_tiles * nt * g.col_tiles;
  return g;
}

}  // namespace rotg
}  // namespace
