// GINX blind rotation, CGGI rotated-difference form, for Hopper (sm_90a).
//
// Replaces the TPU kernel oece_tpu/fhe/pallas_kernels.py::_rot_megakernel
// (launched by blind_rotate_rot_megakernel, #12) with two kernels per
// step, looped over the n steps on the host side of this file
// (oece_blind_rotate_rot), and the per-step TPU kernel
// _rot_step_true_kernel (rot_step_true, #11, the lax.scan of
// OECE_ROT_MEGA=0) with the same kernels for any amount pair
// (oece_rot_step):
//
//   rot_diff_decompose_kernel  for each gate b, part p and accumulator poly:
//       d_p = (X^{c_p} * acc - acc) mod Q   (c_pos = 2N - a, c_neg = a, or
//       the pair (c_pos, c_neg) given per gate)
//       -> gadget digits, int8 scratch dig[b, j*2RT + p*RT + rr*T + u]
//   the step GEMM              for each output tile k (128 coefficients):
//       res[b, col] = sum_x dig[b, x] * keyT_i[col, (nt-1-k)*2RT + x]
//       acc'[b, o, kT+t] = red31(acc + combine_limbs(res[b, (o*4+l)*T+t]))
//
// The key is the rev2 block of every step stored K-major (keys.py), keyT
// int8 [n, 8T, (2nt-1)*2RT]: column (o, limb, t) = (o*4 + l)*T + t is a
// row of contraction bytes, which is how wgmma reads an 8-bit operand
// from shared memory.  One 4D TMA map over the whole key (the step is its
// outer coordinate) and one over the digits serve every step; a box of 4
// planes x 16 coefficients x 128 bytes lands limb l at rows 16l of a
// 64-row A tile.  Both GEMMs put these 64 key columns (the 4 limbs of 16
// coefficients of one output poly) on wgmma's M and the gates on its N
// ("swap AB"), so the 4 limb sums of a coefficient meet in one warpgroup
// and a narrow batch pays for no padded rows:
//
//   rot_gemm_kernel<NB, MW>    (B > 16) persistent blocks walk tiles of
//       (output tile k, MW column chunks, NB gates), NB = 32 .. 256 from B;
//       at B = 2048 two math warpgroups share each 256-gate digit tile, the
//       shape of wgmma_mm.cuh's GEMM for #3.  One thread of warpgroup 0
//       issues the boxes into a ring of mbarrier stages; the math
//       warpgroups run wgmma.m64nNBk32.s32.s8.s8, 4 per stage, stage the
//       [64 columns x NB gates] sums through shared memory and write acc_out
//       = red31(acc_in + comb), the Horner combine of the 4 limbs mod Q,
//       while the loader fills the next tile's stages.  Each thread loads
//       its acc_in values before the tile's products, so their latency
//       hides behind the MMAs (waited for in the epilogue, they cost a
//       third of the step at B = 2048).
//   rot_gemm_split_kernel<NB>  (B <= 16) each key tile is read once per
//       step: a block owns a column chunk and 2 of the block's 15
//       diagonals, and one wgmma per 32 bytes serves all 8 output tiles
//       (below); the partial sums meet in an int32 sum by atomics, which
//       the next step's digits kernel (or rot_finalize_kernel) adds to the
//       accumulator.
//
// The accumulator ping-pongs between two buffers: no block reads what
// another block of the same step writes, and the digits of a step are
// complete before its GEMM starts, which is the ordering the TPU kernel
// gets from its sequential grid.  Every kernel is launched with
// programmatic dependent launch: it waits for its predecessor inside
// (griddepcontrol.wait), so its launch and prologue overlap the
// predecessor's tail.  The launch helper, the tile shapes (Cfg, Shape)
// and the limb combine are in step_gemm.cuh, shared with ap_step.cu.
//
// Bounds on the H100.  One step costs nt*K*8T = 67 M int8 MACs per gate at
// STD128_OPT (K = nt*2R*T = 8192) and streams a 15.7 MB key block that
// every gate of the batch shares: at 4-8 lanes 4.7 us of HBM (bytes
// bound); the tiled GEMM's output tiles each read 8 of the block's 15
// diagonals (64 MB from L2), the split GEMM's blocks read it once.  At
// B = 2048 a step is 137 G MAC, 0.139 ms at the int8 peak (operations
// bound).  The contraction is exact in int32: |sum| <= K * 128 * 128 =
// 2**27.
//
// Left on the table: fusing the digits into the GEMM (one launch per
// step), a CUDA graph of the step loop, keeping the accumulator resident
// across steps in a persistent kernel, overlapping the tiled GEMM's
// epilogue with the next tile's MMAs, and gathering the key tiles from
// the compact key instead of the 7.9 GB prebuilt one.

#include <algorithm>

#include "int8_mm.cuh"
#include "step_gemm.cuh"
#include "wgmma_mm.cuh"

namespace {

// The accumulator value at flat index idx: acc itself or, with the split
// GEMM's sum of the previous step's products (< 8Q), red31(acc + sum)
// (< 9Q < 2**31, so one red31 suffices).
__device__ __forceinline__ int acc_value(const int* __restrict__ acc,
                                         const int* __restrict__ sum, long long idx, int Q) {
  return sum ? red31(acc[idx] + sum[idx], Q) : acc[idx];
}

// One thread per (gate b, accumulator poly pp, 4 coefficients m0 .. m0+3):
// both parts' rotated differences and their gadget digits, one 4-byte
// store per (part, digit).  The amounts are the pair c_part =
// amt[b*2 + part] when `pair`, else (2N - a, a) for
// a = amt[b*a_stride + step].  For the split GEMM: with sum_in, the
// accumulator is red31(acc + sum_in) and the thread writes its 4
// coefficients of it to acc_new; with sum_zero, it zeroes them there.
__global__ void rot_diff_decompose_kernel(
    const int* __restrict__ acc, const int* __restrict__ sum_in, int* __restrict__ acc_new,
    int* __restrict__ sum_zero, const int* __restrict__ amt, int a_stride,
    int step, int pair, int8_t* __restrict__ dig, int B, int N, int d_used,
    int log_bg, int shift, int Q) {
  pdl_wait_and_release();
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int quads = N / 4;
  if (gid >= (long long)B * 2 * quads) return;
  const int m0 = (int)(gid % quads) * 4;
  const int pp = (int)((gid / quads) & 1);
  const long long b = gid / (2 * quads);
  const long long row = (b * 2 + pp) * N;
  const int two_n = 2 * N;
  const int a = pair ? 0 : amt[b * a_stride + step];
  const int RT = 2 * d_used * T;
  const long long K = (long long)(N / T) * 2 * RT;
  int x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = acc_value(acc, sum_in, row + m0 + j, Q);
  if (sum_in) *(int4*)(acc_new + row + m0) = make_int4(x[0], x[1], x[2], x[3]);
  if (sum_zero) *(int4*)(sum_zero + row + m0) = make_int4(0, 0, 0, 0);
  int8_t* drow = dig + b * K + (m0 / T) * 2 * RT + pp * d_used * T + (m0 % T);
  for (int part = 0; part < 2; ++part) {
    const int c = pair ? amt[b * 2 + part] : part == 0 ? ((two_n - a) & (two_n - 1)) : a;
    const int cp = c & (N - 1);
    uint32_t w[MAX_DIGITS] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + j;
      const int src = acc_value(acc, sum_in, row + ((m - cp) & (N - 1)), Q);
      const bool wrap = (m < cp) != (c >= N);
      const int rot = wrap ? (src == 0 ? 0 : Q - src) : src;
      int d = rot - x[j];
      if (d < 0) d += Q;
      pack_digits(d, w, j, d_used, log_bg, shift, Q);
    }
#pragma unroll
    for (int g = 0; g < MAX_DIGITS; ++g)
      if (g < d_used) *(uint32_t*)(drow + part * RT + g * T) = w[g];
  }
}

// out = red31(acc + sum) after the split GEMM's last step: one thread per
// 4 entries of [B, 2, N].
__global__ void rot_finalize_kernel(const int* __restrict__ acc, const int* __restrict__ sum,
                                    int* __restrict__ out, long long total, int Q) {
  pdl_wait_and_release();
  const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i0 >= total) return;
  int v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = acc_value(acc, sum, i0 + j, Q);
  *(int4*)(out + i0) = make_int4(v[0], v[1], v[2], v[3]);
}

namespace rotg {

// One step of the rotation at key step `step`: acc_in int32 [B, 2, N] ->
// acc_out = red31(acc_in + products), from the digits (dig_map, [B, K])
// and the K-major key (key_map, [n, 8T, row_bytes]).
template <int NB, int MW>
__global__ void __launch_bounds__(Cfg<NB, MW>::THREADS, 1) rot_gemm_kernel(
    const __grid_constant__ CUtensorMap dig_map, const __grid_constant__ CUtensorMap key_map,
    const int* __restrict__ acc_in, int* __restrict__ acc_out, Shape g, int step) {
  using C = Cfg<NB, MW>;
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
          wgmm::tma_load_4d(a_s + w * COLS * BK, &key_map, full, x0 + c * BK, t0, 4 * o, step);
        }
        wgmm::tma_load(b_s, &dig_map, full, c * BK, gt * NB);
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
    // the epilogue's old accumulator values, loaded while the products run:
    // element r of this thread is coefficient t0 + lt%16 of gate
    // gt*NB + lt/16 + 8r
    const long long at0 = (long long)o * g.N + k * T + t0 + lt % CHUNK;
    int old[NB / 8];
#pragma unroll
    for (int r = 0; r < NB / 8; ++r) {
      const int b = gt * NB + lt / CHUNK + 8 * r;
      old[r] = b < g.B ? acc_in[(long long)b * 2 * g.N + at0] : 0;
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
    for (int q = 0; q < NB / C::EPI_G; ++q) {
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
        const int gg = lt / CHUNK + 8 * it, b = gt * NB + q * C::EPI_G + gg;
        if (b >= g.B) continue;
        const int comb = combine_staged(cs, C::EPI_PITCH, t, gg, g.Q);
        acc_out[(long long)b * 2 * g.N + at0] = red31(old[q * C::EPI_G / 8 + it] + comb, g.Q);
      }
    }
  }
}

// The split GEMM of narrow batches (B <= NB <= 16): each block owns one
// column chunk cc (as a math warpgroup of rot_gemm_kernel) and a group of
// `dpg` consecutive diagonals d' of the block, and reads each of their key
// tiles once.  The stage (d', s) of 128 contraction bytes serves every
// output tile k, against digit chunk j*SUB + s with j = d' - (nt-1-k)
// (SUB = 2RT / 128).  The block keeps the digits it needs in shared
// memory as [s][jj][NB gates] with jj = j - (d_lo - nt + 1), chunks of j
// outside [0, nt) read as zeros by the TMA unit, so the B tile of stage
// (d', s) for k = 0 .. 7 is the 8*NB consecutive rows from (s, d' - d_lo):
// one wgmma.m64n(8NB)k32 per 32 bytes computes all output tiles at once
// (column k*NB + b; columns of k >= nt are not used).  So the 15.7 MB
// block is read from L2 about once per step (rot_gemm_kernel's tiles read
// 64 MB), over the 16 x 8 blocks.  The epilogue combines each k's limb
// sums mod Q (the combine is linear mod Q, so partial sums combine as the
// whole does) and adds them atomically into sum [B, 2, N] (< 8Q): the
// next step's digits kernel, or rot_finalize_kernel, takes red31(acc +
// sum).
template <int NB>
__global__ void __launch_bounds__(256, 1) rot_gemm_split_kernel(
    const __grid_constant__ CUtensorMap dig_map, const __grid_constant__ CUtensorMap key_map,
    int* __restrict__ sum, Shape g, int step, int dpg) {
  constexpr int BK = wgmm::BK, A_BYTES = COLS * BK, STAGES = 8, EPI_PITCH = NB + 1;
  constexpr int TILE_B = NB * BK;  // one digit chunk of the NB gates
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x, nt = g.N / T, sub = g.R2T / BK, jjs = dpg + 7;
  const uint32_t raw = wgmm::smem_addr(smem_raw);
  const uint32_t digits = (raw + 1023) & ~1023u;
  const uint32_t ring = digits + sub * jjs * TILE_B;
  const uint32_t full0 = ring + STAGES * A_BYTES, empty0 = full0 + STAGES * 8;
  const uint32_t dig_bar = empty0 + STAGES * 8;
  int* cs = (int*)(smem_raw + (dig_bar + 8 - raw));
  const int cc = blockIdx.x % (2 * T / CHUNK), grp = blockIdx.x / (2 * T / CHUNK);
  const int o = cc / (T / CHUNK), t0 = cc % (T / CHUNK) * CHUNK;
  const int d_lo = grp * dpg, d_hi = min(d_lo + dpg, 2 * nt - 1);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      wgmm::mbar_init(full0 + 8 * i, 1);
      wgmm::mbar_init(empty0 + 8 * i, 1);
    }
    wgmm::mbar_init(dig_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  pdl_wait_and_release();  // the digits are complete from here

  if (tid < 128) {  // the loader: the digit chunks once, then the key tiles
    if (tid != 0) return;
    wgmm::mbar_expect_tx(dig_bar, sub * jjs * TILE_B);
    for (int c = 0; c < sub; ++c)  // chunks j = d_lo - nt + 1 .. +jjs-1 of substage c
      wgmm::tma_load_4d(digits + c * jjs * TILE_B, &dig_map, dig_bar, 0, 0, d_lo - nt + 1, c);
    int s = 0;
    uint32_t ph = 0;
    for (int dd = d_lo; dd < d_hi; ++dd)
      for (int c = 0; c < sub; ++c) {
        wgmm::mbar_wait(empty0 + 8 * s, ph ^ 1);
        wgmm::mbar_expect_tx(full0 + 8 * s, A_BYTES);
        wgmm::tma_load_4d(ring + s * A_BYTES, &key_map, full0 + 8 * s, dd * g.R2T + c * BK, t0,
                          4 * o, step);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    return;
  }

  const int lt = tid - 128, warp = lt / 32, lane = lt % 32;
  int d[4 * NB];  // [64 columns x 8*NB (k, gate)]
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) d[i] = 0;
  wgmm::mbar_wait(dig_bar, 0);
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int dd = d_lo; dd < d_hi; ++dd)
    for (int c = 0; c < sub; ++c) {
      wgmm::mbar_wait(full0 + 8 * s, ph);
      const uint64_t da = wgmm::smem_desc(ring + s * A_BYTES);
      const uint64_t db = wgmm::smem_desc(digits + (c * jjs + dd - d_lo) * TILE_B);
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
      atomicAdd(sum + ((long long)b * 2 + o) * g.N + k * T + t0 + t, comb);
    }
  }
}

// The arguments of a step loop: steps 0 .. n-1 over the key's first n
// steps (key_steps in all), amounts as in rot_diff_decompose_kernel, dig
// int8 scratch [B, K], sums int32 scratch [2, B, 2, N] (the split GEMM's).
// Step i reads the accumulator in bufs[i%2]; the result ends in
// bufs[n%2].
struct Loop {
  int* bufs[2];
  int8_t* dig;
  int* sums;
  const void* keyT;
  int key_steps;
  const int* amt;
  int a_stride, pair, B, n, N, d_used, log_bg, shift, Q;
  cudaStream_t st;
};

constexpr int SPLIT_GROUPS = 8;  // diagonal groups of the split GEMM, at most

Shape shape_of(const Loop& L, int NB, int MW) {
  const int nt = L.N / T, R2T = 4 * L.d_used * T;
  Shape g{L.B, L.N, L.Q, (2 * nt - 1) * R2T, R2T, nt * R2T / wgmm::BK, (L.B + NB - 1) / NB,
          2 * (T / CHUNK) / MW, 0};
  g.tiles = g.gate_tiles * nt * g.col_tiles;
  return g;
}

// The key as [steps, 8 planes, T, row_bytes], boxes of 4 planes x 16
// coefficients x 128 bytes; the digits as [B, K] with boxes of NB gates x
// 128 bytes, or for the split GEMM as [SUB substages, nt chunks j, B,
// 128 bytes] (strides 128, 2RT, K) with boxes of dpg+7 chunks x NB gates.
bool make_maps(const Loop& L, const Shape& g, int NB, int dpg, CUtensorMap* dig_map,
               CUtensorMap* key_map) {
  const long long K = (long long)g.chunks * wgmm::BK, BK = wgmm::BK;
  const long long kdims[4] = {g.row_bytes, T, 8, L.key_steps};
  const long long kstrides[3] = {g.row_bytes, (long long)T * g.row_bytes, 8LL * T * g.row_bytes};
  const int kbox[4] = {wgmm::BK, CHUNK, 4, 1};
  const long long sdims[4] = {BK, L.B, L.N / T, g.R2T / BK};
  const long long sstrides[3] = {K, g.R2T, BK};
  const int sbox[4] = {wgmm::BK, NB, dpg + 7, 1};
  return wgmm::make_map_nd(key_map, L.keyT, 4, kdims, kstrides, kbox) &&
         (dpg ? wgmm::make_map_nd(dig_map, L.dig, 4, sdims, sstrides, sbox)
              : wgmm::make_map(dig_map, L.dig, L.B, K, NB));
}

cudaError_t digits(const Loop& L, int i, const int* acc, const int* sum_in, int* acc_new,
                   int* sum_zero) {
  return launch(rot_diff_decompose_kernel, blocks_for((long long)L.B * 2 * L.N / 4), 256, 0, L.st,
                acc, sum_in, acc_new, sum_zero, L.amt, L.a_stride, i, L.pair, L.dig, L.B, L.N,
                L.d_used, L.log_bg, L.shift, L.Q);
}

// The tiled GEMM: step i reads bufs[i%2], writes bufs[(i+1)%2].
template <int NB, int MW>
int run_tiled(const Loop& L) {
  using C = Cfg<NB, MW>;
  const Shape g = shape_of(L, NB, MW);
  CUtensorMap dig_map, key_map;
  if (!make_maps(L, g, NB, 0, &dig_map, &key_map)) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t e = allow_smem((const void*)rot_gemm_kernel<NB, MW>, smem_set);
  const int grid = std::min(g.tiles, sm_count());
  for (int i = 0; i < L.n && e == cudaSuccess; ++i) {
    e = digits(L, i, L.bufs[i & 1], nullptr, nullptr, nullptr);
    if (e == cudaSuccess)
      e = launch(rot_gemm_kernel<NB, MW>, grid, C::THREADS, C::SMEM, L.st, dig_map, key_map,
                 (const int*)L.bufs[i & 1], L.bufs[(i + 1) & 1], g, i);
  }
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}

// Shared memory of the split GEMM: the digit chunks, 8 stages of key
// tiles, their barriers, the epilogue's staging buffer.
int split_smem(int NB, int N, int d_used, int dpg) {
  const int sub = 4 * d_used * T / wgmm::BK;
  return 1024 + sub * (dpg + 7) * NB * wgmm::BK + 8 * (COLS * wgmm::BK + 16) + 8 + COLS * (NB + 1) * 4;
}

// The split GEMM: step i adds its products into sums[i%2], which the
// digits kernel of step i zeroes first; the digits kernel of step i >= 1
// finalizes a_i = red31(a_{i-1} + sums[(i-1)%2]) from bufs[(i-1)%2] into
// bufs[i%2], and rot_finalize_kernel the last step's into bufs[n%2].
template <int NB>
int run_split(const Loop& L, int dpg) {
  const Shape g = shape_of(L, NB, 1);
  const int groups = (2 * (L.N / T) - 1 + dpg - 1) / dpg;
  const long long plane = (long long)L.B * 2 * L.N;
  CUtensorMap dig_map, key_map;
  if (!make_maps(L, g, NB, dpg, &dig_map, &key_map)) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t e = allow_smem((const void*)rot_gemm_split_kernel<NB>, smem_set);
  const int smem = split_smem(NB, L.N, L.d_used, dpg);
  for (int i = 0; i < L.n && e == cudaSuccess; ++i) {
    int* sum = L.sums + (i & 1) * plane;
    e = i == 0 ? digits(L, i, L.bufs[0], nullptr, nullptr, sum)
               : digits(L, i, L.bufs[(i - 1) & 1], L.sums + ((i - 1) & 1) * plane, L.bufs[i & 1], sum);
    if (e == cudaSuccess)
      e = launch(rot_gemm_split_kernel<NB>, 2 * (T / CHUNK) * groups, 256, smem, L.st, dig_map,
                 key_map, sum, g, i, dpg);
  }
  if (e == cudaSuccess)
    e = launch(rot_finalize_kernel, blocks_for(plane / 4), 256, 0, L.st,
               (const int*)L.bufs[(L.n - 1) & 1], (const int*)(L.sums + ((L.n - 1) & 1) * plane),
               L.bufs[L.n & 1], plane, L.Q);
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}

// The GEMM for B gates (rot.py: gemm_config): up to 16 gates the split
// GEMM where its shared memory holds the digits it needs (nt <= 8), else
// the narrowest NB >= B, two math warpgroups on one 256-gate digit tile
// above 256 gates.
int dispatch(const Loop& L) {
  if (L.d_used > MAX_DIGITS || L.n < 1) return (int)cudaErrorInvalidValue;
  const int nt = L.N / T, NB = L.B <= 8 ? 8 : 16;
  const int dpg = (2 * nt - 1 + SPLIT_GROUPS - 1) / SPLIT_GROUPS;
  if (L.B <= 16 && nt <= 8 && split_smem(NB, L.N, L.d_used, dpg) <= SMEM_MAX)
    return NB == 8 ? run_split<8>(L, dpg) : run_split<16>(L, dpg);
  if (L.B <= 32) return run_tiled<32, 1>(L);
  if (L.B <= 64) return run_tiled<64, 1>(L);
  if (L.B <= 128) return run_tiled<128, 1>(L);
  if (L.B <= 256) return run_tiled<256, 1>(L);
  return run_tiled<256, 2>(L);
}

}  // namespace rotg
}  // namespace

// The whole rotation: n steps of (digits, GEMM).  acc0 holds the initial
// accumulator; the result is in buffer n%2 of (acc0, acc1).  dig is int8
// scratch [B, K], sums int32 scratch [2, B, 2, N] (used up to 16 gates);
// keyT the K-major rev2 key [n, 8T, (2nt-1)*2RT].  Returns 0 or the first
// cudaError_t of a launch.
extern "C" int oece_blind_rotate_rot(void* acc0, void* acc1, void* dig, void* sums,
                                     const void* keyT, const void* a2N, int B,
                                     int n, int N, int d_used, int log_bg,
                                     int shift, int Q, void* stream) {
  const rotg::Loop L{{(int*)acc0, (int*)acc1}, (int8_t*)dig, (int*)sums, keyT, n,
                     (const int*)a2N, n, 0, B, n, N, d_used, log_bg, shift, Q,
                     (cudaStream_t)stream};
  return rotg::dispatch(L);
}

// One step for any amount pair amt int32 [B, 2] in [0, 2N) (#11): acc
// int32 [B, 2, N] -> out, which must not overlap acc (blocks of the GEMM
// read the old accumulator while others write the new one).  keyT_i is
// the step's K-major block [8T, (2nt-1)*2RT]; dig and sums as above.
extern "C" int oece_rot_step(const void* acc, void* out, void* dig, void* sums,
                             const void* keyT_i, const void* amt, int B,
                             int N, int d_used, int log_bg, int shift, int Q,
                             void* stream) {
  const rotg::Loop L{{(int*)acc, (int*)out}, (int8_t*)dig, (int*)sums, keyT_i, 1,
                     (const int*)amt, 0, 1, B, 1, N, d_used, log_bg, shift, Q,
                     (cudaStream_t)stream};
  return rotg::dispatch(L);
}

extern "C" const char* oece_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
