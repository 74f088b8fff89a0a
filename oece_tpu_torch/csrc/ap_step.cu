// Binary-base AP blind rotation (B_r = 2) for Hopper (sm_90a).
//
// Replaces the TPU kernel oece_tpu/fhe/pallas_kernels.py::_ap_megakernel
// (launched by blind_rotate_ap_megakernel, #13; phases _build_rev_body,
// _decompose_body, _matmul_body and the bit select).  Step s = i*d_r + j,
// for gate b, with neg_a = (2N - a2N[b, i]) mod 2N:
//
//   acc <- bit ? acc ⊡ K_s : acc,    bit = (neg_a >> j) & 1
//
// where ⊡ is the external product: gadget digits of acc, one int8
// contraction per 128-coefficient output tile k against the step's
// reversed diagonals rev[d'*RT + r*T + u, m*T + t] = ap_ext[s, r, m,
// ((nt-1-d')*T + t - u) mod 2N] (contraction rows (nt-1-k)*RT + x), then
// the Horner combine of the 4 key limbs mod Q.  The product replaces acc:
// no sum, no red31.
//
// The select bits are public (the ciphertext's a), so the rotation skips
// what they leave unchanged.  Once per rotation ap_live_kernel writes, for
// every step, a bit mask of its live gates and the rank of each 32-gate
// word's first live gate (a prefix sum), and the step's count of live
// gates, which the wrapper copies to the host in one transfer.  The step
// loop then launches nothing for a step without a live gate (every step
// j = 0 at STD128_OPT, where the q -> 2N mod switch makes each a2N even:
// 502 of 5,522) and, for a live step, two kernels over its L live gates
// only, in compact rows (row = rank):
//
//   ap_digits_kernel  for every gate: a gate live at the previous live
//       step takes its product, red31(res[rank]), into acc (in place:
//       the GEMMs read only digits); a gate live at this step writes its
//       gadget digits to row rank of dig [L, K] (K = nt*RT, RT = R*T,
//       R = 2*d_used), and for the split GEMM zeroes its row of the sum.
//       After the last live step it runs once more with no step, which
//       only finalizes.
//   the step GEMM    64 key columns (the 4 limbs of 16 coefficients of one
//       output poly) on wgmma's M and the live gates on its N, as
//       rot_step.cu's two GEMMs, with the digits fed by TMA; the host loop
//       picks each live step's instance by L (step_gemm.cuh: gemm_tile,
//       rot.py's gemm_config, and with_tile):
//     ap_split_kernel<NB>  (L <= 16, NB = 8 or 16) a block owns one column
//       chunk and a group of dpg diagonals; one m64n(8NB)k32 per 32 bytes
//       serves all 8 output tiles against digit tiles kept in shared
//       memory as [substage r][chunk j][gate] (chunks outside [0, nt) read
//       as zeros); limb-combined partial sums meet by atomics in the
//       zeroed sum [16, 2, N] (< 8Q: the combine is linear mod Q), which
//       the next digits kernel reduces with red31.
//     ap_gemm_kernel<NB, MW>  (L > 16, NB = 32, 48, .. 256 fitted to L,
//       two math warpgroups above 256 live gates) persistent blocks walk
//       tiles of (NB live gates, output tile k, MW column chunks); the
//       Horner combine is fused in the epilogue, which stores res [L, 2,
//       N].
//
// The key tiles are made on chip from the step's compact key (64 KB at
// STD128_OPT), so no block is written to global memory and nothing is
// launched to build one.  Row (l, t) of a 64 x 128-byte A tile at
// diagonal d' and digit row r is the 128 bytes ap_ext[s, r, 4o + l,
// (base + t - u) mod 2N], u = 0 .. 127, base = (nt-1-d')*T: a reversed
// window at an arbitrary byte, so it cannot be a TMA box (box starts must
// be 16-byte aligned; #5 paid for 32 shifted copies of the key for that).
// A tile's 16 rows of one limb plane read 160 bytes of it from base + t0
// - 128, 16-byte aligned (t0 % 16 == 0), so no 16-byte chunk wraps mod 2N:
// that span is staged in shared memory by 16-byte loads, all of a tile
// set's in flight at once.  Then each thread makes 16 bytes of a row: the
// 5 span words that hold them, two funnel shifts per output word put them
// in place, one byte permute reverses each word, and one 16-byte store
// lands them in the 128-byte swizzle that wgmm::smem_desc describes
// (chunk q of row rho at q ^ (rho % 8)); fence.proxy.async then hands the
// tile to wgmma.  (Made straight from the key through L1, 5 4-byte loads
// per chunk, one chunk at a time, the tiled GEMM took 132 us per B=2048
// step instead of 100.)  A from registers would skip the
// tile's store and load, but every A tile here feeds one wgmma per k32
// slice and rot_step.cu's register fragments are not laid out for it;
// the shared tile keeps one descriptor path for both GEMMs.  The card
// keeps the CPU's layout of ap_ext ([n*d_r, R, 8, 2N] int8): the wrap and
// the reversal cost a mask and a byte permute, and a padded layout would
// add 128 bytes per plane (22.6 MB at STD128_OPT).  The split GEMM makes
// its tiles before griddepcontrol.wait, so their making overlaps the
// digits kernel; the tiled GEMM's loader warpgroup makes each stage's
// tiles into a ring slot from spans double-buffered one stage ahead,
// while thread 0's TMA brings the stage's digit tile.  The machinery
// (tile shapes, the ring, descriptors, the limb combine, the launch with
// programmatic dependent launch) is rot_step.cu's, from step_gemm.cuh and
// wgmma_mm.cuh.
//
// Bounds on the H100.  A live gate costs nt * K * 8T = 33.6 M int8 MACs
// per step at STD128_OPT (K = 4096); |sum| <= K * 128 * 128 = 2**26,
// exact in int32.  A step reads its 64 KB key and the accumulators of its
// live gates: at 4 lanes the bound is the bytes, 0.05 us, far below a
// launch; at 2048 lanes with about half of them live, 34 G MAC, 0.035 ms
// at the int8 peak (operations bound).
//
// Measured (chip_smoke.py ap-sweep, NVIDIA H100 80GB HBM3, 700.00 W, a
// rotation of 88 steps with mod-switch amounts, per step of the 88; the
// block-building design before this one, then this one, in turns in one
// call): B=1 37.2 -> 3.7-5.0 us, B=4 58.5 -> 9.1-9.6 us, B=16 66.9 ->
// 9.2-11.6 us, B=256 81.1 -> 31.1-32.0 us, B=2048 528.2 -> 112.5-114.4 us
// (bound 31.5 us, operations).  At B=2048 a step is the digits kernel
// (10.7 us, about the bytes of the accumulators it reads and writes) and
// the tiled GEMM (99.6 us, 35% of the int8 peak on the live gates; 72.8 us
// with the tile making left out); at B=4 the digits (1.8-2.0 us), the
// split GEMM (3.6-4.6 us) and 3.9-5.1 us in which no kernel runs: the
// host's two launches per live step take longer than the card's work.
//
// Tried and left out: one cooperative kernel per rotation of up to 16
// gates, its blocks resident and walking the live steps with a grid
// barrier per step (each block making the digit tiles it needs itself).
// It launched nothing per step, but each live step waited on a grid
// barrier, and the middle diagonal groups' blocks each recomputed the
// digits of 8 chunks: 7.72 us per step at B=4, 18.2 at B=16 and 3.84 s
// per AP adder, against 6.68, 11.5 and 2.71 s for this step loop
// (chip_smoke.py ap-sweep and ap-circuit, two calls minutes apart,
// NVIDIA H100 80GB HBM3, 700.00 W).  A CUDA graph of the live steps,
// captured and instantiated per rotation, cost more than the launches it
// replaced: 5.22 s per AP adder against 2.48 s (same tools and card).

#include <algorithm>

#include "int8_mm.cuh"
#include "step_gemm.cuh"
#include "wgmma_mm.cuh"

namespace {
namespace apg {

using rotg::CHUNK;
using rotg::COLS;
using rotg::Cfg;
using rotg::Shape;
using rotg::tile_coords;

constexpr int BK = wgmm::BK;
constexpr int A_TILE = COLS * BK;  // one 64 x 128-byte key tile
constexpr int SPLIT_MAX = 16;      // live gates of the split GEMM, at most

// The live-gate table of one step: bit b%32 of mask[w] says whether gate
// b (w = b/32) is live, rank0[w] counts the live gates before word w.
struct Live {
  const uint32_t* mask;
  const int* rank0;
  int W;  // words per step: ceil(B / 32)
  // The compact row of gate b at step s, -1 where it is dead.
  __device__ __forceinline__ int rank(int s, int b) const {
    const long long at = (long long)s * W + b / 32;
    const uint32_t m = mask[at], bit = 1u << (b & 31);
    return (m & bit) ? rank0[at] + __popc(m & (bit - 1)) : -1;
  }
};

// One block per step: the step's masks, word ranks and live count.
__global__ void __launch_bounds__(256) ap_live_kernel(const int* __restrict__ a2N,
                                                      uint32_t* __restrict__ mask,
                                                      int* __restrict__ rank0,
                                                      int* __restrict__ count, int B, int n,
                                                      int d_r, int two_n) {
  __shared__ int word_count[8];
  const int s = blockIdx.x, i = s / d_r, j = s % d_r, W = (B + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int carry = 0;
  for (int base = 0; base < B; base += 256) {
    const int b = base + threadIdx.x;
    bool live = false;
    if (b < B) {
      const int neg_a = (two_n - a2N[(long long)b * n + i]) & (two_n - 1);
      live = (neg_a >> j) & 1;
    }
    const uint32_t m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) word_count[warp] = __popc(m);
    __syncthreads();
    const int w = base / 32 + warp;
    if (lane == 0 && w < W) {
      int pre = carry;
      for (int q = 0; q < warp; ++q) pre += word_count[q];
      mask[(long long)s * W + w] = m;
      rank0[(long long)s * W + w] = pre;
    }
    for (int q = 0; q < 8; ++q) carry += word_count[q];
    __syncthreads();
  }
  if (threadIdx.x == 0) count[s] = carry;
}

// One thread per (gate b, poly pp, coefficients m0 .. m0+3) of all B
// gates.  prev >= 0: a gate live at step prev takes red31(res[rank]) into
// acc.  s >= 0: a gate live at step s writes its digits at row rank of
// dig, int8 [L, K] at column j'*RT + (pp*d_used + g)*T + u for
// coefficient j'*T + u, and zeroes its row of `zero` if given.
__global__ void ap_digits_kernel(int* __restrict__ acc, const int* __restrict__ res, int prev,
                                 int* __restrict__ zero, int s, Live lv, int8_t* __restrict__ dig,
                                 int B, int N, int d_used, int log_bg, int shift, int Q) {
  pdl_wait_and_release();
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int quads = N / 4;
  if (gid >= (long long)B * 2 * quads) return;
  const int m0 = (int)(gid % quads) * 4;
  const int pp = (int)((gid / quads) & 1);
  const int b = (int)(gid / (2 * quads));
  int* at = acc + ((long long)b * 2 + pp) * N + m0;
  int4 x;
  const int rp = prev >= 0 ? lv.rank(prev, b) : -1;
  if (rp >= 0) {
    x = *(const int4*)(res + ((long long)rp * 2 + pp) * N + m0);
    x = make_int4(red31(x.x, Q), red31(x.y, Q), red31(x.z, Q), red31(x.w, Q));
    *(int4*)at = x;
  }
  const int rs = s >= 0 ? lv.rank(s, b) : -1;
  if (rs < 0) return;
  if (rp < 0) x = *(const int4*)at;
  if (zero) *(int4*)(zero + ((long long)rs * 2 + pp) * N + m0) = make_int4(0, 0, 0, 0);
  const int RT = 2 * d_used * T;
  uint32_t w[MAX_DIGITS] = {0, 0, 0, 0};
  pack_digits(x.x, w, 0, d_used, log_bg, shift, Q);
  pack_digits(x.y, w, 1, d_used, log_bg, shift, Q);
  pack_digits(x.z, w, 2, d_used, log_bg, shift, Q);
  pack_digits(x.w, w, 3, d_used, log_bg, shift, Q);
  int8_t* drow = dig + (long long)rs * (N / T) * RT + (m0 / T) * RT + pp * d_used * T + (m0 % T);
#pragma unroll
  for (int g = 0; g < MAX_DIGITS; ++g)
    if (g < d_used) *(uint32_t*)(drow + g * T) = w[g];
}

// A key tile (column chunk cc = (o, t0), diagonal d', digit row r) reads,
// from each limb plane 4o + l of ap_ext[s, r], the SPAN bytes from
// (nt-1-d')*T + t0 - 128 (mod 2N; 16-byte aligned, so no 16-byte chunk
// wraps): its span, staged in shared memory as [limb][SPAN] by 16-byte
// loads.  span_chunk loads chunk c (0 .. SPAN/16 - 1) of limb l's.
constexpr int SPAN = 160;
constexpr int TILE_SPAN = 4 * SPAN;
constexpr int SPAN_LOADS = TILE_SPAN / 16;  // 16-byte loads per tile

__device__ __forceinline__ int4 span_chunk(const int8_t* __restrict__ ext_s, int cc, int dp, int r,
                                           int e, int N) {
  const int limb = e / (SPAN / 16), c = e % (SPAN / 16);
  const int o = cc / (T / CHUNK), t0 = cc % (T / CHUNK) * CHUNK;
  const int at = ((N / T - 1 - dp) * T + t0 - 128 + 16 * c) & (2 * N - 1);
  return __ldg((const int4*)(ext_s + ((long long)r * 8 + 4 * o + limb) * 2 * N + at));
}

// Chunk e (0 .. 511) of a key tile from its span, into `tile` (1024-byte
// aligned).  Row rho = 16*limb + tt holds coefficient t0 + tt of limb
// plane 4o + limb; its byte u is plane[(nt-1-d')*T + t0 + tt - u] = span
// byte 128 + tt - u.  Chunk q (u = 16q .. 16q+15) is the 16 ascending
// span bytes from a = 113 + tt - 16q, reversed: the 5 words that hold
// them, two funnel shifts per word, one byte permute each.  It lands at
// rho*128 + (q ^ rho%8)*16, the 128-byte swizzle.
__device__ __forceinline__ void make_chunk(uint8_t* tile, const uint8_t* span, int e) {
  const int rho = e >> 3, q = e & 7, limb = rho / CHUNK;
  const int a = 113 + rho % CHUNK - 16 * q, sh = (a & 3) * 8;
  const uint32_t* src = (const uint32_t*)(span + limb * SPAN) + (a >> 2);
  uint32_t w[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = src[i];
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __funnelshift_r(w[i], w[i + 1], sh);
  *(int4*)(tile + rho * BK + ((q ^ (rho & 7)) << 4)) =
      make_int4((int)__byte_perm(v[3], 0, 0x0123), (int)__byte_perm(v[2], 0, 0x0123),
                (int)__byte_perm(v[1], 0, 0x0123), (int)__byte_perm(v[0], 0, 0x0123));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The split GEMM of one step (L <= NB <= 16): block (column chunk cc,
// diagonal group grp) keeps in shared memory its dpg*R key tiles (d', r)
// at tile (d' - d_lo)*R + r, the digit chunks j = d_lo - nt + 1 .. +dpg+6
// of every substage r as [r][jj][NB gates][128 bytes] (by TMA), a
// barrier, the tiles' spans [tile][limb][SPAN] and the epilogue's staging
// buffer.  Stage (d', r) runs against digit tile (r, d' - d_lo): all
// output tiles k at once, column k*NB + gate.  The key tiles do not
// depend on the previous kernel: they are made before griddepcontrol.wait.
// sum [16, 2, N] gets the combined partial sums.
template <int NB>
__global__ void __launch_bounds__(256, 1) ap_split_kernel(const __grid_constant__ CUtensorMap dig_map,
                                                          const int8_t* __restrict__ ext_s,
                                                          int* __restrict__ sum, int L, int N, int R,
                                                          int Q, int dpg) {
  constexpr int TILE_B = NB * BK, EPI_PITCH = NB + 1;
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x, nt = N / T, jjs = dpg + 7;
  const uint32_t raw = wgmm::smem_addr(smem_raw);
  const uint32_t tiles = (raw + 1023) & ~1023u;
  const uint32_t digits = tiles + dpg * R * A_TILE;
  const uint32_t dig_bar = digits + R * jjs * TILE_B;
  uint8_t* tiles_p = smem_raw + (tiles - raw);
  uint8_t* spans_p = smem_raw + (dig_bar + 16 - raw);
  int* cs = (int*)(spans_p + dpg * R * TILE_SPAN);
  const int cc = blockIdx.x % (2 * T / CHUNK), grp = blockIdx.x / (2 * T / CHUNK);
  const int o = cc / (T / CHUNK), t0 = cc % (T / CHUNK) * CHUNK;
  const int d_lo = grp * dpg, d_hi = min(d_lo + dpg, 2 * nt - 1);

  if (tid == 0) {
    wgmm::mbar_init(dig_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the key tiles: the spans by 16-byte loads, all in flight, then the tiles
  const int ntile = (d_hi - d_lo) * R, loads = ntile * SPAN_LOADS;
  for (int e0 = tid; e0 < loads; e0 += 4 * 256) {
    int4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * 256, tile = e / SPAN_LOADS;
      if (e < loads) v[k] = span_chunk(ext_s, cc, d_lo + tile / R, tile % R, e % SPAN_LOADS, N);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e0 + k * 256 < loads) *(int4*)(spans_p + (e0 + k * 256) * 16) = v[k];
  }
  __syncthreads();
  for (int e = tid; e < ntile * (A_TILE / 16); e += 256) {
    const int tile = e / (A_TILE / 16);
    make_chunk(tiles_p + tile * A_TILE, spans_p + tile * TILE_SPAN, e % (A_TILE / 16));
  }
  fence_proxy_async();
  __syncthreads();
  pdl_wait_and_release();  // the digits are complete from here

  if (tid < 128) {
    if (tid == 0) {
      wgmm::mbar_expect_tx(dig_bar, R * jjs * TILE_B);
      for (int c = 0; c < R; ++c)  // chunks j = d_lo - nt + 1 .. +jjs-1 of substage c
        wgmm::tma_load_4d(digits + c * jjs * TILE_B, &dig_map, dig_bar, 0, 0, d_lo - nt + 1, c);
    }
    return;
  }

  const int lt = tid - 128, warp = lt / 32, lane = lt % 32;
  int d[4 * NB];  // [64 columns x 8*NB (k, gate)]
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) d[i] = 0;
  wgmm::mbar_wait(dig_bar, 0);
  wgmm::fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  for (int dd = d_lo; dd < d_hi; ++dd)
    for (int c = 0; c < R; ++c) {
      const uint64_t da = wgmm::smem_desc(tiles + ((dd - d_lo) * R + c) * A_TILE);
      const uint64_t db = wgmm::smem_desc(digits + (c * jjs + dd - d_lo) * TILE_B);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmm::wgmma_s8<8 * NB>(d, da + 2 * kk, db + 2 * kk, 1);
    }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  wgmm::fence_acc(d);
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  wgmm::fence_acc(d);

  // accumulator i: key column 16*warp + lane/4 (+8 for i & 2), column
  // 8*(i/4) + 2*(lane%4) + (i & 1) = k*NB + gate, so k = i / (NB/2)
  const int t = lt % CHUNK;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= nt) break;
    rotg::wg_sync(0);  // the previous k has read cs
#pragma unroll
    for (int i = 0; i < 4 * NB; ++i) {
      if (i / (NB / 2) != k) continue;
      cs[(16 * warp + lane / 4 + 8 * ((i >> 1) & 1)) * EPI_PITCH + 8 * (i / 4) + 2 * (lane % 4) +
         (i & 1) - k * NB] = d[i];
    }
    rotg::wg_sync(0);
#pragma unroll
    for (int it = 0; it < NB / 8; ++it) {
      const int b = lt / CHUNK + 8 * it;
      if (b >= L) continue;
      atomicAdd(sum + ((long long)b * 2 + o) * N + k * T + t0 + t,
                rotg::combine_staged(cs, EPI_PITCH, t, b, Q));
    }
  }
}

// The tiled GEMM (L > 16): res[i, o, k*T + t] for live gate row i.  The
// 128 threads of warpgroup 0 make the MW key tiles of each stage into the
// ring (stage c of output tile k: diagonal nt-1-k + c/R, digit row c%R)
// and arrive on its full barrier; thread 0 adds the stage's digit tile
// by TMA.
template <int NB, int MW>
using GemmCfg = Cfg<NB, MW, 2 * MW * TILE_SPAN>;  // two stages' spans beside the ring

template <int NB, int MW>
__global__ void __launch_bounds__(GemmCfg<NB, MW>::THREADS, 1) ap_gemm_kernel(
    const __grid_constant__ CUtensorMap dig_map, const int8_t* __restrict__ ext_s,
    int* __restrict__ res, Shape g) {
  using C = GemmCfg<NB, MW>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wgmm::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t full0 = ring + C::STAGES * C::STAGE, empty0 = full0 + C::STAGES * 8;
  int* epi = (int*)(smem_raw + (ring - raw) + C::STAGES * (C::STAGE + 16));
  const int tid = threadIdx.x;
  const int nt = g.N / T, R = g.R2T / T;  // R2T: RT, the contraction bytes per diagonal

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      wgmm::mbar_init(full0 + 8 * s, 128);
      wgmm::mbar_init(empty0 + 8 * s, MW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  pdl_wait_and_release();  // the digits are complete from here

  if (tid < 128) {  // the loader: key tiles by all 128 threads, digits by TMA
    // spans of stage n in spans[n % 2]: each thread loads its chunk of the
    // next stage's spans before it makes this stage's tiles
    uint8_t* spans = (uint8_t*)(epi + MW * COLS * C::EPI_PITCH);
    const auto span_load = [&](int tile, int c) {
      int4 v = make_int4(0, 0, 0, 0);
      if (tile < g.tiles && tid < MW * SPAN_LOADS) {
        int gt, k, ct;
        tile_coords(g, tile, gt, k, ct);
        v = span_chunk(ext_s, ct * MW + tid / SPAN_LOADS, nt - 1 - k + c / R, c % R,
                       tid % SPAN_LOADS, g.N);
      }
      return v;
    };
    int s = 0, n = 0;
    uint32_t ph = 0;
    if (tid < MW * SPAN_LOADS) *(int4*)(spans + tid * 16) = span_load(blockIdx.x, 0);
    asm volatile("bar.sync 3, 128;" ::: "memory");
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      int gt, k, ct;
      tile_coords(g, tile, gt, k, ct);
      for (int c = 0; c < g.chunks; ++c, ++n) {
        const int4 next = c + 1 < g.chunks ? span_load(tile, c + 1) : span_load(tile + gridDim.x, 0);
        const uint32_t a_s = ring + s * C::STAGE, full = full0 + 8 * s;
        wgmm::mbar_wait(empty0 + 8 * s, ph ^ 1);
        uint8_t* a_p = smem_raw + (a_s - raw);
        const uint8_t* sp = spans + (n & 1) * MW * TILE_SPAN;
        for (int w = 0; w < MW; ++w)
#pragma unroll
          for (int e = tid; e < A_TILE / 16; e += 128) make_chunk(a_p + w * A_TILE, sp + w * TILE_SPAN, e);
        fence_proxy_async();
        if (tid == 0) {
          wgmm::mbar_expect_tx(full, NB * BK);
          wgmm::tma_load(a_s + C::A_BYTES, &dig_map, full, c * BK, gt * NB);
        } else {
          wgmm::mbar_arrive(full);
        }
        if (tid < MW * SPAN_LOADS) *(int4*)(spans + ((n + 1) & 1) * MW * TILE_SPAN + tid * 16) = next;
        asm volatile("bar.sync 3, 128;" ::: "memory");  // stage n+1's spans are in place
        if (++s == C::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // the math: warpgroup wg takes key columns (ct*MW + wg) of each tile
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
    int prev = 0;
    for (int c = 0; c < g.chunks; ++c) {
      const uint32_t a_s = ring + s * C::STAGE, b_s = a_s + C::A_BYTES;
      wgmm::mbar_wait(full0 + 8 * s, ph);
      const uint64_t da = wgmm::smem_desc(a_s + wg * A_TILE), db = wgmm::smem_desc(b_s);
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
    const long long at0 = (long long)o * g.N + k * T + t0 + lt % CHUNK;
#pragma unroll
    for (int q = 0; q < C::EPI_PASSES; ++q) {
      rotg::wg_sync(wg);  // the previous pass has read cs
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) {  // this pass's gates: i / (EPI_G/2) == q
        if (i / (C::EPI_G / 2) != q) continue;
        const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1) - q * C::EPI_G;
        cs[row * C::EPI_PITCH + col] = d[i];
      }
      rotg::wg_sync(wg);
#pragma unroll
      for (int it = 0; it < C::EPI_G / 8; ++it) {  // one (gate, coefficient t) each
        if (q * C::EPI_G + 8 * it >= NB) break;     // the last pass's NB % 64 gates
        const int gg = lt / CHUNK + 8 * it, b = gt * NB + q * C::EPI_G + gg;
        if (b >= g.B) continue;
        res[(long long)b * 2 * g.N + at0] = rotg::combine_staged(cs, C::EPI_PITCH, lt % CHUNK, gg, g.Q);
      }
    }
  }
}

// Shared memory of the split GEMM (ap_split_kernel's layout).
inline int split_smem(int NB, int R, int dpg) {
  return 1024 + dpg * R * A_TILE + R * (dpg + 7) * NB * BK + 16 + dpg * R * TILE_SPAN +
         COLS * (NB + 1) * 4;
}

// The rotation's arguments (oece_blind_rotate_ap) and the digit maps,
// made at first use for each gate tile NB, at slot NB / 8.
constexpr int MAP_SLOTS = 256 / 8 + 1;

struct Rotation {
  int* acc;
  int* res;   // [L_max, 2, N]: the tiled GEMM's products
  int* sums;  // [2, 16, 2, N]: the split GEMM's, by live-step parity
  int8_t* dig;
  const int8_t* ap_ext;
  Live lv;
  int B, L_max, N, R, d_used, log_bg, shift, Q, dpg;
  cudaStream_t st;
  CUtensorMap maps[MAP_SLOTS];  // split NB = 8, 16; tiled NB = 32, 48, .. 256
  bool made[MAP_SLOTS] = {};
};

// The digit map of gate tile NB: for the split GEMM (NB <= 16) [R
// substages, nt chunks j, L_max, 128 bytes] (strides 128, RT, K) with
// boxes of dpg+7 chunks x NB rows, for the tiled GEMM [L_max, K] with
// boxes of NB rows.
const CUtensorMap* digit_map(Rotation& A, int NB) {
  const int slot = NB / 8;
  if (!A.made[slot]) {
    const long long RT = (long long)A.R * T, K = A.N / T * RT;
    bool ok;
    if (NB <= 16) {
      const long long dims[4] = {BK, A.L_max, A.N / T, A.R}, strides[3] = {K, RT, BK};
      const int box[4] = {BK, NB, A.dpg + 7, 1};
      ok = wgmm::make_map_nd(&A.maps[slot], A.dig, 4, dims, strides, box);
    } else {
      ok = wgmm::make_map(&A.maps[slot], A.dig, A.L_max, K, NB);
    }
    if (!ok) return nullptr;
    A.made[slot] = true;
  }
  return &A.maps[slot];
}

cudaError_t digits(const Rotation& A, const int* res, int prev, int* zero, int s) {
  return rotg::launch(ap_digits_kernel, blocks_for((long long)A.B * 2 * A.N / 4), 256, 0, A.st, A.acc,
                      res, prev, zero, s, A.lv, A.dig, A.B, A.N, A.d_used, A.log_bg, A.shift, A.Q);
}

template <int NB>
cudaError_t run_split(Rotation& A, const int8_t* ext_s, int* sum, int L) {
  static bool smem_set = false;
  cudaError_t e = rotg::allow_smem((const void*)ap_split_kernel<NB>, smem_set);
  const CUtensorMap* map = digit_map(A, NB);
  if (e != cudaSuccess) return e;
  if (map == nullptr) return cudaErrorInvalidValue;
  const int groups = (2 * (A.N / T) - 1 + A.dpg - 1) / A.dpg;
  return rotg::launch(ap_split_kernel<NB>, 2 * (T / CHUNK) * groups, 256, split_smem(NB, A.R, A.dpg),
                      A.st, *map, ext_s, sum, L, A.N, A.R, A.Q, A.dpg);
}

template <int NB, int MW>
cudaError_t run_tiled(Rotation& A, const int8_t* ext_s, int L) {
  using C = GemmCfg<NB, MW>;
  static bool smem_set = false;
  cudaError_t e = rotg::allow_smem((const void*)ap_gemm_kernel<NB, MW>, smem_set);
  const CUtensorMap* map = digit_map(A, NB);
  if (e != cudaSuccess) return e;
  if (map == nullptr) return cudaErrorInvalidValue;
  const int nt = A.N / T;
  Shape g{L, A.N, A.Q, 0, A.R * T, nt * A.R, (L + NB - 1) / NB, 2 * (T / CHUNK) / MW, 0};
  g.tiles = g.gate_tiles * nt * g.col_tiles;
  return rotg::launch(ap_gemm_kernel<NB, MW>, std::min(g.tiles, rotg::sm_count()), C::THREADS,
                      C::SMEM, A.st, *map, ext_s, A.res, g);
}

}  // namespace apg
}  // namespace

// The live-gate table of a rotation: mask uint32 [S, W], rank0 int32
// [S, W] (W = ceil(B/32)) and count int32 [S], S = n*d_r, from a2N int32
// [B, n].  Returns 0 or a cudaError_t.
extern "C" int oece_ap_live_table(const void* a2N, void* mask, void* rank0, void* count, int B,
                                  int n, int d_r, int N, void* stream) {
  apg::ap_live_kernel<<<n * d_r, 256, 0, (cudaStream_t)stream>>>(
      (const int*)a2N, (uint32_t*)mask, (int*)rank0, (int*)count, B, n, d_r, 2 * N);
  return (int)cudaGetLastError();
}

// The rotation's step loop, in place on acc int32 [B, 2, N]: for each
// step s with count[s] > 0 (count: the table's counts, in host memory),
// the digits kernel and the GEMM of its count[s] live gates; then the
// last finalize.  res int32 [L_max, 2, N], sums int32 [2, 16, 2, N], dig
// int8 [L_max, K] scratch (L_max = the largest count), ap_ext int8
// [S, R, 8, 2N].  Returns 0 or the first cudaError_t of a launch.
extern "C" int oece_blind_rotate_ap(void* acc, void* res, void* sums, void* dig, const void* ap_ext,
                                    const void* mask, const void* rank0, const int* count, int B,
                                    int L_max, int steps, int N, int d_used, int log_bg, int shift,
                                    int Q, void* stream) {
  using namespace apg;
  if (d_used > MAX_DIGITS) return (int)cudaErrorInvalidValue;
  const int R = 2 * d_used, dpg = rotg::split_dpg(N, 2);
  // where the split GEMM of 8 and of 16 live gates fits (rotg::gemm_tile)
  const bool fits[2] = {rotg::split_fits(N, split_smem(8, R, dpg)),
                        rotg::split_fits(N, split_smem(16, R, dpg))};
  Rotation A{(int*)acc, (int*)res, (int*)sums, (int8_t*)dig, (const int8_t*)ap_ext,
             Live{(const uint32_t*)mask, (const int*)rank0, (B + 31) / 32},
             B, L_max, N, R, d_used, log_bg, shift, Q, dpg, (cudaStream_t)stream};
  const long long ext_step = (long long)R * 8 * 2 * N, sum_plane = (long long)SPLIT_MAX * 2 * N;
  const int* prev_res = nullptr;
  int prev = -1, live_steps = 0;
  cudaError_t e = cudaSuccess;
  for (int s = 0; s < steps && e == cudaSuccess; ++s) {
    const int L = count[s];
    if (L == 0) continue;
    const int8_t* ext_s = A.ap_ext + s * ext_step;
    const int NB = rotg::gemm_tile(L, fits);
    const bool split = NB <= 16;
    int* out = split ? A.sums + (live_steps & 1) * sum_plane : A.res;
    e = digits(A, prev_res, prev, split ? out : nullptr, s);
    if (e != cudaSuccess) break;
    e = (cudaError_t)rotg::with_tile(NB, L, fits[NB == 16], [&](auto t) {
      using Tl = decltype(t);
      if constexpr (Tl::SPLIT)
        return (int)run_split<Tl::NB>(A, ext_s, out, L);
      else
        return (int)run_tiled<Tl::NB, Tl::MW>(A, ext_s, L);
    });
    prev_res = out;
    prev = s;
    ++live_steps;
  }
  if (e == cudaSuccess && prev >= 0) e = digits(A, prev_res, prev, nullptr, -1);
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}
