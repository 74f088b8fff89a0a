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
// and a narrow batch pays for no padded rows.  The caller passes the gate
// tile NB, which rot.py's gemm_config chooses from B, and the loop runs
// that instance (step_gemm.cuh: with_tile):
//
//   rot_gemm_kernel<NB, MW>    (NB = 32, 48, .. 256) persistent blocks walk
//       tiles of (output tile k, MW column chunks, NB gates), B gates in
//       ceil(B/256) gate tiles of NB = 16*ceil(B / (16*tiles)) (144 gate
//       rows for 132 gates); above 256 gates two math warpgroups share
//       each digit tile, the shape of wgmma_mm.cuh's GEMM for #3.  The
//       digits are read from scratch whose rows run to the last gate
//       tile's end, zeros from B
//       on: where the TMA unit filled rows past the end of the map with
//       zeros itself, at ~3.4 ns a row and block, a 132-gate STD128 step's
//       GEMM took twice the 256-gate one's (PERF.md §5).  One thread of
//       warpgroup 0 issues the boxes into a ring of mbarrier stages; the math
//       warpgroups run wgmma.m64nNBk32.s32.s8.s8, 4 per stage, stage the
//       [64 columns x NB gates] sums through shared memory and write acc_out
//       = red31(acc_in + comb), the Horner combine of the 4 limbs mod Q,
//       while the loader fills the next tile's stages.  Each thread loads
//       its acc_in values before the tile's products, so their latency
//       hides behind the MMAs (waited for in the epilogue, they cost a
//       third of the step at B = 2048).
//   rot_gemm_split_kernel<NB>  (NB = 8 or 16) each key tile is read once per
//       step: a block owns a column chunk and 2 of the block's 15
//       diagonals, and one wgmma per 32 bytes serves all 8 output tiles
//       (below); the partial sums meet in an int32 sum by atomics, which
//       the next step's digits kernel (or rot_finalize_kernel) adds to the
//       accumulator.  The key is read-only for the whole rotation, so each
//       block issues its first 4 key stages before it waits for the
//       digits kernel: a GEMM's blocks become resident as soon as that
//       kernel starts, and the key stream no longer waits on it.  The
//       digits come from scratch of NB rows (zeros from B on); at NB = 8
//       each block loads only its digit chunks inside [0, nt) and zeroes
//       the others in shared memory (step_gemm.cuh: chunk_major).
//
// The accumulator ping-pongs between two buffers: no block reads what
// another block of the same step writes, and the digits of a step are
// complete before its GEMM starts, which is the ordering the TPU kernel
// gets from its sequential grid.  Every kernel is launched with
// programmatic dependent launch: it waits for its predecessor inside
// (griddepcontrol.wait), so its launch and prologue overlap the
// predecessor's tail.  The launch helper, the tile shapes (Cfg, Shape)
// and the limb combine are in step_gemm.cuh, shared with ap_step.cu, and
// so are both GEMMs' bodies (gemm_tiled, gemm_split), which rev_step.cu's
// kernels share.
//
// Bounds on the H100.  One step costs nt*K*8T = 67 M int8 MACs per gate at
// STD128_OPT (K = nt*2R*T = 8192) and streams a 15.7 MB key block that
// every gate of the batch shares: at 4-8 lanes 4.7 us of HBM (bytes
// bound); at STD128's exact gadget (d = 4, K = 16384) the block is 31.5 MB,
// 9.4 us.  The tiled GEMM's output tiles each read 8 of the block's 15
// diagonals (64 MB from L2 at STD128_OPT), the split GEMM's blocks read it
// once.  At B = 2048 a step is 137 G MAC, 0.139 ms at the int8 peak
// (operations bound).  The contraction is exact in int32: |sum| <= K * 128
// * 128 = 2**27.  Measured at STD128, B = 4 and 8 (PERF.md, section 6): a
// step ~17.5 us, 54% of its HBM floor: the digits kernel 4.1-4.7 us and
// the split GEMM 12.2-12.7 us, which takes 8.1-8.5 us even with its step's
// block already in L2.
//
// Left on the table: the digits fused into the split GEMM's producer, or a
// persistent step loop (the digits kernel and its two PDL hand-offs take
// a quarter of a narrow step); prefetching the split GEMM's remaining key
// stages into L2 (cp.async.bulk.prefetch) before its wait, or the next
// step's after its last load, measured no faster: the prefetch slows the
// digits kernel, or the GEMM's tail, by what it saves elsewhere; reusing
// key tiles across output tiles (tile k at chunk c reads what tile k+1
// reads at chunk c + 2RT/128; ~26 us of a one-warpgroup STD128 step's
// GEMM does not shrink with NB, PERF.md §6), thread-block clusters that
// multicast each stage's digit tile to blocks of one gate tile (with the
// padded scratch they paid only where two warpgroups stream a 4,096-gate
// step through several rounds, 687 against 825 us, ~1% of the
// multiplier; one warpgroup stalled on its peers' stages, 63 against 50
// us), fusing the digits into the GEMM (one
// launch per step), a CUDA graph of the step loop, keeping the
// accumulator resident across steps in a persistent kernel, overlapping
// the tiled GEMM's epilogue with the next tile's MMAs, and gathering the
// key tiles from the compact key instead of the 7.9 GB prebuilt one.

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
// acc_out = red31(acc_in + products), from the digits (dig_map, [rows, K])
// and the K-major key (key_map, [n, 8T, row_bytes]); step_gemm.cuh's
// gemm_tiled.
template <int NB, int MW>
__global__ void __launch_bounds__(Cfg<NB, MW>::THREADS, 1) rot_gemm_kernel(
    const __grid_constant__ CUtensorMap dig_map, const __grid_constant__ CUtensorMap key_map,
    const int* __restrict__ acc_in, int* __restrict__ acc_out, Shape g, int step) {
  gemm_tiled<NB, MW, true>(&dig_map, &key_map, acc_in, acc_out, g, step);
}

// The split GEMM of narrow batches (B <= NB <= 16), step_gemm.cuh's
// gemm_split: each block owns a column chunk and `dpg` diagonals, one
// wgmma per 32 bytes serves all 8 output tiles, and the limb-combined
// partial sums meet in sum [B, 2, N] (< 8Q) by atomics, which the next
// step's digits kernel, or rot_finalize_kernel, adds to the accumulator
// with red31.  So the 15.7 MB block is read from L2 about once per step
// (rot_gemm_kernel's tiles read 64 MB), over the 16 x 8 blocks.
template <int NB>
__global__ void __launch_bounds__(256, 1) rot_gemm_split_kernel(
    const __grid_constant__ CUtensorMap dig_map, const __grid_constant__ CUtensorMap key_map,
    int* __restrict__ sum, Shape g, int step, int dpg, int early) {
  gemm_split<NB>(&dig_map, &key_map, sum, g, step, dpg, early);
}

// The arguments of a step loop: steps 0 .. n-1 over the key's first n
// steps (key_steps in all), amounts as in rot_diff_decompose_kernel, dig
// int8 scratch [dig_rows, K] (dig_rows >= B; the digits kernel writes rows
// below B, the rest stay as they are: zeros, which the GEMMs' boxes read
// up to the last gate tile's end), sums int32 scratch [2, B, 2, N] (the
// split GEMM's).  `early`: no kernel writes the key during the call, so
// the split GEMM issues key tiles before it waits (gemm_split).  NB: the
// GEMM's gate tile (rot.py: gemm_config).  Step i reads the accumulator in
// bufs[i%2]; the result ends in bufs[n%2].
struct Loop {
  int* bufs[2];
  int8_t* dig;
  int dig_rows;
  int* sums;
  const void* keyT;
  int key_steps;
  const int* amt;
  int a_stride, pair, B, NB, n, N, d_used, log_bg, shift, Q, early;
  cudaStream_t st;
};

Shape shape_of(const Loop& L, int NB, int MW) {
  return step_shape(L.B, L.N, L.Q, 4 * L.d_used * T, 2, NB, MW);
}

bool maps_of(const Loop& L, const Shape& g, int NB, int dpg, CUtensorMap* dig_map,
             CUtensorMap* key_map) {
  return make_maps(L.keyT, L.key_steps, 8, L.dig, L.dig_rows, g, NB, dpg, dig_map, key_map);
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
  if (!maps_of(L, g, NB, 0, &dig_map, &key_map)) return (int)cudaErrorInvalidValue;
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
  if (!maps_of(L, g, NB, dpg, &dig_map, &key_map)) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t e = allow_smem((const void*)rot_gemm_split_kernel<NB>, smem_set);
  const int smem = split_smem(NB, 4 * L.d_used, dpg);
  for (int i = 0; i < L.n && e == cudaSuccess; ++i) {
    int* sum = L.sums + (i & 1) * plane;
    e = i == 0 ? digits(L, i, L.bufs[0], nullptr, nullptr, sum)
               : digits(L, i, L.bufs[(i - 1) & 1], L.sums + ((i - 1) & 1) * plane, L.bufs[i & 1], sum);
    if (e == cudaSuccess)
      e = launch(rot_gemm_split_kernel<NB>, 2 * (T / CHUNK) * groups, 256, smem, L.st, dig_map,
                 key_map, sum, g, i, dpg, L.early);
  }
  if (e == cudaSuccess)
    e = launch(rot_finalize_kernel, blocks_for(plane / 4), 256, 0, L.st,
               (const int*)L.bufs[(L.n - 1) & 1], (const int*)(L.sums + ((L.n - 1) & 1) * plane),
               L.bufs[L.n & 1], plane, L.Q);
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}

// The loop with the GEMM instance of the given gate tile L.NB.
int dispatch(const Loop& L) {
  if (L.d_used > MAX_DIGITS || L.n < 1 || L.dig_rows < L.B) return (int)cudaErrorInvalidValue;
  const int dpg = split_dpg(L.N, 2);
  return with_tile(L.NB, L.B, split_fits(L.N, split_smem(L.NB, 4 * L.d_used, dpg)), [&](auto t) {
    using Tl = decltype(t);
    if constexpr (Tl::SPLIT)
      return run_split<Tl::NB>(L, dpg);
    else
      return run_tiled<Tl::NB, Tl::MW>(L);
  });
}

}  // namespace rotg
}  // namespace

// The whole rotation: n steps of (digits, GEMM).  acc0 holds the initial
// accumulator; the result is in buffer n%2 of (acc0, acc1).  nb is the
// GEMM's gate tile (rot.py: gemm_config; 8 or 16 the split GEMM); dig is
// int8 scratch [dig_rows, K], its rows from B on zero, B rounded up to nb
// (rot.py: digit_scratch); sums int32 scratch [2, B, 2, N] (the split
// GEMM's); keyT the K-major rev2 key [n, 8T, (2nt-1)*2RT].  Returns 0 or
// the first cudaError_t of a launch (cudaErrorInvalidValue for a tile the
// loop has no instance of).
extern "C" int oece_blind_rotate_rot(void* acc0, void* acc1, void* dig, void* sums,
                                     const void* keyT, const void* a2N, int B, int nb,
                                     int dig_rows, int n, int N, int d_used, int log_bg,
                                     int shift, int Q, void* stream) {
  const rotg::Loop L{{(int*)acc0, (int*)acc1}, (int8_t*)dig, dig_rows, (int*)sums, keyT, n,
                     (const int*)a2N, n, 0, B, nb, n, N, d_used, log_bg, shift, Q, 1,
                     (cudaStream_t)stream};
  return rotg::dispatch(L);
}

// One step for any amount pair amt int32 [B, 2] in [0, 2N) (#11): acc
// int32 [B, 2, N] -> out, which must not overlap acc (blocks of the GEMM
// read the old accumulator while others write the new one).  keyT_i is
// the step's K-major block [8T, (2nt-1)*2RT], which a kernel just before
// may have written, so the GEMM waits before it loads; nb, dig and sums
// as above.
extern "C" int oece_rot_step(const void* acc, void* out, void* dig, void* sums,
                             const void* keyT_i, const void* amt, int B, int nb, int dig_rows,
                             int N, int d_used, int log_bg, int shift, int Q,
                             void* stream) {
  const rotg::Loop L{{(int*)acc, (int*)out}, (int8_t*)dig, dig_rows, (int*)sums, keyT_i, 1,
                     (const int*)amt, 0, 1, B, nb, 1, N, d_used, log_bg, shift, Q, 0,
                     (cudaStream_t)stream};
  return rotg::dispatch(L);
}

extern "C" const char* oece_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
