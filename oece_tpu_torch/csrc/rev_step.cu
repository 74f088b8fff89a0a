// GINX blind rotation, standard form, for Hopper (sm_90a): on blocks
// prebuilt at keygen (the "rev" key layout), or on keys expanded per step
// (ginx_ext, host keys) with each step's block built into a ring of two.
//
// Replaces, on the device-key path of OECE_LAYOUT=rev (the step loop of
// oece_tpu/fhe/boot.py::_external_cmux_prebuilt, boot.py:401-422), the TPU
// kernels of oece_tpu/fhe/pallas_kernels.py:
//   #8 _window_matmul_true_kernel (window_matmul_true): digits x one step's
//      block with the Horner combine of the 4 key limbs fused, M = 16 or 8
//      planes;
//   #9 _matmul_dec_true_kernel (window_matmul_dec_true): the gadget digits
//      of the accumulator, then #8;
// and, inside the step loop, the function of #10 _cmux_epilogue_true_kernel
// (the rotations and the CMUX add; #10 alone stays std_step.cu's
// std_cmux_kernel).  On the host-key path (_external_cmux_pallas, one
// lax.scan step per key step) it replaces
//   #1 _build_diag_kernel (build_diagonals_pallas): byte-phase key windows
//      -> the step's 2nt-1 negacyclic diagonal blocks;
//   #4 _diag_matmul_combine_kernel (diag_matmul_combine_pallas): digits x
//      those blocks with the limb combine fused (#8's function);
// and the jnp epilogue around them (boot.py:358-363): once #1 has built a
// step's block, a standard-form step is a rev step.  For each step i and
// gate b, with a = a2N[b, i] (T = 128, nt = N/T, R = 2*d_used, RT = R*T,
// K = nt*RT):
//
//   P[b, poly, k*T + t] = combine_limbs(sum_x dig[b, x] * rev_i[(nt-1-k)*RT + x, (poly*4 + l)*T + t])
//   acc <- red31(acc + X^c0 P0 + X^c1 P1 + 2Q - P0 - P1),  (c0, c1) = (2N - a, a)
//
// with P_part = P[b, part*2 + out] and dig the gadget digits of acc at
// dig[b, j*RT + (poly*d_used + g)*T + u] for coefficient j*T + u.
//
// The GEMMs read a step's block K-major: keyT int8 [steps, 16, T,
// (2nt-1)*RT], entry [i, m, t, x] = the row-major block's [x, m*T + t],
// which is how wgmma reads an 8-bit operand from shared memory.  The key
// source is the rev key (keys.py; step coordinate i), or a ring of two
// blocks that std_build_kernel fills from ginx_ext (step coordinate i & 1).
// One 4D TMA map over the key or the ring serves every step; a box of 4
// planes x 16 coefficients x 128 bytes lands the 4 limbs of 16
// coefficients of one output poly at rows 16l of a 64-row A tile.  The
// GEMMs are rot_step.cu's, from step_gemm.cuh (gemm_tiled, gemm_split):
// these 64 key columns on wgmma's M and the gates on its N, so a narrow
// batch pays for no padded rows.  Against the rotated form's step they
// differ in the geometry only: 16 planes (4 output polys, 32 column
// chunks), a diagonal of RT contraction bytes (not 2RT), K = nt*RT = 4,096
// per output tile at STD128_OPT, and the output is the limb-combined
// product P mod Q, not an accumulator update.  Per step two kernels (three
// on ginx_ext), launched with programmatic dependent launch:
//
//   std_build_kernel  (ginx_ext only) step i's block into slot i & 1:
//       ring[i & 1, m, t, d'*RT + r*T + u] = ginx_ext[i, r, m, ((nt-1-d')*T + t - u) mod 2N].
//       For fixed (m, t, d', r) the 128 bytes along u are one window of
//       the key row ginx_ext[i, r, m, :] read backwards with wrap mod 2N,
//       and the 128 t of one (m, r, d') share 255 bytes of that row: a
//       block stages them reversed in shared memory (16-byte loads, bytes
//       reversed by __byte_perm) and writes whole 16-byte vectors, each
//       cut from 5 staged words by funnel shifts; coalesced on both sides.
//       The slot it overwrites was read by the GEMM of step i-2.  Each
//       kernel of the loop waits for its predecessor (griddepcontrol.wait)
//       before it lets its successor launch, so once the GEMM of step i-1
//       has let the build launch, the GEMM of step i-2 has finished: the
//       build writes at once, while the GEMM of step i-1 reads the other
//       slot, and waits for that GEMM only before it exits, so that the
//       digits kernel after it finds the products of step i-1 (measured:
//       1-4% off the step at B = 16 ... 2048 against a build that waits
//       first, PERF.md).
//   rev_digits_kernel  for each gate b, accumulator poly and 4
//       coefficients: the previous step's CMUX (from its P, or its split
//       sums reduced mod Q on read), written to acc in place, then the
//       gadget digits of the new accumulator, one 4-byte store per digit
//       row.  The rotations read P at positions other threads also read,
//       so the CMUX cannot move into the GEMM's epilogue (a rotation
//       crosses output tiles).  After the last step it runs once more
//       without digits: the last CMUX alone.
//   the step GEMM, the instance of the gate tile NB that the caller passes
//   (rot.py: gemm_config; step_gemm.cuh: with_tile)
//     rev_gemm_split_kernel<NB>  (NB = 8 or 16, B <= NB) each key tile is
//       read once per step: a block owns one column chunk and dpg of the
//       2nt-1 diagonals (at most 128 blocks: 4 diagonal groups of 32
//       chunks at 16 planes), one m64n(8NB)k32 wgmma per 32 bytes serves
//       all nt output tiles, and limb-combined partial sums (< 4Q with 4
//       groups, < 8Q with 8 at M = 8) meet by atomics in a sum [B, 4, N]
//       that the digits kernel of the same step zeroed.  On the prebuilt
//       rev key each block issues its first key stages before it waits
//       for the digits kernel, as in rot_step.cu.  The sums
//       ping-pong between two buffers: the next digits kernel reads the
//       one at rotated positions while it zeroes the other.
//     rev_gemm_kernel<NB, MW>  (NB = 32, 48, .. 256 fitted to B, two math
//       warpgroups above 256 gates) persistent blocks walk tiles of
//       (output tile k, MW column chunks, NB gates), from digits padded
//       with zero rows to the gate tile, as in rot_step.cu, and write P
//       in [0, Q) with the limb combine in the epilogue.
//
// #8 alone runs the GEMM on the given digits, #9 alone the digits kernel
// (without a CMUX) and the GEMM; with the split GEMM the sums land in the
// output, zeroed first, and rev_reduce_kernel takes them mod Q in place.
// #8 alone also serves #2 of the kernel-level API (negacyclic.cu:
// oece_window_matmul) on the block that #3's transpose_kernel writes
// K-major from a row-major one, so #8 takes any R.
// #1 alone (oece_std_build) builds one step's K-major block.  A gate with
// a = 0 gets its accumulator back unchanged: both rotations are the
// identity, so the CMUX adds 2Q - 2Q.
//
// Bounds on the H100.  A step contracts nt * K * 16T = 67.1 M int8 MACs
// per gate at STD128_OPT, as a rotated-form step, and streams a 15.7 MB
// block that every gate shares: at 4-8 lanes 4.7 us of HBM (bytes bound);
// at B = 2048, 275 G ops, 0.139 ms at the 1,979 TOPS int8 peak
// (operations bound).  On ginx_ext the build reads a 131 KB step key and
// writes the 15.7 MB block (4.7 us of HBM); the ring's two slots (31.4 MB)
// fit the 50 MB L2, where the GEMM then finds the block.  The contraction
// is exact in int32: |sum| <= K * 128 * 128 = 2**26.  The digits kernel
// moves the accumulator twice, P once and the digits once (75 MB at B =
// 2048, 22 us of HBM; P and the digits are mostly L2-resident).
//
// Left undone: the digits fused into the GEMM (one launch per step), a
// CUDA graph of the step loop, and the key tiles made on chip from the
// 131 KB compact key (ap_step.cu's way) instead of a built or prebuilt
// block.

#include <algorithm>

#include "int8_mm.cuh"
#include "step_gemm.cuh"
#include "wgmma_mm.cuh"

namespace {

// Entry idx of P in [0, Q): the tiled GEMM's product, or the split GEMM's
// sum of partial products (< 8Q, so one red31 suffices).
__device__ __forceinline__ int p_value(const int* __restrict__ P, int summed, long long idx,
                                       int Q) {
  return summed ? red31(P[idx], Q) : P[idx];
}

// (X^c * P_row)[m] for c in [0, 2N): a cyclic rotation by c mod N and the
// negacyclic sign, from P reduced mod Q first.
__device__ __forceinline__ int rotated_p(const int* __restrict__ P, int summed, long long row,
                                         int c, int m, int N, int Q) {
  const int cp = c & (N - 1);
  const int src = p_value(P, summed, row + ((m - cp) & (N - 1)), Q);
  const bool wrap = (m < cp) != (c >= N);
  return wrap ? (src == 0 ? 0 : Q - src) : src;
}

// One thread per (gate b, accumulator poly pp, 4 coefficients m0 .. m0+3).
// With P (int32 [B, 4, N], the products of step pstep; summed: the split
// GEMM's sums), first the CMUX of that step on acc in place: each thread
// reads and writes only its own accumulator entries.  With sum_zero
// ([B, polys, N]), zero this thread's coefficients of its polys pp and
// pp + 2.  With dig, the gadget digits of the (new) accumulator, one
// 4-byte store per digit row.
__global__ void rev_digits_kernel(int* __restrict__ acc, const int* __restrict__ P, int summed,
                                  int* __restrict__ sum_zero, int polys,
                                  const int* __restrict__ a2N, int a_stride, int pstep,
                                  int8_t* __restrict__ dig, int B, int N, int d_used, int log_bg,
                                  int shift, int Q) {
  pdl_wait_and_release();
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int quads = N / 4;
  if (gid >= (long long)B * 2 * quads) return;
  const int m0 = (int)(gid % quads) * 4;
  const int pp = (int)((gid / quads) & 1);
  const long long b = gid / (2 * quads);
  int4 v = *(const int4*)(acc + (b * 2 + pp) * N + m0);
  int x[4] = {v.x, v.y, v.z, v.w};
  if (P) {
    const int two_n = 2 * N, a = a2N[b * a_stride + pstep];
    const int c0 = (two_n - a) & (two_n - 1), c1 = a;
    const long long row0 = (b * 4 + pp) * N, row1 = (b * 4 + 2 + pp) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + j;
      int y = x[j] + 2 * Q;  // < 5Q < 2**31 after the four terms
      y += rotated_p(P, summed, row0, c0, m, N, Q) - p_value(P, summed, row0 + m, Q);
      y += rotated_p(P, summed, row1, c1, m, N, Q) - p_value(P, summed, row1 + m, Q);
      x[j] = red31(y, Q);
    }
    *(int4*)(acc + (b * 2 + pp) * N + m0) = make_int4(x[0], x[1], x[2], x[3]);
  }
  if (sum_zero)
    for (int q = pp; q < polys; q += 2)
      *(int4*)(sum_zero + (b * polys + q) * N + m0) = make_int4(0, 0, 0, 0);
  if (dig) {
    const int RT = 2 * d_used * T;
    uint32_t w[MAX_DIGITS] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; ++j) pack_digits(x[j], w, j, d_used, log_bg, shift, Q);
    int8_t* drow = dig + b * (long long)(N / T) * RT + (m0 / T) * RT + pp * d_used * T + (m0 % T);
#pragma unroll
    for (int g = 0; g < MAX_DIGITS; ++g)
      if (g < d_used) *(uint32_t*)(drow + g * T) = w[g];
  }
}

// #1: one step's compact key ext [R, 16, 2N] -> its block K-major, out
// [16, T, (2nt-1)*RT], out[m, t, d'*RT + r*T + u] = ext[r, m, ((nt-1-d')*T
// + t - u) mod 2N].  Block (m, r, d') of 256 threads: the 128 t share the
// row bytes from (nt-1-d')*T - 127 to (nt-1-d')*T + 127 (mod 2N), staged
// reversed as span[j] = ext[r, m, (2N-1 - S0 - j) mod 2N] with S0 = (2N -
// (nt-d')*T) mod 2N, a multiple of 128, so the 16 groups of 16 bytes are
// whole groups of the row; then out[m, t, d'*RT + r*T + u] = span[127 - t
// + u], 16 bytes per store from 5 staged words.  `early`: write first,
// wait for the predecessor last (the ring's overlap of a build with the
// GEMM before it, which reads the other slot).
__global__ void __launch_bounds__(256) std_build_kernel(const int8_t* __restrict__ ext,
                                                        int8_t* __restrict__ out, int N, int R,
                                                        int early) {
  __shared__ uint32_t span[64];
  if (early)
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  else
    pdl_wait_and_release();
  const int nt = N / T, ndiag = 2 * nt - 1, RT = R * T, tid = threadIdx.x;
  const int dp = blockIdx.x % ndiag, r = (blockIdx.x / ndiag) % R, m = blockIdx.x / (ndiag * R);
  if (tid < 16) {
    const int groups = 2 * N / 16;  // of 16 bytes in a row
    const int h = ((2 * N - (nt - dp) * T) / 16 + tid) & (groups - 1);
    const uint4 v = *(const uint4*)(ext + ((long long)r * 16 + m) * 2 * N + 16 * (groups - 1 - h));
    ((uint4*)span)[tid] = make_uint4(__byte_perm(v.w, 0, 0x0123), __byte_perm(v.z, 0, 0x0123),
                                     __byte_perm(v.y, 0, 0x0123), __byte_perm(v.x, 0, 0x0123));
  }
  __syncthreads();
  const long long rows = (long long)ndiag * RT;
  const int v = tid & 7;  // 16-byte vector of the row: u = 16v .. 16v+15
  int8_t* dst = out + (long long)m * T * rows + dp * RT + r * T + 16 * v;
#pragma unroll
  for (int it = 0; it < T / 32; ++it) {
    const int t = (tid >> 3) + 32 * it;
    uint32_t w[4];
    span_words(span, T - 1 - t + 16 * v, w);
    *(uint4*)(dst + t * rows) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (early) asm volatile("griddepcontrol.wait;" ::: "memory");
}

// x <- x mod Q for the split GEMM's sums (< 8Q) of #8 and #9 alone.
__global__ void rev_reduce_kernel(int* __restrict__ x, long long total, int Q) {
  pdl_wait_and_release();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) x[i] = red31(x[i], Q);
}

namespace revg {

using rotg::Cfg;
using rotg::CHUNK;
using rotg::Shape;

// P = the limb-combined products of key step `step` in [0, Q), out
// [B, polys, N]; step_gemm.cuh's gemm_tiled.
template <int NB, int MW>
__global__ void __launch_bounds__(Cfg<NB, MW>::THREADS, 1) rev_gemm_kernel(
    const __grid_constant__ CUtensorMap dig_map, const __grid_constant__ CUtensorMap key_map,
    int* __restrict__ out, Shape g, int step) {
  rotg::gemm_tiled<NB, MW, false>(&dig_map, &key_map, nullptr, out, g, step);
}

// sum [B, polys, N] += the limb-combined partial products of key step
// `step` over one diagonal group; step_gemm.cuh's gemm_split.
template <int NB>
__global__ void __launch_bounds__(256, 1) rev_gemm_split_kernel(
    const __grid_constant__ CUtensorMap dig_map, const __grid_constant__ CUtensorMap key_map,
    int* __restrict__ sum, Shape g, int step, int dpg, int early) {
  rotg::gemm_split<NB>(&dig_map, &key_map, sum, g, step, dpg, early);
}

enum Mode { ROTATE, MATMUL_DEC, MATMUL };

// A run of the GEMM against the K-major key keyT [n, 4*polys, T,
// (2nt-1)*RT] with its digits dig int8 [B, K], R digit rows:
//   ROTATE      the whole rotation on acc [B, 2, N] in place, n steps,
//               amounts a2N [B, n]; prod: P [B, 4, N] (tiled) or two sums
//               [2, B, 4, N] (split); with ext (ginx_ext [n, R, 16, 2N])
//               keyT is a ring [2, 16, T, (2nt-1)*RT] that step i's build
//               fills at slot i & 1;
//   MATMUL_DEC  #9: the digits of acc into dig, then the GEMM into prod =
//               the output [B, polys, N];
//   MATMUL      #8: the GEMM on the given digits into prod.
// NB is the GEMM's gate tile (rot.py: gemm_config).
struct Run {
  Mode mode;
  int* acc;
  int* prod;
  int8_t* dig;
  const void* keyT;
  int polys;
  const int* a2N;
  int B, n, N, R, log_bg, shift, Q;
  cudaStream_t st;
  const int8_t* ext;
  int dig_rows;  // rows of dig (>= B); from B on zero
  int NB;
};

cudaError_t digits(const Run& A, const int* P, int summed, int* sum_zero, int pstep, int8_t* dig) {
  return rotg::launch(rev_digits_kernel, blocks_for((long long)A.B * 2 * A.N / 4), 256, 0, A.st,
                      A.acc, P, summed, sum_zero, A.polys, A.a2N, A.n, pstep, dig, A.B, A.N,
                      A.R / 2, A.log_bg, A.shift, A.Q);
}

// Step i's block from ext into slot i & 1 of the ring keyT.  From step 1
// on the build writes while the GEMM of step i-1 runs (it reads the other
// slot) and waits for it last: the GEMM of step i-2, which read this slot,
// finished before the GEMM of step i-1 let the build launch.
cudaError_t build(const Run& A, int i) {
  const int nt = A.N / T;
  const long long slot = 16LL * T * (2 * nt - 1) * A.R * T;
  return rotg::launch(std_build_kernel, 16 * A.R * (2 * nt - 1), 256, 0, A.st,
                      A.ext + (long long)i * A.R * 16 * 2 * A.N,
                      (int8_t*)const_cast<void*>(A.keyT) + (i & 1) * slot, A.N, A.R, (int)(i > 0));
}

template <int NB, int MW, bool kSplit>
int run(const Run& A, int dpg) {
  const Shape g = rotg::step_shape(A.B, A.N, A.Q, A.R * T, A.polys, NB, MW);
  CUtensorMap dig_map, key_map;
  const bool ring = A.ext != nullptr;
  if (!rotg::make_maps(A.keyT, ring ? 2 : A.n, 4 * A.polys, A.dig, A.dig_rows, g, NB,
                       kSplit ? dpg : 0, &dig_map, &key_map))
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t e;
  if constexpr (kSplit)
    e = rotg::allow_smem((const void*)rev_gemm_split_kernel<NB>, smem_set);
  else
    e = rotg::allow_smem((const void*)rev_gemm_kernel<NB, MW>, smem_set);
  const int groups = (2 * (A.N / T) - 1 + dpg - 1) / dpg, grid = std::min(g.tiles, rotg::sm_count());
  // the split GEMM loads key tiles before its wait on the rotation's
  // prebuilt rev key, which no kernel writes; the ring's slot is written
  // by the step's build, and #8's block may be by the kernel before it
  const int early = A.mode == ROTATE && !ring;
  const auto gemm = [&](int* out, int step) {
    if constexpr (kSplit)
      return rotg::launch(rev_gemm_split_kernel<NB>, g.polys * (T / CHUNK) * groups, 256,
                          rotg::split_smem(NB, A.R, dpg), A.st, dig_map, key_map, out, g, step, dpg,
                          early);
    else
      return rotg::launch(rev_gemm_kernel<NB, MW>, grid, Cfg<NB, MW>::THREADS, Cfg<NB, MW>::SMEM,
                          A.st, dig_map, key_map, out, g, step);
  };
  const long long plane = (long long)A.B * A.polys * A.N;
  if (A.mode == ROTATE) {
    // step i's products land in P (tiled) or sums[i%2] (split, zeroed by
    // step i's digits kernel); the digits kernel of step i+1, or the last
    // run of it, applies them
    for (int i = 0; i < A.n && e == cudaSuccess; ++i) {
      int* out = kSplit ? A.prod + (i & 1) * plane : A.prod;
      const int* prev = i == 0 ? nullptr : kSplit ? A.prod + ((i - 1) & 1) * plane : A.prod;
      if (ring) e = build(A, i);
      if (e == cudaSuccess) e = digits(A, prev, kSplit, kSplit ? out : nullptr, i - 1, A.dig);
      if (e == cudaSuccess) e = gemm(out, ring ? i & 1 : i);
    }
    if (e == cudaSuccess)
      e = digits(A, kSplit ? A.prod + ((A.n - 1) & 1) * plane : A.prod, kSplit, nullptr, A.n - 1,
                 nullptr);
  } else {
    if (e == cudaSuccess)
      e = A.mode == MATMUL_DEC ? digits(A, nullptr, 0, kSplit ? A.prod : nullptr, 0, A.dig)
          : kSplit             ? cudaMemsetAsync(A.prod, 0, plane * 4, A.st)
                               : cudaSuccess;
    if (e == cudaSuccess) e = gemm(A.prod, 0);
    if (kSplit && e == cudaSuccess)
      e = rotg::launch(rev_reduce_kernel, blocks_for(plane), 256, 0, A.st, A.prod, plane, A.Q);
  }
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}

// The run with the GEMM instance of the given gate tile A.NB.  The digits
// kernel of ROTATE and MATMUL_DEC needs R = 2*d_used, d_used <=
// MAX_DIGITS.
int dispatch(const Run& A) {
  const bool digits = A.mode == ROTATE || A.mode == MATMUL_DEC;
  if (A.R < 1 || (digits && (A.R % 2 || A.R / 2 > MAX_DIGITS)) || A.n < 1 ||
      (A.polys != 4 && A.polys != 2) || A.N % T || A.dig_rows < A.B)
    return (int)cudaErrorInvalidValue;
  const int dpg = rotg::split_dpg(A.N, A.polys);
  return rotg::with_tile(A.NB, A.B, rotg::split_fits(A.N, rotg::split_smem(A.NB, A.R, dpg)),
                         [&](auto t) {
                           using Tl = decltype(t);
                           return run<Tl::NB, Tl::MW, Tl::SPLIT>(A, dpg);
                         });
}

}  // namespace revg
}  // namespace

// The whole rotation: n steps of (digits with the previous CMUX, GEMM),
// then the last CMUX, on acc int32 [B, 2, N] in place.  nb is the GEMM's
// gate tile (rot.py: gemm_config; 8 or 16 the split GEMM); prod is int32
// scratch [B, 4, N] (tiled GEMM) or [2, B, 4, N] (split GEMM), dig int8
// scratch [dig_rows, nt*RT], its rows from B on zero, B rounded up to nb
// (rev.py: step_scratch), keyT the K-major rev key [n, 16, T,
// (2nt-1)*RT], a2N int32 [B, n].  Returns 0 or the first cudaError_t of a
// launch (cudaErrorInvalidValue for a tile the loop has no instance of).
extern "C" int oece_blind_rotate_rev(void* acc, void* prod, void* dig, const void* keyT,
                                     const void* a2N, int B, int nb, int dig_rows, int n, int N,
                                     int d_used, int log_bg, int shift, int Q, void* stream) {
  const revg::Run A{revg::ROTATE, (int*)acc, (int*)prod, (int8_t*)dig, keyT, 4, (const int*)a2N,
                    B, n, N, 2 * d_used, log_bg, shift, Q, (cudaStream_t)stream, nullptr, dig_rows,
                    nb};
  return revg::dispatch(A);
}

// The whole rotation on ginx_ext int8 [n, R, 16, 2N]: n steps of (build
// into ring slot i & 1, digits with the previous CMUX, GEMM), then the
// last CMUX, on acc in place; ring int8 scratch [2, 16, T, (2nt-1)*RT],
// the rest as oece_blind_rotate_rev's.
extern "C" int oece_blind_rotate_std(void* acc, void* prod, void* dig, void* ring,
                                     const void* ginx_ext, const void* a2N, int B, int nb,
                                     int dig_rows, int n, int N, int d_used, int log_bg, int shift,
                                     int Q, void* stream) {
  const revg::Run A{revg::ROTATE, (int*)acc, (int*)prod, (int8_t*)dig, ring, 4, (const int*)a2N,
                    B, n, N, 2 * d_used, log_bg, shift, Q, (cudaStream_t)stream,
                    (const int8_t*)ginx_ext, dig_rows, nb};
  return revg::dispatch(A);
}

// #1 alone: one step's ginx_ext int8 [R, 16, 2N] -> its K-major block
// [16, T, (2nt-1)*R*T].
extern "C" int oece_std_build(const void* ext, void* out, int N, int R, void* stream) {
  if (N % T || N < T) return (int)cudaErrorInvalidValue;
  const cudaError_t e = rotg::launch(std_build_kernel, 16 * R * (2 * (N / T) - 1), 256, 0,
                                     (cudaStream_t)stream, (const int8_t*)ext, (int8_t*)out, N, R, 0);
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}

// #8 alone: dig int8 [B, nt*R*T] x the K-major block blockT int8
// [4*polys, T, (2nt-1)*R*T] -> out int32 [B, polys, N] mod Q, polys = 4
// (M = 16) or 2 (M = 8), with the GEMM of gate tile nb (rot.py:
// gemm_config).
extern "C" int oece_rev_window_matmul(const void* dig, const void* blockT, void* out, int B, int nb,
                                      int N, int R, int polys, int Q, void* stream) {
  const revg::Run A{revg::MATMUL, nullptr, (int*)out, (int8_t*)dig, blockT, polys, nullptr,
                    B, 1, N, R, 0, 0, Q, (cudaStream_t)stream, nullptr, B, nb};
  return revg::dispatch(A);
}

// #9 alone: the gadget digits of acc int32 [B, 2, N] into scratch dig
// [dig_rows, nt*RT] (as oece_blind_rotate_rev's, for gate tile nb), then
// #8 against blockT into out.
extern "C" int oece_rev_matmul_dec(const void* acc, void* dig, const void* blockT, void* out,
                                   int B, int nb, int dig_rows, int N, int d_used, int log_bg,
                                   int shift, int polys, int Q, void* stream) {
  const revg::Run A{revg::MATMUL_DEC, (int*)acc, (int*)out, (int8_t*)dig, blockT, polys, nullptr,
                    B, 1, N, 2 * d_used, log_bg, shift, Q, (cudaStream_t)stream, nullptr, dig_rows,
                    nb};
  return revg::dispatch(A);
}
