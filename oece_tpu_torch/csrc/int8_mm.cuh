// Shared pieces of the port's kernels, for Hopper (sm_90a):
//
//   * the modular helpers of oece_tpu/fhe/modmath.py (red31, mod_q,
//     mul_pow8_mod), which every step kernel takes (rot_step.cu,
//     rev_step.cu, ap_step.cu, std_step.cu);
//   * the byte shuffles of the kernels that cut key bytes out of staged
//     spans or transpose them: span_words (16-byte windows at any byte,
//     by funnel shifts; rev_build_kernel, rev_step.cu's std_build_kernel)
//     and transpose4x4 (__byte_perm; rev_build_kernel, wgmma_mm.cuh's
//     transpose_kernel);
//   * rev_build_kernel<M, kConj>, which expands one step's compact key
//     [R, M, 2N] into its row-major reversed-diagonal block (negacyclic.cu,
//     #1 alone), or with kConj into that block in the TPU's conjugated
//     basis (negacyclic.cu, #7).
//
// The step GEMMs are wgmma GEMMs over K-major key tiles: the raw
// negacyclic products (#3, #5) on wgmma_mm.cuh; the rotated form's step
// (#11, #12) and the standard form's (#8, #9 on rev keys; #1, #4 on
// ginx_ext; #2 on a row-major block that transpose_kernel writes K-major)
// on step_gemm.cuh's, the AP step (#13) on ap_step.cu's, which make their
// key tiles from the compact key.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;  // coefficients per output tile

__device__ __forceinline__ int red31(int x, int Q) {
  int y = (x >> 27) * 2047 + (x & ((1 << 27) - 1));
  return y >= Q ? y - Q : y;
}

__device__ __forceinline__ int mod_q(int x, int Q) { return red31(x + 8 * Q, Q); }

__device__ __forceinline__ int mul_pow8_mod(int x, int Q) {
  int y = (x >> 19) * 2047 + ((x & ((1 << 19) - 1)) << 8);
  return y >= Q ? y - Q : y;
}

// The true coefficient of lane c of a conjugated-basis tile (the TPU's
// byte-plane order: byte j of word w at lane 32j + w holds t = 4w + j).
__device__ __forceinline__ int trueidx(int c) { return 4 * (c & 31) + (c >> 5); }

// v[i] = bytes a + 4i .. a + 4i + 3 of the staged words `span` (byte b of
// word w is span byte 4w + b): words a/4 .. a/4 + NW, two funnel shifts a
// word.  Word a/4 + NW is read also where a % 4 == 0 and unused.
template <int NW>
__device__ __forceinline__ void span_words(const uint32_t* span, int a, uint32_t (&v)[NW]) {
  const uint32_t* src = span + (a >> 2);
  const int sh = 8 * (a & 3);
#pragma unroll
  for (int i = 0; i < NW; ++i) v[i] = __funnelshift_r(src[i], src[i + 1], sh);
}

// col[b] = byte b of x[0], x[1], x[2], x[3] (as bytes 0 .. 3): the 4 x 4
// byte transpose, six byte permutes.
__device__ __forceinline__ void transpose4x4(const uint32_t* x, uint32_t (&col)[4]) {
  const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140), hi01 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140), hi23 = __byte_perm(x[2], x[3], 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// One step's compact key ext [R, M, 2N] -> reversed diagonals, int8
// rev[d'*RT + r*T + u, m*T + t] = ext[r, m, ((nt-1-d')*T + t - u) mod 2N],
// [(2nt-1)*R*T, M*T].  With kConj, the same block in the conjugated basis
// (rows and columns of every 128 x 128 tile in byte-plane order): row
// d'*RT + r*T + u' and column m*T + c hold rev's entry at u = trueidx(u'),
// t = trueidx(c).
//
// Block (m, r, d') of 256 threads (block index (d'*R + r)*M + m, so
// neighbouring blocks fill neighbouring columns of the same rows) writes
// the 128-byte segments at column m*T of its T rows.  They read the 255
// bytes of key row ext[r, m] around (nt-1-d')*T, staged by 16 threads
// with 16-byte loads as span[j] = ext[r, m, ((nt-1-d')*T - T + j) mod 2N]
// (the start is a multiple of T, so no load wraps), so that entry (u, t)
// is span[T + t - u].  Thread (row u', h = 0 or 1) makes the 4 16-byte
// stores at columns 32g + 16h of its row.  In true order store g is span
// bytes T - u + 32g + 16h .. +15, cut from 5 staged words by funnel
// shifts.  In the conjugated basis column 32j + 16h + i holds t = 64h +
// 4i + j: the thread cuts the 16 words W_i = span bytes a + 4i .. a + 4i +
// 3, a = T - u + 64h (t = 64h + 4i .. of row u), and store j is byte j of
// W_0 .. W_15, four 4 x 4 byte transposes.  Each warp store fills 16 rows'
// 32-byte sectors (storing 16-byte halves of 32 sectors instead took #1
// 13.1 us against 6.8 for #7, chip_smoke.py neg-kernel, NVIDIA H100 80GB
// HBM3, 700 W); its staged reads hit distinct banks or one word.  Bytes
// bound: 131 KB read, the 15.7 MB block written once at STD128_OPT (4.73
// us at 3.35 TB/s).
template <int M, bool kConj = false>
__global__ void __launch_bounds__(256) rev_build_kernel(const int8_t* __restrict__ ext,
                                                        int8_t* __restrict__ rev, int N, int R) {
  __shared__ __align__(16) uint32_t span[65];  // 256 bytes; word 64 only where a % 4 == 0
  const int nt = N / T, tid = threadIdx.x;
  const int m = blockIdx.x % M, r = (blockIdx.x / M) % R, dp = blockIdx.x / (M * R);
  if (tid < 16) {
    const int at = ((nt - 2 - dp) * T + 16 * tid) & (2 * N - 1);
    ((uint4*)span)[tid] = *(const uint4*)(ext + ((long long)r * M + m) * 2 * N + at);
  }
  __syncthreads();
  const int up = tid >> 1, h = tid & 1;
  int8_t* dst = rev + ((long long)(dp * R + r) * T + up) * (M * T) + m * T + 16 * h;
  if constexpr (kConj) {
    uint32_t w[16], c[4][4];  // c[g][j]: byte j of W_4g .. W_4g+3
    span_words(span, T - trueidx(up) + 64 * h, w);
#pragma unroll
    for (int g = 0; g < 4; ++g) transpose4x4(w + 4 * g, c[g]);
#pragma unroll
    for (int j = 0; j < 4; ++j) *(uint4*)(dst + 32 * j) = make_uint4(c[0][j], c[1][j], c[2][j], c[3][j]);
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t v[4];
      span_words(span, T - up + 16 * h + 32 * g, v);
      *(uint4*)(dst + 32 * g) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Blocks of 256 threads covering `threads`.
inline int blocks_for(long long threads) { return (int)((threads + 255) / 256); }

// 0 or the first cudaError_t of the launches before it.
inline int check_launch() { return (int)cudaGetLastError(); }

}  // namespace
