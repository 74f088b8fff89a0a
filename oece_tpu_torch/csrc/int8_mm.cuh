// Shared pieces of the port's kernels, for Hopper (sm_90a):
//
//   * the modular helpers of oece_tpu/fhe/modmath.py (red31, mod_q,
//     mul_pow8_mod), which every step kernel takes (rot_step.cu,
//     rev_step.cu, ap_step.cu, std_step.cu);
//   * rev_build_kernel<M>, which expands one step's compact key [R, M, 2N]
//     into its row-major reversed-diagonal block (negacyclic.cu, #1
//     alone), or with kConj into that block in the TPU's conjugated basis
//     (negacyclic.cu, #7);
//   * int8_mm_kernel (std_step.cu, #2), the int8 contraction of one step
//     on a row-major block:
//       res[b, col] = sum_x dig[b, x] * key[(nt-1-k)*(K/nt) + x, col]
//     for each output tile k, followed by the Horner combine of the 4 key
//     limbs mod Q, written as P polynomials per gate.  The key block is
//     row-major [(2nt-1)*RT, 4P*T] reversed diagonals, columns (poly,
//     limb, t) at (poly*4 + limb)*T + t; P = 4 (part, out) or 2.
//
// The contraction is exact in int32: |sum| <= K * 128 * 128 <= 2**27.
// Design: mma.sync m16n8k32 s8 tiles of 64 gates x 128 columns,
// single-buffered shared memory, a byte transpose of each key tile in
// registers (the key is row-major in the contraction index, mma wants it
// packed along it).  The raw negacyclic products (#3, #5) run on
// wgmma_mm.cuh instead, the rotated form's step (#11, #12) and the
// standard form's steps (#8, #9 on rev keys; #1, #4 on ginx_ext) on
// step_gemm.cuh's wgmma GEMMs over K-major blocks, and the AP step (#13)
// on ap_step.cu's, which make their key tiles from the compact key.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;        // coefficients per output tile
constexpr int BM = 64;        // gates per matmul block
constexpr int BK = 64;        // contraction chunk (bytes of a digit row)
constexpr int TT = 32;        // coefficients per limb plane per block
constexpr int BN = 4 * TT;    // block columns: 4 limbs x TT coefficients
constexpr int THREADS = 256;  // 8 warps: 2 (gates) x 4 (columns)
constexpr int A_PITCH = BK + 16;  // bytes; conflict-free fragment reads
constexpr int C_PITCH = BN + 4;   // int32 words
constexpr int SMEM_AB = BM * A_PITCH + BN * BK;
constexpr int SMEM_C = BM * C_PITCH * 4;
constexpr int SMEM_BYTES = SMEM_C > SMEM_AB ? SMEM_C : SMEM_AB;

__device__ __forceinline__ int red31(int x, int Q) {
  int y = (x >> 27) * 2047 + (x & ((1 << 27) - 1));
  return y >= Q ? y - Q : y;
}

__device__ __forceinline__ int mod_q(int x, int Q) { return red31(x + 8 * Q, Q); }

__device__ __forceinline__ int mul_pow8_mod(int x, int Q) {
  int y = (x >> 19) * 2047 + ((x & ((1 << 19) - 1)) << 8);
  return y >= Q ? y - Q : y;
}

// XOR swizzle of the k-word index of a transposed key tile row n, so that
// both the transposing stores and the mma fragment loads avoid most bank
// conflicts.  Values 0, 4, 8, 12: the word stays inside the 16-word row.
__device__ __forceinline__ int swz(int n) {
  return (((n >> 1) & 3) ^ ((n >> 3) & 3)) << 2;
}

// The true coefficient of lane c of a conjugated-basis tile (the TPU's
// byte-plane order: byte j of word w at lane 32j + w holds t = 4w + j).
__device__ __forceinline__ int trueidx(int c) { return 4 * (c & 31) + (c >> 5); }

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The key words of int8_mm_kernel, for output tile k: load(w, x, col)
// gives rows x..x+3 (x % 4 == 0) of tile k's span of the block, columns
// col..col+3 (col % 4 == 0), w[i] = row x + i, byte j = column col + j.
struct BlockKey {
  const int8_t* span;  // row 0 of tile k's span
  int MT;
  __device__ __forceinline__ BlockKey(const int8_t* key, int k, int nt, int K, int MT_)
      : span(key + (long long)(nt - 1 - k) * (K / nt) * MT_), MT(MT_) {}
  __device__ __forceinline__ void load(uint32_t* w, int x, int col) const {
    const int8_t* src = span + (long long)x * MT + col;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg((const uint32_t*)(src + i * MT));
  }
};

// Grid: x = gate tiles of BM; y = (output tile k, poly o, coefficient
// chunk of TT).  Each block contracts its gates' full digit rows against
// the 4 limb planes of its TT coefficients, applies the limb combine and
// writes out[b, o, k*T + t] for P polynomials per gate.
template <int P>
__global__ void __launch_bounds__(THREADS) int8_mm_kernel(
    const int8_t* __restrict__ dig, const int8_t* __restrict__ key_step,
    int* __restrict__ out, int B, int N, int K, int Q) {
  __shared__ __align__(16) uint8_t smem[SMEM_BYTES];
  uint8_t* As = smem;                                      // [BM][A_PITCH]
  uint32_t* Bs = (uint32_t*)(smem + BM * A_PITCH);         // [BN][BK/4]
  int* Cs = (int*)smem;                                    // [BM][C_PITCH]

  const int MT = P * 4 * T;
  const int nt = N / T;
  const int chunks = T / TT;
  const int tchunk = blockIdx.y % chunks;
  const int o = (blockIdx.y / chunks) % P;
  const int k = blockIdx.y / (P * chunks);
  const int b0 = blockIdx.x * BM;
  const int t0 = tchunk * TT;
  const int tid = threadIdx.x;

  const BlockKey key(key_step, k, nt, K, MT);
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int warp_m = warp >> 2, warp_n = warp & 3;

  int accum[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) accum[mi][ni][e] = 0;

  const int a_row = tid >> 2, a_c16 = tid & 3;
  const bool a_live = b0 + a_row < B;
  const int8_t* a_src = dig + (long long)(b0 + a_row) * K + a_c16 * 16;

  for (int kx = 0; kx < K; kx += BK) {
    // digits tile: 64 rows x 64 bytes, one 16-byte load per thread
    int4 av = make_int4(0, 0, 0, 0);
    if (a_live) av = __ldg((const int4*)(a_src + kx));
    *(int4*)(As + a_row * A_PITCH + a_c16 * 16) = av;
    // key tile: 64 rows (x) x 128 columns, transposed to [column][x] with
    // 4 consecutive x packed per word
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + THREADS * r;
      const int nq_lo = idx & 7, kq = (idx >> 3) & 15, limb = idx >> 7;
      const int col = (o * 4 + limb) * T + t0 + nq_lo * 4;
      uint32_t w[4];
      key.load(w, kx + kq * 4, col);
      const int n0 = limb * TT + nq_lo * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t v = ((w[0] >> (8 * j)) & 0xffu) |
                           (((w[1] >> (8 * j)) & 0xffu) << 8) |
                           (((w[2] >> (8 * j)) & 0xffu) << 16) |
                           (((w[3] >> (8 * j)) & 0xffu) << 24);
        const int n = n0 + j;
        Bs[n * (BK / 4) + (kq ^ swz(n))] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = warp_m * 32 + mi * 16 + g;
        const uint32_t* p0 = (const uint32_t*)(As + row * A_PITCH) + kk * 8 + tig;
        const uint32_t* p1 = (const uint32_t*)(As + (row + 8) * A_PITCH) + kk * 8 + tig;
        af[mi][0] = p0[0];
        af[mi][1] = p1[0];
        af[mi][2] = p0[4];
        af[mi][3] = p1[4];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = warp_n * 32 + ni * 8 + g;
        bf[ni][0] = Bs[n * (BK / 4) + ((kk * 8 + tig) ^ swz(n))];
        bf[ni][1] = Bs[n * (BK / 4) + ((kk * 8 + 4 + tig) ^ swz(n))];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(accum[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // limb accumulators -> shared memory, then one thread per (gate, coeff)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = warp_m * 32 + mi * 16 + g;
      const int col = warp_n * 32 + ni * 8 + tig * 2;
      Cs[row * C_PITCH + col] = accum[mi][ni][0];
      Cs[row * C_PITCH + col + 1] = accum[mi][ni][1];
      Cs[(row + 8) * C_PITCH + col] = accum[mi][ni][2];
      Cs[(row + 8) * C_PITCH + col + 1] = accum[mi][ni][3];
    }
  __syncthreads();
  for (int e = tid; e < BM * TT; e += THREADS) {
    const int row = e / TT, tt = e % TT;
    const int b = b0 + row;
    if (b >= B) continue;
    const int* cr = Cs + row * C_PITCH + tt;
    int comb = mod_q(cr[3 * TT], Q);
#pragma unroll
    for (int l = 2; l >= 0; --l) {
      comb = mul_pow8_mod(comb, Q) + mod_q(cr[l * TT], Q);
      if (comb >= Q) comb -= Q;
    }
    out[((long long)b * P + o) * N + k * T + t0 + tt] = comb;
  }
}

// One step's compact key ext [R, M, 2N] -> reversed diagonals, int8
// rev[d'*RT + r*T + u, m*T + t] = ext[r, m, ((nt-1-d')*T + t - u) mod 2N],
// [(2nt-1)*R*T, M*T].  With kConj, the same block in the conjugated basis
// (rows and columns of every 128 x 128 tile in byte-plane order): row
// d'*RT + r*T + u' and column m*T + c hold rev's entry at u = trueidx(u'),
// t = trueidx(c).  One thread per 16 output bytes.
template <int M, bool kConj = false>
__global__ void rev_build_kernel(const int8_t* __restrict__ ext,
                                 int8_t* __restrict__ rev, int N, int R) {
  constexpr int MT = M * T;
  constexpr int per_row = MT / 16;
  const int RT = R * T, nt = N / T;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)(2 * nt - 1) * RT * per_row) return;
  const int row = (int)(gid / per_row), c16 = (int)(gid % per_row);
  const int dp = row / RT, r = (row / T) % R;
  const int u = kConj ? trueidx(row % T) : row % T;
  const int m = c16 / (T / 16), t0 = (c16 % (T / 16)) * 16;
  const uint8_t* src = (const uint8_t*)ext + ((long long)r * M + m) * 2 * N;
  const int base = (nt - 1 - dp) * T - u;  // > -2N; 2N is a power of 2
  const int mask = 2 * N - 1;
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int c = t0 + 4 * q + bb;
      w[q] |= (uint32_t)src[(base + (kConj ? trueidx(c) : c)) & mask] << (8 * bb);
    }
  }
  *(int4*)(rev + (long long)row * MT + m * T + t0) =
      make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// Blocks of 256 threads covering `threads`.
inline int blocks_for(long long threads) { return (int)((threads + 255) / 256); }

// 0 or the first cudaError_t of the launches before it.
inline int check_launch() { return (int)cudaGetLastError(); }

}  // namespace
