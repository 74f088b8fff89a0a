// GINX blind rotation, CGGI rotated-difference form, for Hopper (sm_90a).
//
// Replaces the TPU kernel oece_tpu/fhe/pallas_kernels.py::_rot_megakernel
// (launched by blind_rotate_rot_megakernel) with two kernels per step,
// looped over the n steps on the host side of this file:
//
//   rot_diff_decompose_kernel  for each gate b, part p and accumulator poly:
//       d_p = (X^{c_p} * acc - acc) mod Q   (c_pos = 2N - a, c_neg = a)
//       -> gadget digits, int8 scratch dig[b, j*2RT + p*RT + rr*T + u]
//   rot_matmul_kernel          for each output tile k (128 coefficients):
//       res[b, col] = sum_x dig[b, x] * rev2_i[(nt-1-k)*2RT + x, col]
//       acc'[b, o, kT+t] = red31(acc + combine_limbs(res[b, (o*4+l)*T+t]))
//
// The accumulator ping-pongs between two buffers: every block of the
// matmul kernel reads the OLD accumulator while others write the new one,
// and the digits of a step are complete before its matmul starts (stream
// order), which is the ordering the TPU kernel gets from its sequential
// grid.
//
// Bounds on the H100.  One step costs nt*K*8T = 67 M int8 MACs per gate at
// STD128_OPT (K = nt*2R*T = 8192), 33.7 G MAC per bootstrap over n = 502
// steps, and streams a 15.7 MB key block that every gate of the batch
// shares.  At batch 2048 a step is 137 G MAC: tensor-core bound, with the
// key block and the 16 MB digit scratch both resident in the 50 MB L2.
// The contraction is exact in int32: |sum| <= K * 128 * 128 = 2**27.
//
// This design is the simple one: mma.sync m16n8k32 s8 tiles of 64 gates x
// 128 columns, single-buffered shared memory, a byte transpose of each key
// tile in registers (rev2 is row-major in the contraction index, mma wants
// it packed along it), and two launches per step.  Left on the table:
// wgmma with TMA-fed multi-stage pipelines, keeping the accumulator
// resident across steps in a persistent kernel, building the Toeplitz key
// tiles in shared memory from the compact key instead of streaming the
// 8 GB rev2 array, and capturing the step loop in a CUDA graph.

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

// One thread per (gate b, accumulator poly pp, coefficient m): both parts'
// rotated differences and their gadget digits.
__global__ void rot_diff_decompose_kernel(
    const int* __restrict__ acc, const int* __restrict__ a2N, int a_stride,
    int step, int8_t* __restrict__ dig, int B, int N, int d_used, int log_bg,
    int shift, int Q) {
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)B * 2 * N) return;
  const int m = (int)(gid % N);
  const int pp = (int)((gid / N) & 1);
  const int b = (int)(gid / (2 * N));
  const int* poly = acc + ((long long)b * 2 + pp) * N;
  const int a = a2N[(long long)b * a_stride + step];
  const int two_n = 2 * N;
  const int RT = 2 * d_used * T;
  const long long K = (long long)(N / T) * 2 * RT;
  const int bg = 1 << log_bg, half = bg >> 1;
  const int x = poly[m];
  int8_t* drow = dig + b * K + (m / T) * 2 * RT + pp * d_used * T + (m % T);
  for (int part = 0; part < 2; ++part) {
    const int c = part == 0 ? ((two_n - a) & (two_n - 1)) : a;
    const int cp = c & (N - 1);
    const int src = poly[(m - cp) & (N - 1)];
    const bool wrap = (m < cp) != (c >= N);
    const int rot = wrap ? (src == 0 ? 0 : Q - src) : src;
    int d = rot - x;
    if (d < 0) d += Q;
    int8_t* out = drow + part * RT;
    int cur;
    if (shift > 0) {  // approximate gadget: centre, round away `shift` bits
      const int cen = d >= (Q + 1) / 2 ? d - Q : d;
      cur = (cen + (1 << (shift - 1))) >> shift;
      for (int g = 0; g < d_used - 1; ++g) {
        const int r = ((cur + half) & (bg - 1)) - half;
        out[g * T] = (int8_t)r;
        cur = (cur - r) >> log_bg;
      }
    } else {  // exact gadget: signed digits, unsigned top digit
      cur = d;
      for (int g = 0; g < d_used - 1; ++g) {
        int r = cur & (bg - 1);
        if (r >= half) r -= bg;
        out[g * T] = (int8_t)r;
        cur = (cur - r) >> log_bg;
      }
    }
    out[(d_used - 1) * T] = (int8_t)cur;
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Grid: x = gate tiles of BM; y = (output tile k, out poly o, coefficient
// chunk of TT).  Each block contracts its gates' full digit rows against
// the 4 limb planes of its TT coefficients and applies the limb combine,
// the accumulator add and red31.
__global__ void __launch_bounds__(THREADS) rot_matmul_kernel(
    const int8_t* __restrict__ dig, const int8_t* __restrict__ rev2_i,
    const int* __restrict__ acc_in, int* __restrict__ acc_out, int B, int N,
    int K, int Q) {
  __shared__ __align__(16) uint8_t smem[SMEM_BYTES];
  uint8_t* As = smem;                                      // [BM][A_PITCH]
  uint32_t* Bs = (uint32_t*)(smem + BM * A_PITCH);         // [BN][BK/4]
  int* Cs = (int*)smem;                                    // [BM][C_PITCH]

  const int MT = 8 * T;
  const int nt = N / T;
  const int chunks = T / TT;
  const int tchunk = blockIdx.y % chunks;
  const int o = (blockIdx.y / chunks) & 1;
  const int k = blockIdx.y / (2 * chunks);
  const int b0 = blockIdx.x * BM;
  const int t0 = tchunk * TT;
  const int8_t* key = rev2_i + (long long)(nt - 1 - k) * (K / nt) * MT;

  const int tid = threadIdx.x;
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
      const int8_t* src = key + (long long)(kx + kq * 4) * MT + col;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __ldg((const uint32_t*)(src + i * MT));
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
    const long long at = ((long long)b * 2 + o) * N + k * T + t0 + tt;
    acc_out[at] = red31(acc_in[at] + comb, Q);
  }
}

}  // namespace

// The whole rotation: n steps of (decompose, matmul).  acc0 holds the
// initial accumulator; step i reads buffer i%2 and writes buffer (i+1)%2,
// so the result is in buffer n%2.  dig is int8 scratch [B, K].  Returns 0
// or the first cudaError_t of a launch.
extern "C" int oece_blind_rotate_rot(void* acc0, void* acc1, void* dig,
                                     const void* rev2, const void* a2N, int B,
                                     int n, int N, int d_used, int log_bg,
                                     int shift, int Q, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = N / T;
  const int R = 2 * d_used;
  const int K = nt * 2 * R * T;
  const long long step_elems = (long long)(2 * nt - 1) * 2 * R * T * 8 * T;
  int* bufs[2] = {(int*)acc0, (int*)acc1};
  const long long total = (long long)B * 2 * N;
  const int blocks_a = (int)((total + 255) / 256);
  const dim3 grid_b((B + BM - 1) / BM, nt * 2 * (T / TT));
  for (int i = 0; i < n; ++i) {
    rot_diff_decompose_kernel<<<blocks_a, 256, 0, s>>>(
        bufs[i & 1], (const int*)a2N, n, i, (int8_t*)dig, B, N, d_used,
        log_bg, shift, Q);
    rot_matmul_kernel<<<grid_b, THREADS, 0, s>>>(
        (const int8_t*)dig, (const int8_t*)rev2 + i * step_elems, bufs[i & 1],
        bufs[(i + 1) & 1], B, N, K, Q);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" const char* oece_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
