// GINX blind rotation, CGGI rotated-difference form, for Hopper (sm_90a).
//
// Replaces the TPU kernel oece_tpu/fhe/pallas_kernels.py::_rot_megakernel
// (launched by blind_rotate_rot_megakernel) with two kernels per step,
// looped over the n steps on the host side of this file
// (oece_blind_rotate_rot), and the per-step TPU kernel _rot_step_true_kernel
// (rot_step_true, the lax.scan of OECE_ROT_MEGA=0) with the same two
// kernels launched once for any amount pair (oece_rot_step):
//
//   rot_diff_decompose_kernel  for each gate b, part p and accumulator poly:
//       d_p = (X^{c_p} * acc - acc) mod Q   (c_pos = 2N - a, c_neg = a, or
//       the pair (c_pos, c_neg) given per gate)
//       -> gadget digits, int8 scratch dig[b, j*2RT + p*RT + rr*T + u]
//   int8_mm_kernel<RotAdd>     for each output tile k (128 coefficients):
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
// This design is the simple one: the mma.sync matmul of int8_mm.cuh (64
// gates x 128 columns per block, single-buffered shared memory, a register
// byte transpose of each key tile) and two launches per step.  Left on the
// table: wgmma with TMA-fed multi-stage pipelines, keeping the accumulator
// resident across steps in a persistent kernel, building the Toeplitz key
// tiles in shared memory from the compact key instead of streaming the
// 8 GB rev2 array, and capturing the step loop in a CUDA graph.

#include "int8_mm.cuh"

namespace {

// One thread per (gate b, accumulator poly pp, coefficient m): both parts'
// rotated differences and their gadget digits.  The amounts are the pair
// c_part = amt[b*2 + part] when `pair`, else (2N - a, a) for
// a = amt[b*a_stride + step].
__global__ void rot_diff_decompose_kernel(
    const int* __restrict__ acc, const int* __restrict__ amt, int a_stride,
    int step, int pair, int8_t* __restrict__ dig, int B, int N, int d_used,
    int log_bg, int shift, int Q) {
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)B * 2 * N) return;
  const int m = (int)(gid % N);
  const int pp = (int)((gid / N) & 1);
  const int b = (int)(gid / (2 * N));
  const int* poly = acc + ((long long)b * 2 + pp) * N;
  const int two_n = 2 * N;
  const int a = pair ? 0 : amt[(long long)b * a_stride + step];
  const int RT = 2 * d_used * T;
  const long long K = (long long)(N / T) * 2 * RT;
  const int x = poly[m];
  int8_t* drow = dig + b * K + (m / T) * 2 * RT + pp * d_used * T + (m % T);
  for (int part = 0; part < 2; ++part) {
    const int c = pair ? amt[(long long)b * 2 + part]
                       : part == 0 ? ((two_n - a) & (two_n - 1)) : a;
    const int cp = c & (N - 1);
    const int src = poly[(m - cp) & (N - 1)];
    const bool wrap = (m < cp) != (c >= N);
    const int rot = wrap ? (src == 0 ? 0 : Q - src) : src;
    int d = rot - x;
    if (d < 0) d += Q;
    gadget_digits(d, drow + part * RT, d_used, log_bg, shift, Q);
  }
}

// GINX epilogue: acc' = red31(acc + combined) for every gate.
struct RotAdd {
  static constexpr bool kSelect = false;
  static constexpr bool kReadsOld = true;
  static constexpr int kPolys = 2;
  __device__ int operator()(int, int old, int comb, int Q) const {
    return red31(old + comb, Q);
  }
};

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
        bufs[i & 1], (const int*)a2N, n, i, 0, (int8_t*)dig, B, N, d_used,
        log_bg, shift, Q);
    int8_mm_kernel<RotAdd><<<grid_b, THREADS, 0, s>>>(
        (const int8_t*)dig, (const int8_t*)rev2 + i * step_elems, bufs[i & 1],
        bufs[(i + 1) & 1], B, N, K, Q, RotAdd{});
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// One step for any amount pair amt int32 [B, 2] in [0, 2N) (#11): acc
// int32 [B, 2, N] -> out, which must not overlap acc (blocks of the matmul
// read the old accumulator while others write the new one).  rev2_i is the
// step's block [(2nt-1)*2RT, 8T], dig int8 scratch [B, K].
extern "C" int oece_rot_step(const void* acc, void* out, void* dig,
                             const void* rev2_i, const void* amt, int B,
                             int N, int d_used, int log_bg, int shift, int Q,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = N / T;
  const int K = nt * 2 * 2 * d_used * T;
  rot_diff_decompose_kernel<<<blocks_for((long long)B * 2 * N), 256, 0, s>>>(
      (const int*)acc, (const int*)amt, 0, 0, 1, (int8_t*)dig, B, N, d_used,
      log_bg, shift, Q);
  int8_mm_kernel<RotAdd><<<dim3((B + BM - 1) / BM, nt * 2 * (T / TT)), THREADS,
                           0, s>>>(
      (const int8_t*)dig, (const int8_t*)rev2_i, (const int*)acc, (int*)out,
      B, N, K, Q, RotAdd{});
  return (int)cudaGetLastError();
}

extern "C" const char* oece_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
