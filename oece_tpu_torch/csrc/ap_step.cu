// Binary-base AP blind rotation (B_r = 2) for Hopper (sm_90a).
//
// Replaces the TPU kernel oece_tpu/fhe/pallas_kernels.py::_ap_megakernel
// (launched by blind_rotate_ap_megakernel; phases _build_rev_body,
// _decompose_body, _matmul_body and the bit select) with three kernels per
// step, looped over the n*d_r steps on the host side of this file.  Step
// s = i*d_r + j, for gate b, with neg_a = (2N - a2N[b, i]) mod 2N:
//
//   rev_build_kernel<8>        expands step s of the compact key ap_ext
//       [R, 8, 2N] into reversed diagonals, int8 scratch
//       rev[d'*RT + r*T + u, m*T + t] = ap_ext[s, r, m, ((nt-1-d')*T + t - u) mod 2N]
//   decompose_kernel           gadget digits of the accumulator itself, int8
//       scratch dig[b, j'*RT + (poly*d_used + g)*T + u] for coefficient j'*T + u
//       (both shared with std_step.cu through int8_mm.cuh)
//   int8_mm_kernel<ApSelect>   for each output tile k: P = dig x rev, the
//       limb combine mod Q, then acc' = bit(b) ? P : acc with
//       bit(b) = (neg_a >> j) & 1.  P replaces acc: no sum, no red31.
//
// The accumulator ping-pongs between two buffers (blocks whose gates keep
// their old value read it while other blocks write), and stream order puts
// each step's build and digits before its matmul.  The TPU kernel's lane
// permutation is not carried over: the port works in true coefficient order.
//
// Bounds on the H100.  One step is an external product against a key that
// every gate shares: nt * (nt*R*T) * 8T = 33.6 M int8 MACs per gate at
// STD128_OPT (nt = 8, R = 4, K = nt*R*T = 4096), 185 G MAC per bootstrap
// over 5,522 steps, 5.5x GINX.  |sum| <= K * 128 * 128 = 2**26, exact in
// int32.  The build writes a 7.86 MB block per step whatever the batch
// (43 GB per rotation; the block fits the 50 MB L2), so the matmul bounds
// the step: its latency floor at circuit batch sizes, its mma.sync issue
// rate at large batches.  Measured on an H100 80GB HBM3 at 700 W: build
// 6.8 us, digits 1.4-13.5 us and matmul 53-246 us per step from 4 to 1024
// gates, so the build is 11% of a 4-lane step and 2.6% of a 1024-gate one.
//
// This design is the simple one.  Left undone: building the Toeplitz key
// tiles in shared memory straight from the 64 KB-per-step compact key
// (no 7.86 MB block, no build launch), wgmma with TMA-fed stages, a
// persistent kernel that keeps the accumulator resident across steps, and
// capturing the step loop in a CUDA graph.

#include "int8_mm.cuh"

namespace {

// AP epilogue: gate b takes the product where digit j of its -a_i is 1
// and keeps its accumulator where it is 0 (the identity rotation).
struct ApSelect {
  static constexpr bool kSelect = true;
  static constexpr bool kReadsOld = true;
  static constexpr int kPolys = 2;
  const int* a2N;
  int n, i, j, two_n;
  __device__ bool live(int b) const {
    const int neg_a = (two_n - a2N[(long long)b * n + i]) & (two_n - 1);
    return (neg_a >> j) & 1;
  }
  __device__ int operator()(int b, int old, int comb, int) const {
    return live(b) ? comb : old;
  }
};

}  // namespace

// The whole rotation: n*d_r steps of (build, decompose, matmul).  acc0
// holds the initial accumulator; step s reads buffer s%2 and writes buffer
// (s+1)%2, so the result is in buffer (n*d_r)%2.  dig is int8 scratch
// [B, nt*R*T], rev int8 scratch [(2nt-1)*R*T, 8T], ap_ext int8
// [n*d_r, R, 8, 2N], a2N int32 [B, n].  Returns 0 or the first
// cudaError_t of a launch.
extern "C" int oece_blind_rotate_ap(void* acc0, void* acc1, void* dig,
                                    void* rev, const void* ap_ext,
                                    const void* a2N, int B, int n, int d_r,
                                    int N, int d_used, int log_bg, int shift,
                                    int Q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = N / T;
  const int R = 2 * d_used;
  const int K = nt * R * T;
  const long long ext_elems = (long long)R * 8 * 2 * N;
  const int blocks_build = blocks_for((long long)(2 * nt - 1) * R * T * (8 * T / 16));
  const int blocks_dec = blocks_for((long long)B * 2 * N);
  const dim3 grid_mm((B + BM - 1) / BM, nt * 2 * (T / TT));
  int* bufs[2] = {(int*)acc0, (int*)acc1};
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < d_r; ++j) {
      const int s = i * d_r + j;
      rev_build_kernel<8><<<blocks_build, 256, 0, st>>>(
          (const int8_t*)ap_ext + s * ext_elems, (int8_t*)rev, N, R);
      decompose_kernel<<<blocks_dec, 256, 0, st>>>(
          bufs[s & 1], (int8_t*)dig, B, N, d_used, log_bg, shift, Q);
      int8_mm_kernel<ApSelect><<<grid_mm, THREADS, 0, st>>>(
          (const int8_t*)dig, (const int8_t*)rev, bufs[s & 1],
          bufs[(s + 1) & 1], B, N, K, Q,
          ApSelect{(const int*)a2N, n, i, j, 2 * N});
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}
