// The CMUX epilogue alone (#10, #6) of the GINX standard form, for Hopper
// (sm_90a).
//
// Replaces, on the kernel-level API of fhe/negacyclic.py and fhe/rev.py,
// the TPU kernels of oece_tpu/fhe/pallas_kernels.py
// #10 _cmux_epilogue_true_kernel alone (rev.cmux_epilogue_true) and #6
// _cmux_epilogue_kernel (negacyclic.cmux_epilogue): the rotations and the
// CMUX add for any amount pair.  The step loops run elsewhere: the
// standard form on ginx_ext (#1, #4) and on prebuilt rev blocks (#8, #9,
// #10's CMUX) in rev_step.cu, on its K-major blocks and wgmma GEMMs, which
// also run #2 once transpose_kernel has made its row-major block K-major
// (negacyclic.cu).  T = 128, nt = N/T:
//
//   std_cmux_kernel  out <- red31(acc + X^c0 P0 + X^c1 P1 + 2Q - P0 - P1)
//       for P [B, 2, 2, N] and amount pairs (c0, c1) in [0, 2N); each sum
//       is below 5Q < 2**31.  A gate with (c0, c1) = (2N - a, a), a = 0,
//       gets acc back unchanged.
//
// Bound on the H100: it moves 4 ints per gate and coefficient (50 MB at
// B = 2048, 15 us).

#include "int8_mm.cuh"

namespace {

// P(X) * X^c at coefficient m, c in [0, 2N): a cyclic rotation by c mod N
// and the negacyclic sign (boot.monomial_rotate).
__device__ __forceinline__ int rotated(const int* __restrict__ poly, int c,
                                       int m, int N, int Q) {
  const int cp = c & (N - 1);
  const int src = poly[(m - cp) & (N - 1)];
  const bool wrap = (m < cp) != (c >= N);
  return wrap ? (src == 0 ? 0 : Q - src) : src;
}

// One thread per (gate b, out poly o, coefficient m), amounts (c0, c1) =
// amt[b*2 + 0], amt[b*2 + 1].
__global__ void std_cmux_kernel(const int* acc_in, int* acc_out,
                                const int* __restrict__ P4,
                                const int* __restrict__ amt, int B, int N, int Q) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)B * 2 * N) return;
  const int m = (int)(gid % N);
  const int o = (int)((gid / N) & 1);
  const long long b = gid / (2 * N);
  const int c0 = amt[b * 2], c1 = amt[b * 2 + 1];
  const int* p0 = P4 + ((b * 2 + 0) * 2 + o) * N;
  const int* p1 = P4 + ((b * 2 + 1) * 2 + o) * N;
  int y = acc_in[gid] + 2 * Q;
  y += rotated(p0, c0, m, N, Q) - p0[m];
  y += rotated(p1, c1, m, N, Q) - p1[m];
  acc_out[gid] = red31(y, Q);
}

}  // namespace

// #10 alone: out = red31(acc + X^amt0 P0 + X^amt1 P1 + 2Q - P0 - P1) for P
// int32 [B, 2, 2, N] in [0, Q), acc [B, 2, N], amt int32 [B, 2] in [0, 2N).
extern "C" int oece_cmux_epilogue_true(const void* P, const void* acc,
                                       const void* amt, void* out, int B,
                                       int N, int Q, void* stream) {
  std_cmux_kernel<<<blocks_for((long long)B * 2 * N), 256, 0,
                    (cudaStream_t)stream>>>(
      (const int*)acc, (int*)out, (const int*)P, (const int*)amt, B, N, Q);
  return check_launch();
}
