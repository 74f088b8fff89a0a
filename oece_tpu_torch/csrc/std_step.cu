// The row-major matmul (#2) and the CMUX epilogue alone (#10, #6) of the
// GINX standard form, for Hopper (sm_90a).
//
// Replaces, on the kernel-level API of fhe/negacyclic.py and fhe/rev.py,
// the TPU kernels of oece_tpu/fhe/pallas_kernels.py:
//   #2 _window_matmul_kernel (window_matmul_pallas; negacyclic.window_matmul
//      through rev.window_matmul_counted): digits x one step's row-major
//      reversed-diagonal block with the Horner combine of the 4 key limbs
//      fused, M = 16 or 8 planes;
//   #10 _cmux_epilogue_true_kernel alone (rev.cmux_epilogue_true) and #6
//      _cmux_epilogue_kernel (negacyclic.cmux_epilogue): the rotations and
//      the CMUX add for any amount pair.
// The step loops run elsewhere: the standard form on ginx_ext (#1, #4) and
// on prebuilt rev blocks (#8, #9, #10's CMUX) in rev_step.cu, on its
// K-major blocks and wgmma GEMMs.  T = 128, nt = N/T, R = 2*d_used, RT =
// R*T:
//
//   int8_mm_kernel<P>  (P = 4 or 2) for each output tile k, the
//       contraction of K = nt*RT digits dig[b, j*RT + (poly*d_used + g)*T
//       + u] against rows [(nt-1-k)*RT, +K) of the block
//       rev[d'*RT + r*T + u, m*T + t], the limb combine mod Q, written as
//       out[b, o, k*T + t] in [0, Q).
//   std_cmux_kernel  out <- red31(acc + X^c0 P0 + X^c1 P1 + 2Q - P0 - P1)
//       for P [B, 2, 2, N] and amount pairs (c0, c1) in [0, 2N); each sum
//       is below 5Q < 2**31.  A gate with (c0, c1) = (2N - a, a), a = 0,
//       gets acc back unchanged.
//
// Bounds on the H100.  The matmul contracts nt * K * 16T = 67.1 M int8
// MACs per gate at STD128_OPT: at B = 2048, 275 G ops, 139 us at the
// 1,979 TOPS int8 peak, so it is tensor-core bound at large batches (its
// mma.sync issue rate); at 4-8 gates it is bound by the 15.7 MB block it
// reads (4.7 us).  The epilogue moves 4 ints per gate and coefficient (50
// MB at B = 2048, 15 us).
// Left undone: the row-major matmul on wgmma (the step loops read K-major
// blocks instead).

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

// The matmul on one row-major block: digits dig [B, nt*R*T] x block
// [(2nt-1)*R*T, 4P*T] -> out [B, P, N] mod Q.
template <int P>
void window_matmul(const void* dig, const void* block, void* out, int B,
                   int N, int R, int Q, cudaStream_t st) {
  const int nt = N / T;
  const dim3 grid((B + BM - 1) / BM, nt * P * (T / TT));
  int8_mm_kernel<P><<<grid, THREADS, 0, st>>>(
      (const int8_t*)dig, (const int8_t*)block, (int*)out, B, N, nt * R * T, Q);
}

}  // namespace

// #2 (#8's function on a row-major block): dig int8 [B, nt*R*T] x block
// int8 [(2nt-1)*R*T, 4*polys*T] -> out int32 [B, polys, N] mod Q, polys =
// 4 (M = 16) or 2 (M = 8).
extern "C" int oece_window_matmul_true(const void* dig, const void* block,
                                       void* out, int B, int N, int R,
                                       int polys, int Q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (polys == 4) {
    window_matmul<4>(dig, block, out, B, N, R, Q, st);
  } else if (polys == 2) {
    window_matmul<2>(dig, block, out, B, N, R, Q, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return check_launch();
}

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
