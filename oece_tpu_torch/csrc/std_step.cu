// GINX blind rotation, standard (non-rotated) form, for Hopper (sm_90a),
// on keys expanded per step (ginx_ext).
//
// Replaces, on the host-key GINX path of oece_tpu/fhe/boot.py
// (_external_cmux_pallas, one lax.scan step per key step), the TPU kernels
// of oece_tpu/fhe/pallas_kernels.py:
//   #1 _build_diag_kernel (build_diagonals_pallas): byte-phase key windows
//      -> the step's 2nt-1 dense negacyclic diagonal blocks;
//   #4 _diag_matmul_combine_kernel (diag_matmul_combine_pallas): digits x
//      diagonal blocks with the Horner combine of the 4 key limbs fused;
// and the jnp epilogue around them (boot.py:358-363).  Its matmul also
// serves #2 (negacyclic.window_matmul: #8's function on a row-major block)
// and its epilogue #10 alone (_cmux_epilogue_true_kernel,
// rev.cmux_epilogue_true: the rotations and the CMUX add for any amount
// pair) and #6; the device-key path of OECE_LAYOUT=rev (#8, #9 and the
// CMUX inside its step loop) runs on rev_step.cu's wgmma GEMMs over a
// K-major key instead.
// For each step i and gate b, with a = a2N[b, i] (T = 128, nt = N/T,
// R = 2*d_used, RT = R*T):
//
//   rev_build_kernel<16>  (#1; ginx_ext only) expands ginx_ext[i] [R, 16, 2N]
//       (plane (part*2 + out)*4 + limb, over v then -v mod Q) into int8
//       scratch
//       rev[d'*RT + r*T + u, m*T + t] = ginx_ext[i, r, m, ((nt-1-d')*T + t - u) mod 2N]
//       [(2nt-1)*RT, 16T]: the block that the rev key holds for step i.
//       The port writes true column order and the reversed diagonal order
//       (rev[d'] = dense[2nt-2-d']) that the matmul reads; the TPU kernel
//       wrote forward order with plane-permuted columns (byte j of word w
//       at column 32j + w), undone only on the combined output
//       (pallas_kernels.py:401-402).
//   decompose_kernel      gadget digits of the accumulator, int8 scratch
//       dig[b, j*RT + (poly*d_used + g)*T + u] for coefficient j*T + u.
//   int8_mm_kernel<4>     (#4; #2 with <2> too) for each output tile k, the
//       contraction of K = nt*RT digits against rows [(nt-1-k)*RT, +K) of
//       the block, the limb combine mod Q, written as
//       P4[b, part*2 + out, k*T + t] in [0, Q).
//   std_cmux_kernel       acc <- red31(acc + X^c0 P0 + X^c1 P1 + 2Q - P0 - P1)
//       where P_part = P4[b, part, :, :] and (c0, c1) = (2N - a, a); each
//       sum is below 5Q < 2**31.  A gate with a = 0 gets acc back unchanged
//       (golden skips that step).
//
// Bounds on the H100.  A step contracts nt * K * 16T = 67.1 M int8 MACs per
// gate at STD128_OPT (nt = 8, K = 4,096), the same as a rotated-form step:
// at B = 2048, 275 G ops, 139 us at the 1,979 TOPS int8 peak, so the matmul
// is tensor-core bound at large batches (its mma.sync issue rate).  The
// build writes a 15.7 MB block per step whatever the batch (4.7 us of HBM
// bandwidth; the block fits the 50 MB L2, where the matmul then finds
// it).  The epilogue moves 4 ints per gate and coefficient (50 MB at B = 2048,
// 15 us).  At circuit batches (4-8 gates) the matmul grid has 128 blocks
// (nt * 4 polys * 4 column chunks) walking K = 4,096, against 64 blocks
// walking 8,192 for rot_step.
//
// The design is the simple one: four launches per step, the
// step loop on the host side of this file, scratch allocated by the
// wrapper.  The accumulator is updated in place by the epilogue (each
// thread reads and writes only its own element; the rotations read P4).
// Left undone: the key tiles gathered from the 131 KB compact key inside
// the matmul (as negacyclic.cu's #5 does with byte-phase copies) in
// place of the build and its block, wgmma with TMA-fed stages (#3 and #5
// have them, wgmma_mm.cuh), the
// epilogue fused into the matmul (it needs whole rows of P4: a rotation
// crosses tiles), and a CUDA graph of the step loop.

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

// One thread per (gate b, out poly o, coefficient m).  The amounts are the
// pair (c0, c1) = amt[b*2 + 0], amt[b*2 + 1] when `pair`, else (2N - a, a)
// for a = amt[b*a_stride + step].  acc_out may be acc_in (in place): a
// thread reads and writes only its own element of the accumulator.
__global__ void std_cmux_kernel(const int* acc_in, int* acc_out,
                                const int* __restrict__ P4,
                                const int* __restrict__ amt, int a_stride,
                                int step, int pair, int B, int N, int Q) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)B * 2 * N) return;
  const int m = (int)(gid % N);
  const int o = (int)((gid / N) & 1);
  const long long b = gid / (2 * N);
  const int two_n = 2 * N;
  int c0, c1;
  if (pair) {
    c0 = amt[b * 2];
    c1 = amt[b * 2 + 1];
  } else {
    c1 = amt[b * a_stride + step];
    c0 = (two_n - c1) & (two_n - 1);
  }
  const int* p0 = P4 + ((b * 2 + 0) * 2 + o) * N;
  const int* p1 = P4 + ((b * 2 + 1) * 2 + o) * N;
  int y = acc_in[gid] + 2 * Q;
  y += rotated(p0, c0, m, N, Q) - p0[m];
  y += rotated(p1, c1, m, N, Q) - p1[m];
  acc_out[gid] = red31(y, Q);
}

// The matmul on one row-major block (#4; #2): digits dig [B, nt*R*T] x
// block [(2nt-1)*R*T, 4P*T] -> out [B, P, N] mod Q.
template <int P>
void window_matmul(const void* dig, const void* block, void* out, int B,
                   int N, int R, int Q, cudaStream_t st) {
  const int nt = N / T;
  const dim3 grid((B + BM - 1) / BM, nt * P * (T / TT));
  int8_mm_kernel<P><<<grid, THREADS, 0, st>>>(
      (const int8_t*)dig, (const int8_t*)block, (int*)out, B, N, nt * R * T, Q);
}

// One step after the block is in place: digits, #4 (P4 [B, 4, N]), then the
// CMUX epilogue on acc in place, with a = a2N[b*n + i].
void prebuilt_step(void* acc, void* dig, const void* block, void* P4,
                   const void* a2N, int i, int B, int n, int N, int d_used,
                   int log_bg, int shift, int Q, cudaStream_t st) {
  const int blocks_acc = blocks_for((long long)B * 2 * N);
  decompose_kernel<<<blocks_acc, 256, 0, st>>>(
      (const int*)acc, (int8_t*)dig, B, N, d_used, log_bg, shift, Q);
  window_matmul<4>(dig, block, P4, B, N, 2 * d_used, Q, st);
  std_cmux_kernel<<<blocks_acc, 256, 0, st>>>(
      (const int*)acc, (int*)acc, (const int*)P4, (const int*)a2N, n, i, 0,
      B, N, Q);
}

}  // namespace

// The whole rotation on ginx_ext: n steps of (build, decompose, matmul,
// epilogue), the accumulator acc int32 [B, 2, N] updated in place.  dig is
// int8 scratch [B, nt*R*T], rev int8 scratch [(2nt-1)*R*T, 16T], P4 int32
// scratch [B, 4, N], ginx_ext int8 [n, R, 16, 2N], a2N int32 [B, n].
// Returns 0 or the first cudaError_t of a launch.
extern "C" int oece_blind_rotate_std(void* acc, void* dig, void* rev, void* P4,
                                     const void* ginx_ext, const void* a2N,
                                     int B, int n, int N, int d_used,
                                     int log_bg, int shift, int Q,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = N / T;
  const int R = 2 * d_used;
  const long long ext_elems = (long long)R * 16 * 2 * N;
  const int blocks_build = blocks_for((long long)(2 * nt - 1) * R * T * (16 * T / 16));
  for (int i = 0; i < n; ++i) {
    rev_build_kernel<16><<<blocks_build, 256, 0, st>>>(
        (const int8_t*)ginx_ext + i * ext_elems, (int8_t*)rev, N, R);
    prebuilt_step(acc, dig, rev, P4, a2N, i, B, n, N, d_used, log_bg, shift,
                  Q, st);
    const int e = check_launch();
    if (e != 0) return e;
  }
  return 0;
}

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
      (const int*)acc, (int*)out, (const int*)P, (const int*)amt, 0, 0, 1, B,
      N, Q);
  return check_launch();
}
