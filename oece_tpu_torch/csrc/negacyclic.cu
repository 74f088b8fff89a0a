// The kernel-level negacyclic products and builds of
// oece_tpu/fhe/pallas_kernels.py that the JAX package's tests and its step
// profiler (tools/profile_boot.py) reach, for Hopper (sm_90a).  Each
// replaces one TPU kernel (T = 128, nt = N/T, R digit rows, M = 16 or 8
// planes (part, out, limb) with the limb minor, P = M/4):
//
//   #3 _diag_matmul_kernel (diag_matmul_pallas): digits x the prebuilt
//      diagonal blocks, the raw limb sums with no combine.  Here the
//      reversed-diagonal block int8 [(2nt-1)*R*T, M*T] that #1 builds
//      (keys.rev_block) is transposed to K-major blockT (transpose_kernel,
//      into the wrapper's scratch), then wgmma_mm.cuh's raw_gemm_kernel
//      reads it by TMA, writing int32 out[b, m, k*T + t] of [B, M, N] in
//      true column order (the TPU kernel wrote plane-permuted columns that
//      its pipeline un-permuted).  Both launches are one #3 call.
//   #5 _negacyclic_kernel (negacyclic_matmul_pallas): the same raw product,
//      each key tile built on the fly from the compact key (the TPU barrel
//      shifted byte-phase windows in VMEM).  Here phase_expand_kernel
//      writes 32 shifted copies of the reversed planes of one step's ext
//      int8 [R, M, 2N] (4.5 MB at STD128_OPT, L2-resident), in which the
//      windows of 32 consecutive columns are one TMA box, and
//      raw_gemm_kernel reads the key tiles from them, so no block exists
//      in memory.  Both launches are one #5 call.
//   #7 _build_rev_kernel (build_rev_pallas): byte-phase windows -> the
//      reversed diagonals in the conjugated basis (rows and columns of
//      each 128 x 128 tile in the TPU's byte-plane order).  Here
//      rev_build_kernel<M, true> from ext; rev_build_kernel<M> (the same
//      entry, conj = 0) is #1 on its own.
// #2 (_window_matmul_kernel) and #6 (_cmux_epilogue_kernel) are, in true
// column order, the functions of #8 and #10: they launch
// oece_window_matmul_true and oece_cmux_epilogue_true of std_step.cu.
//
// Bounds on the H100 at STD128_OPT (N = 1024, R = 4, M = 16): #3 and #5
// contract 67.1 M int8 MACs per gate, 139 us at B = 2048 at the 1,979 TOPS
// int8 peak; their int32 output is 64 KB per gate (4x the combined
// output), 134 MB at B = 2048, 40 us of HBM: operations bound.  #3's
// transpose moves 15.7 MB each way (9.4 us); at 4-8 gates both are bound
// by the GEMM's latency (PERF.md).  #7 writes the 15.7 MB block: bytes
// bound, as #1, with a byte gather.

#include "int8_mm.cuh"
#include "wgmma_mm.cuh"

namespace {

template <int M>
void build(const void* ext, void* rev, int N, int R, int conj,
           cudaStream_t st) {
  const long long threads = (long long)(2 * (N / T) - 1) * R * T * (M * T / 16);
  if (conj) {
    rev_build_kernel<M, true><<<blocks_for(threads), 256, 0, st>>>(
        (const int8_t*)ext, (int8_t*)rev, N, R);
  } else {
    rev_build_kernel<M><<<blocks_for(threads), 256, 0, st>>>(
        (const int8_t*)ext, (int8_t*)rev, N, R);
  }
}

}  // namespace

// #3: dig int8 [B, nt*R*T] x block int8 [(2nt-1)*R*T, planes*T] -> out
// int32 [B, planes, N], planes = 16 or 8; blockT is scratch of the block's
// size.  Returns 0 or the first cudaError_t.
extern "C" int oece_diag_matmul(const void* dig, const void* block, void* blockT, void* out,
                                int B, int N, int R, int planes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (planes != 16 && planes != 8) return (int)cudaErrorInvalidValue;
  const int rows = (2 * (N / T) - 1) * R * T, cols = planes * T;
  wgmm::transpose_kernel<<<dim3(cols / 128, rows / 128), 256, 0, st>>>(
      (const int8_t*)block, (int8_t*)blockT, rows, cols);
  const int rc = check_launch();
  return rc ? rc : wgmm::raw_gemm<false>(dig, blockT, out, B, N, R, planes, st);
}

// #5: dig int8 [B, nt*R*T] x the negacyclic product of one step's compact
// key ext int8 [R, planes, 2N] -> out int32 [B, planes, N]; phase is
// scratch int8 [R, planes, 32, 2N + 128].
extern "C" int oece_negacyclic_matmul(const void* dig, const void* ext, void* phase, void* out,
                                      int B, int N, int R, int planes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (planes != 16 && planes != 8) return (int)cudaErrorInvalidValue;
  wgmm::phase_expand_kernel<<<blocks_for((long long)R * planes * wgmm::V * (2 * N + T) / 16), 256,
                                0, st>>>(
      (const int8_t*)ext, (int8_t*)phase, R * planes, 2 * N);
  const int rc = check_launch();
  return rc ? rc : wgmm::raw_gemm<true>(dig, phase, out, B, N, R, planes, st);
}

// #1 (conj = 0) or #7 (conj = 1): ext int8 [R, planes, 2N] -> rev int8
// [(2nt-1)*R*T, planes*T], in true order or in the conjugated basis.
extern "C" int oece_build_rev(const void* ext, void* rev, int N, int R,
                              int planes, int conj, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (planes == 16) {
    build<16>(ext, rev, N, R, conj, st);
  } else if (planes == 8) {
    build<8>(ext, rev, N, R, conj, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return check_launch();
}
