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
//      rev_build_kernel<M, true> from ext: one block per (plane m, digit
//      row r, diagonal d') stages the 255 key-row bytes its 128 row
//      segments share with 16-byte loads, cuts 64-byte windows from them by
//      funnel shifts and writes each 16-byte store as byte j of 16 window
//      words (4 x 4 byte transposes, int8_mm.cuh); rev_build_kernel<M>
//      (the same entry, conj = 0) is #1 on its own, the windows stored as
//      they are.
//   #2 _window_matmul_kernel (window_matmul_pallas): #8's function (the
//      limb combine mod Q fused) on a row-major block.  Here
//      transpose_kernel writes the block K-major into the wrapper's
//      scratch, as for #3, and rev_step.cu's #8 (oece_rev_window_matmul:
//      its split wgmma GEMM up to 16 gates, the tiled one above) reads it
//      by TMA.  Both launches are one #2 call.  Tried and left out: #8's
//      GEMMs making their key tiles in shared memory from TMA boxes of the
//      row-major block, in one launch.  They took 12.2-12.5 us against
//      14.7-14.9 at B = 4, but 0.331-0.334 ms against 0.221-0.222 at
//      B = 2048, where every 256-gate tile made the same key tiles again
//      beside the MMAs' own shared-memory traffic (chip_smoke.py
//      neg-kernel, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// #6 (_cmux_epilogue_kernel) is, in true column order, #10's function: it
// launches oece_cmux_epilogue_true of std_step.cu.
//
// Bounds on the H100 at STD128_OPT (N = 1024, R = 4, M = 16): #3 and #5
// contract 67.1 M int8 MACs per gate, 139 us at B = 2048 at the 1,979 TOPS
// int8 peak; their int32 output is 64 KB per gate (4x the combined
// output), 134 MB at B = 2048, 40 us of HBM: operations bound.  #3's
// transpose moves 15.7 MB each way (9.4 us); at 4-8 gates both are bound
// by the GEMM's latency (PERF.md).  #2 contracts as many MACs and writes a
// quarter of #3's output (0.139 ms at B = 2048); at B = 4 its bound is the
// block's bytes, read once (4.7 us), which the transpose writes and the
// GEMM reads again.  #7 reads 131 KB and writes the 15.7 MB block: bytes
// bound (4.73 us), as #1.

#include "int8_mm.cuh"
#include "wgmma_mm.cuh"

namespace {

template <int M>
void build(const void* ext, void* rev, int N, int R, int conj, cudaStream_t st) {
  const int blocks = M * R * (2 * (N / T) - 1);
  if (conj) {
    rev_build_kernel<M, true><<<blocks, 256, 0, st>>>((const int8_t*)ext, (int8_t*)rev, N, R);
  } else {
    rev_build_kernel<M><<<blocks, 256, 0, st>>>((const int8_t*)ext, (int8_t*)rev, N, R);
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

// #8 alone (rev_step.cu).
extern "C" int oece_rev_window_matmul(const void* dig, const void* blockT, void* out, int B, int nb,
                                      int N, int R, int polys, int Q, void* stream);

// #2: dig int8 [B, nt*R*T] x one step's row-major block int8
// [(2nt-1)*R*T, 4*polys*T] -> out int32 [B, polys, N] mod Q in two
// launches: the block transposed into blockT (scratch of its size, K-major
// [4*polys, T, rows]), then #8 on it with the GEMM of gate tile nb.
extern "C" int oece_window_matmul(const void* dig, const void* block, void* blockT, void* out, int B,
                                  int nb, int N, int R, int polys, int Q, void* stream) {
  if (polys != 4 && polys != 2) return (int)cudaErrorInvalidValue;
  const int rows = (2 * (N / T) - 1) * R * T, cols = 4 * polys * T;
  wgmm::transpose_kernel<<<dim3(cols / 128, rows / 128), 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)block, (int8_t*)blockT, rows, cols);
  const int rc = check_launch();
  return rc ? rc : oece_rev_window_matmul(dig, blockT, out, B, nb, N, R, polys, Q, stream);
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
