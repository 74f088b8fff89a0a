// The kernel-level negacyclic products and builds of
// oece_tpu/fhe/pallas_kernels.py that the JAX package's tests and its step
// profiler (tools/profile_boot.py) reach, for Hopper (sm_90a).  Each
// replaces one TPU kernel (T = 128, nt = N/T, R digit rows, M = 16 or 8
// planes (part, out, limb) with the limb minor, P = M/4):
//
//   #3 _diag_matmul_kernel (diag_matmul_pallas): digits x the prebuilt
//      diagonal blocks, the raw limb sums with no combine.  Here
//      int8_mm_kernel<RawStore<P>, BlockKey> on the reversed-diagonal block
//      int8 [(2nt-1)*R*T, M*T] that #1 builds (keys.rev_block), writing
//      int32 out[b, m, k*T + t] of [B, M, N] in true column order (the TPU
//      kernel wrote plane-permuted columns that its pipeline un-permuted).
//   #5 _negacyclic_kernel (negacyclic_matmul_pallas): the same raw product,
//      each key tile built on the fly from the compact key (the TPU barrel
//      shifted byte-phase windows in VMEM).  Here
//      int8_mm_kernel<RawStore<P>, ExtKey>: the tile loader gathers every
//      key word straight from one step's ext int8 [R, M, 2N] (128 KB at
//      STD128_OPT, L2-resident), so no block exists in memory.
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
// output), 134 MB at B = 2048, 40 us of HBM: operations bound.  At 4-8
// gates #3 reads its 15.7 MB block from HBM (4.7 us) and #5 only 128 KB,
// but both are bound by the matmul's latency floor (PERF.md).  #7 writes
// the 15.7 MB block: bytes bound, as #1.  The design is the simple one:
// the shared mma.sync core of int8_mm.cuh, a 4-byte funnel shift of three
// aligned words per 4 x 4 key bytes in ExtKey, a byte gather in the build.

#include "int8_mm.cuh"

namespace {

// #3's and #5's epilogue: the limb sums as they are.
template <int P>
struct RawStore {
  static constexpr bool kSelect = false;
  static constexpr bool kReadsOld = false;
  static constexpr bool kRaw = true;
  static constexpr int kPolys = P;
};

// dig int8 [B, nt*R*T] x key (a block, or ext) -> out int32 [B, 4P, N].
template <int P, class KeySrc>
void raw_matmul(const void* dig, const void* key, void* out, int B, int N,
                int R, cudaStream_t st) {
  const int nt = N / T;
  const dim3 grid((B + BM - 1) / BM, nt * P * (T / TT));
  int8_mm_kernel<RawStore<P>, KeySrc><<<grid, THREADS, 0, st>>>(
      (const int8_t*)dig, (const int8_t*)key, nullptr, (int*)out, B, N,
      nt * R * T, 0, RawStore<P>{});
}

template <class KeySrc>
int raw_matmul_planes(const void* dig, const void* key, void* out, int B,
                      int N, int R, int planes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (planes == 16) {
    raw_matmul<4, KeySrc>(dig, key, out, B, N, R, st);
  } else if (planes == 8) {
    raw_matmul<2, KeySrc>(dig, key, out, B, N, R, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return check_launch();
}

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
// int32 [B, planes, N], planes = 16 or 8.  Returns 0 or a cudaError_t.
extern "C" int oece_diag_matmul(const void* dig, const void* block, void* out,
                                int B, int N, int R, int planes,
                                void* stream) {
  return raw_matmul_planes<BlockKey>(dig, block, out, B, N, R, planes, stream);
}

// #5: dig int8 [B, nt*R*T] x the negacyclic product of one step's compact
// key ext int8 [R, planes, 2N] -> out int32 [B, planes, N].
extern "C" int oece_negacyclic_matmul(const void* dig, const void* ext,
                                      void* out, int B, int N, int R,
                                      int planes, void* stream) {
  return raw_matmul_planes<ExtKey>(dig, ext, out, B, N, R, planes, stream);
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
