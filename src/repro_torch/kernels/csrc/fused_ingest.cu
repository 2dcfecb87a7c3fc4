// K1: fused ingest -- rolling n-gram hash -> seeded minhash min -> two-lane
// band fold, in one pass over a packed (D, L) token matrix.
//
// Replaces the Pallas kernel repro.kernels.fused_ingest.fused_ingest
// (body _fused_kernel).  On the TPU the L axis was the innermost,
// sequential grid axis and the running minimum sat in the resident output
// block; here blocks run in any order, so the L axis is a loop inside the
// block and the minimum lives in shared memory owned by one thread per seed.
//
// What bounds it on the card: integer work.  Every (document, valid
// position, seed) triple costs about ten 32-bit integer operations: the
// seed add, fmix32's two multiplies and three shift/xor pairs, and half a
// min (sm_90's three-input min takes two values at once).  Multiplies
// issue to the FMA pipe, xor and min to the ALU pipe, and adds and shifts
// may go to either, so at best the loop runs at the issue rate of four
// warp instructions per SM and clock; as compiled, the shifts sit on the
// ALU pipe, which then bounds the loop.  The bytes moved (tokens in;
// signatures, bands and validity out) take a sixth of that time at the
// memory rate.  The design keeps the pipes on useful work: each n-gram hash is
// computed once per position into shared memory and then read by every seed
// thread as a broadcast, positions past a document's valid range are never
// hashed, and the band fold reads the finished signature row from shared
// memory, so signatures cross device memory once, as output.
//
// Bits: every operation is uint32 arithmetic with wraparound, as in the
// JAX kernel.  The window of position l reads the matrix's own values up
// to column L (past a document's length too) and zeros past L; position l
// is valid iff l + n <= len, or l == 0 and 0 < len < n; a document with no
// valid position gets 0xFFFFFFFF in every signature entry.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash_common.cuh"

namespace {

using repro::fold_lane;
using repro::hash_u32;
using repro::kLaneSeed0;
using repro::kLaneSeed1;
using repro::ngram_hash;

constexpr int kThreads = 128;
// Positions per L tile: long documents (pow2-bucketed widths reach 4096
// and more) are walked tile by tile so shared memory stays small.
constexpr int kMaxTile = 1024;

// One block per document.  Shared memory: tok[tile + n - 1] (the tile's
// tokens plus the window halo), ng[tile] (n-gram hashes), sig[M].
__global__ void __launch_bounds__(kThreads) fused_ingest_kernel(
    const uint32_t* __restrict__ tokens, const int32_t* __restrict__ lengths,
    const uint32_t* __restrict__ seeds, uint32_t* __restrict__ sig,
    uint32_t* __restrict__ bands, bool* __restrict__ valid, int L, int M,
    int n, int r, int tile) {
  extern __shared__ uint32_t smem[];
  uint32_t* tok = smem;
  uint32_t* ng = tok + tile + n - 1;
  uint32_t* srow = ng + tile;

  const int64_t d = blockIdx.x;
  const uint32_t* row = tokens + d * L;
  const int len = lengths[d];
  const int nvalid = min(L, len >= n ? len - n + 1 : (len > 0 ? 1 : 0));

  bool* vrow = valid + d * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) vrow[l] = l < nvalid;
  for (int m = threadIdx.x; m < M; m += blockDim.x) srow[m] = 0xFFFFFFFFu;

  for (int l0 = 0; l0 < nvalid; l0 += tile) {
    const int nt = min(tile, nvalid - l0);
    __syncthreads();  // the previous tile's readers are done with tok/ng
    for (int i = threadIdx.x; i < nt + n - 1; i += blockDim.x) {
      const int l = l0 + i;
      tok[i] = l < L ? row[l] : 0u;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += blockDim.x)
      ng[i] = ngram_hash(tok + i, n);
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      const uint32_t s = seeds[m];
      uint32_t mn = srow[m];
      for (int i = 0; i < nt; ++i) mn = min(mn, hash_u32(ng[i], s));
      srow[m] = mn;
    }
  }
  __syncthreads();

  for (int m = threadIdx.x; m < M; m += blockDim.x) sig[d * M + m] = srow[m];
  const int b = M / r;
  for (int j = threadIdx.x; j < 2 * b; j += blockDim.x) {
    const int band = j >> 1;
    bands[(d * b + band) * 2 + (j & 1)] =
        fold_lane(srow + band * r, r, (j & 1) ? kLaneSeed1 : kLaneSeed0);
  }
}

}  // namespace

extern "C" int fused_ingest_launch(const void* tokens, const void* lengths,
                                   const void* seeds, void* sig, void* bands,
                                   void* valid, int64_t D, int L, int M, int n,
                                   int r, void* stream) {
  if (D <= 0 || D > 0x7FFFFFFF || L <= 0 || M <= 0 || n <= 0 || r <= 0 ||
      M % r != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = L < kMaxTile ? L : kMaxTile;
  const size_t smem = sizeof(uint32_t) * (2 * static_cast<size_t>(tile) + n - 1 + M);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_ingest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_ingest_kernel<<<static_cast<unsigned>(D), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tokens), static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(seeds), static_cast<uint32_t*>(sig),
      static_cast<uint32_t*>(bands), static_cast<bool*>(valid), L, M, n, r, tile);
  return static_cast<int>(cudaGetLastError());
}
