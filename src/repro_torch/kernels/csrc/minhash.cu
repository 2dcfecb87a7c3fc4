// K4: minhash signatures -- sig[d, m] = min over the valid positions l of
// hash_u32(ng[d, l], seed[m]), or 0xFFFFFFFF where a row has none.
//
// Replaces the Pallas kernel repro.kernels.minhash.minhash_signatures (body
// _minhash_kernel).  On the TPU the L axis was the innermost, sequential
// grid axis and the running minimum sat in the resident (TD, TM) output
// block.  Here blocks run in any order, so each document is one block, the
// L axis is a loop over tiles inside it, and each thread keeps the minimum
// of its own seeds (m = thread, thread + 128, ...; any M) in shared memory.
//
// What bounds it on the card: integer work, as in K1.  Each (document,
// valid position, seed) triple costs the seed add, fmix32 and half a
// three-input min; the bytes (hashes and mask in, signatures out) take a
// small share of that time.  The mask is any mask, not a prefix of the row,
// so the design compacts each tile's valid hashes into shared memory first
// (one ballot and one shared atomic per warp), and the seed threads then
// run their min loop over valid hashes only, read as broadcasts.  The
// minimum does not depend on the order the compaction gives.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTile = 1024;

// One block per document.  Shared memory: buf[tile] (the tile's valid
// hashes, compacted), srow[M] (running minima), count (buf's fill).
__global__ void __launch_bounds__(kThreads) minhash_kernel(
    const uint32_t* __restrict__ ngrams, const bool* __restrict__ valid,
    const uint32_t* __restrict__ seeds, uint32_t* __restrict__ sig, int L,
    int M, int tile) {
  extern __shared__ uint32_t smem[];
  uint32_t* buf = smem;
  uint32_t* srow = buf + tile;
  int& count = *reinterpret_cast<int*>(srow + M);

  const int64_t d = blockIdx.x;
  const uint32_t* nrow = ngrams + d * L;
  const bool* vrow = valid + d * L;
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x; m < M; m += blockDim.x) srow[m] = 0xFFFFFFFFu;

  for (int l0 = 0; l0 < L; l0 += tile) {
    const int nt = min(tile, L - l0);
    __syncthreads();  // the previous tile's readers are done with buf, count
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    // Every thread takes the same number of steps, so whole warps vote.
    for (int i0 = 0; i0 < nt; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      const bool v = i < nt && vrow[l0 + i];
      const unsigned vote = __ballot_sync(0xFFFFFFFFu, v);
      int base = 0;
      if (lane == 0 && vote != 0u) base = atomicAdd(&count, __popc(vote));
      base = __shfl_sync(0xFFFFFFFFu, base, 0);
      if (v) buf[base + __popc(vote & ((1u << lane) - 1u))] = nrow[l0 + i];
    }
    __syncthreads();
    const int nv = count;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      const uint32_t s = seeds[m];
      uint32_t mn = srow[m];
      for (int j = 0; j < nv; ++j) mn = min(mn, repro::hash_u32(buf[j], s));
      srow[m] = mn;
    }
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) sig[d * M + m] = srow[m];
}

}  // namespace

extern "C" int minhash_launch(const void* ngrams, const void* valid,
                              const void* seeds, void* sig, int64_t D, int L,
                              int M, void* stream) {
  if (D <= 0 || D > 0x7FFFFFFF || L <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = L < kMaxTile ? L : kMaxTile;
  const size_t smem = sizeof(uint32_t) * (static_cast<size_t>(tile) + M + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        minhash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  minhash_kernel<<<static_cast<unsigned>(D), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ngrams), static_cast<const bool*>(valid),
      static_cast<const uint32_t*>(seeds), static_cast<uint32_t*>(sig), L, M,
      tile);
  return static_cast<int>(cudaGetLastError());
}
