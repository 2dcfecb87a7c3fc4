// K4: minhash signatures -- sig[d, m] = min over the valid positions l of
// hash_u32(ng[d, l], seed[m]), or 0xFFFFFFFF where a row has none.
//
// Replaces the Pallas kernel repro.kernels.minhash.minhash_signatures (body
// _minhash_kernel).  On the TPU the L axis was the innermost, sequential
// grid axis and the running minimum sat in the resident (TD, TM) output
// block; here blocks run in any order, so the L axis is a loop inside the
// block and the running minima live in registers, then in shared memory.
//
// What bounds it on the card: integer work, as in K1.  Each (document,
// valid position, seed) triple costs the seed add, fmix32 and half a
// three-input min; the bytes (hashes and mask in, signatures out) take a
// small share of that time.  The min loop is K1's (minhash_pool_common.cuh:
// S seeds a lane in registers, lane groups sized to M, several rows a block
// sharing one pool of hashes, 16-byte broadcast reads), so K4 differs from
// K1 only in how it fills the pool.  The mask is any mask, not a prefix of
// the row, so each round compacts the rows' valid hashes into the pool:
//
//   * A thread takes cells of four columns of a row (at most kCells a
//     round): one 4-byte load of the four flags and, where any is set, one
//     16-byte load of the four hashes, every load of the round issued
//     before the first barrier.
//   * Each warp counts its cells' valid positions a row at a time (lanes
//     of one row found by __match_any_sync, their counts summed by a warp
//     scan) and adds each row's sum to the row's count in shared memory
//     with one atomic, which gives each lane its place in the row's run.
//   * After the barrier every warp scans the rows' counts into each row's
//     first quad in the pool (warp 0 also writes them out for the walk),
//     and the lanes write their valid hashes there.  The lane holding a
//     row's first entry pads the row's last quad with that hash.  A row
//     with no valid position walks nothing and keeps 0xFFFFFFFF.
//   * Where L % 4 != 0 or a base is not aligned (16 bytes for the hashes,
//     4 for the mask), the same map runs with 4- and 1-byte loads: the
//     scalar path.  minhash_path reports which path a launch takes;
//     minhash_schedule reports the lane map.
//
// The minimum does not depend on the order the compaction gives.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash_common.cuh"
#include "minhash_pool_common.cuh"

namespace {

using minhash_pool::for_cells;
using minhash_pool::kMaxDocs;
using minhash_pool::kMinBlocks;
using minhash_pool::kPool;
using minhash_pool::kThreads;
using minhash_pool::Plan;

constexpr unsigned kFull = 0xFFFFFFFFu;
// Cells of four columns a thread takes a round: docs x tile <= kPool.
constexpr int kCells = kPool / 4 / kThreads;
static_assert(kCells * 4 * kThreads == kPool, "cells cover the pool");
static_assert(kMaxDocs <= 32, "one warp scans the rows' counts");

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// 1: the 16-byte path; 0: the scalar path.
int path(const void* ngrams, const void* valid, int L) {
  return L % 4 == 0 && aligned(ngrams, 16) && aligned(valid, 4);
}

size_t smem_bytes(const Plan& p, int M) {
  return sizeof(uint32_t) * static_cast<size_t>(p.docs) *
         (static_cast<size_t>(p.tile) + static_cast<size_t>(M));
}

// Inclusive scan of x over the warp.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += up;
  }
  return x;
}

// Shared memory: pool[docs x tile] (a round's valid hashes, row by row, each
// run padded to whole quads; 16-byte aligned), part[docs][M] (running
// minima).
template <int S, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks) minhash_kernel(
    const uint32_t* __restrict__ ngrams, const bool* __restrict__ valid,
    const uint32_t* __restrict__ seeds, uint32_t* __restrict__ sig, int64_t D,
    int L, int M, Plan p) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int cnt[kMaxDocs];      // valid positions of each row this round
  __shared__ int qs[kMaxDocs + 1];   // each row's first quad in the pool
  const int tile = p.tile, cols = p.tile / 4;  // a round's cells a row
  uint32_t* pool = smem;
  uint32_t* part = pool + p.docs * tile;

  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * p.docs;
  const int ndocs = static_cast<int>(D - d0 < p.docs ? D - d0 : p.docs);
  const int lane = threadIdx.x & 31;
  // This lane: seed lane g of lane group q.
  const int g = threadIdx.x % p.lanes;
  const int q = threadIdx.x / p.lanes;

  for (int i = threadIdx.x; i < ndocs * M; i += kThreads) part[i] = 0xFFFFFFFFu;
  if (threadIdx.x < kMaxDocs) cnt[threadIdx.x] = 0;
  __syncthreads();
  // Block-uniform: several rows a block each fit one round.
  const int rounds = (L + tile - 1) / tile;

  for (int rd = 0; rd < rounds; ++rd) {
    const int l0 = rd * tile;
    // This thread's cells: four flags (bit i: column l0 + 4 w + i) and the
    // four hashes where any is set.
    int row[kCells];
    uint32_t flags[kCells];
    uint4 h[kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int c = threadIdx.x + k * kThreads;
      const int bb = c / cols;
      const int col = l0 + 4 * (c - bb * cols);
      row[k] = bb < ndocs && col < L ? bb : -1;
      flags[k] = 0u;
      h[k] = make_uint4(0u, 0u, 0u, 0u);
      if (row[k] < 0) continue;
      const int64_t at = (d0 + bb) * L + col;
      if (kVec) {
        const uint32_t w = __ldg(reinterpret_cast<const unsigned*>(valid + at));
        flags[k] = ((w & 0xFFu) != 0u) | (((w >> 8) & 0xFFu) != 0u) << 1 |
                   (((w >> 16) & 0xFFu) != 0u) << 2 | ((w >> 24) != 0u) << 3;
        if (flags[k])
          h[k] = __ldg(reinterpret_cast<const uint4*>(ngrams + at));
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (col + i < L && valid[at + i]) {
            flags[k] |= 1u << i;
            w[i] = __ldg(ngrams + at + i);
          }
        }
        h[k] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    // Each cell's place in its row's run: a warp scan of the counts, one
    // atomic a row a warp.
    int off[kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int c = __popc(flags[k]);
      const int incl = warp_scan(c, lane);
      const unsigned peers = __match_any_sync(kFull, row[k]);
      const int lead = __ffs(peers) - 1, last = 31 - __clz(peers);
      const int before = __shfl_sync(kFull, incl - c, lead);
      const int sum = __shfl_sync(kFull, incl, last) - before;
      int base = 0;
      if (lane == lead && row[k] >= 0 && sum > 0)
        base = atomicAdd(cnt + row[k], sum);
      off[k] = __shfl_sync(kFull, base, lead) + incl - c - before;
    }
    __syncthreads();
    // Each row's first quad: every warp scans the counts for its own cells.
    const int nv = lane < ndocs ? cnt[lane] : 0;
    const int qend = warp_scan((nv + 3) >> 2, lane);
    if (threadIdx.x < 32) {
      if (lane < ndocs) qs[lane + 1] = qend;
      if (lane == 0) qs[0] = 0;
    }
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int bb = row[k] < 0 ? 0 : row[k];
      const int n_row = __shfl_sync(kFull, nv, bb);
      const int first = 4 * (__shfl_sync(kFull, qend, bb) - ((n_row + 3) >> 2));
      if (flags[k] == 0u) continue;
      const uint32_t w[4] = {h[k].x, h[k].y, h[k].z, h[k].w};
      uint32_t* dst = pool + first;
      int o = off[k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if ((flags[k] >> i) & 1u) dst[o++] = w[i];
      if (off[k] == 0) {  // the row's first entry pads its last quad
        const uint32_t pad = dst[0];
        for (int j = n_row; j < ((n_row + 3) & ~3); ++j) dst[j] = pad;
      }
    }
    __syncthreads();
    // The seeds, loaded here rather than held through the fill, which
    // needs the registers.
    uint32_t s0[S];
    minhash_pool::first_seeds(seeds, g, M, s0);
    minhash_pool::walk_pool(p, g, q, s0, seeds, M, pool, ndocs,
                            [&](int bb) { return qs[bb + 1]; }, part);
    if (threadIdx.x < kMaxDocs) cnt[threadIdx.x] = 0;  // read before the walk
    __syncthreads();
  }

  for_cells(ndocs, M, [&](int bb, int m) {
    sig[(d0 + bb) * M + m] = part[bb * M + m];
  });
}

struct Launch {
  template <int S>
  static cudaError_t run(const Plan& p, bool vec, const void* ngrams,
                         const void* valid, const void* seeds, void* sig,
                         int64_t D, int L, int M, cudaStream_t stream) {
    const auto kernel = vec ? minhash_kernel<S, true> : minhash_kernel<S, false>;
    const size_t smem = smem_bytes(p, M);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    const int64_t grid = (D + p.docs - 1) / p.docs;
    kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
        static_cast<const uint32_t*>(ngrams), static_cast<const bool*>(valid),
        static_cast<const uint32_t*>(seeds), static_cast<uint32_t*>(sig), D, L,
        M, p);
    return cudaGetLastError();
  }
};

}  // namespace

// The lane map a launch over rows of L positions with M seeds takes:
// out = {threads, S, lanes, passes, slices, docs, tile}, as
// fused_ingest_schedule's.
extern "C" int minhash_schedule(int M, int L, int32_t* out) {
  if (M <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  minhash_pool::write_plan(minhash_pool::make_plan(M, L), out);
  return 0;
}

// The path a launch over these base pointers and rows of L positions takes:
// 1 for the 16-byte path, 0 for the scalar path.
extern "C" int minhash_path(const void* ngrams, const void* valid, int L) {
  return path(ngrams, valid, L);
}

extern "C" int minhash_launch(const void* ngrams, const void* valid,
                              const void* seeds, void* sig, int64_t D, int L,
                              int M, void* stream) {
  if (D <= 0 || D > 0x7FFFFFFF || L <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(minhash_pool::dispatch<Launch>(
      minhash_pool::make_plan(M, L), path(ngrams, valid, L) != 0, ngrams,
      valid, seeds, sig, D, L, M, static_cast<cudaStream_t>(stream)));
}
