// The min loop shared by K1 (fused_ingest.cu) and K4 (minhash.cu): the lane
// map of a block and its walk over a pool of hashes in shared memory.
//
// Each (document, hash, seed) triple costs the seed's multiply-add, fmix32
// (two multiplies, three shifts, three xors) and half a min (sm_90's
// three-input min takes two values at once), so the triples, not the bytes,
// bound both kernels.  The walk:
//
//   * A lane map sized to M (make_plan).  A lane keeps S seeds in registers;
//     ceil(M / S) lanes cover the seeds (in `passes` rounds where that
//     exceeds the block), and the block's kThreads / lanes groups of lanes
//     (`slices`) share the work of its rows.  At M = 100: S = 4, 5 groups of
//     25 lanes, 125 of 128 lanes.
//   * Several rows a block (`docs`: as many as fit kPool positions whole, 8
//     at L = 256) and one pool of hashes in shared memory: each row's in
//     turn, padded to whole quads with one of the row's own hashes (a
//     repeated value leaves a minimum unchanged).  Group q walks quads q,
//     q + slices, ... of the pool, so the groups' work differs by at most a
//     quad whatever the rows' lengths; a lane's minima leave it by a
//     shared-memory atomic minimum each time its walk leaves a row.  A row
//     longer than kPool is walked in rounds of kPool positions, one row a
//     block.
//   * A lane reads four hashes with one 16-byte broadcast load, which feeds
//     4 x S triples.
//
// How each kernel fills the pool is its own: K1 hashes the n-grams of a
// prefix of each row, K4 compacts each row's hashes under any mask.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "hash_common.cuh"

namespace minhash_pool {

constexpr int kThreads = 128;
// Blocks an SM the kernels are compiled for: at most 51 registers a thread.
constexpr int kMinBlocks = 10;
// Positions of a block's pool: rows of at most kPool positions share it,
// several to a block; a longer row is walked in rounds of kPool positions.
constexpr int kPool = 2048;
constexpr int kMaxDocs = 32;      // documents a block
constexpr int kPartWords = 4096;  // the block's running minima, docs x M

// The lane map of one launch; fused_ingest_schedule and minhash_schedule
// report it.
struct Plan {
  int S;       // seeds a lane
  int lanes;   // lanes a group (ceil(M / S), at most kThreads)
  int passes;  // rounds over the seeds, where ceil(M / S) > kThreads
  int slices;  // groups of lanes sharing the rows, kThreads / lanes
  int docs;    // documents a block
  int tile;    // positions of a row a round holds (a multiple of 4)
};

// Seeds a lane, in order of preference where two give the same lane use.
constexpr int kSeedsPerLane[] = {4, 8, 2, 1};

inline Plan make_plan(int M, int L) {
  const int quads = (L + 3) / 4;
  Plan best{};
  int64_t best_num = -1, best_den = 1;
  for (const int S : kSeedsPerLane) {
    Plan p{};
    p.S = S;
    const int groups = (M + S - 1) / S;
    if (groups >= kThreads) {
      p.lanes = kThreads;
      p.passes = (groups + kThreads - 1) / kThreads;
    } else {
      p.lanes = groups;
      p.passes = 1;
    }
    p.slices = kThreads / p.lanes;
    // Lane use: M slices / (kThreads S passes).
    const int64_t num = static_cast<int64_t>(M) * p.slices;
    const int64_t den = static_cast<int64_t>(S) * p.passes;
    if (num * best_den > best_num * den) {
      best = p;
      best_num = num;
      best_den = den;
    }
  }
  int docs = kPool / (4 * quads);
  docs = docs < kMaxDocs ? docs : kMaxDocs;
  docs = docs < kPartWords / M ? docs : kPartWords / M;
  best.docs = docs > 1 ? docs : 1;
  best.tile = 4 * quads < kPool ? 4 * quads : kPool;
  return best;
}

// out = {threads, S, lanes, passes, slices, docs, tile}: what the schedule
// exports report.
inline void write_plan(const Plan& p, int32_t* out) {
  const int32_t v[] = {kThreads, p.S, p.lanes, p.passes, p.slices, p.docs,
                       p.tile};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

__device__ __forceinline__ uint32_t min3(uint32_t a, uint32_t b, uint32_t c) {
  return min(a, min(b, c));
}

// f(row, col) for the cells of a rows x cols grid, this thread taking cells
// threadIdx.x, threadIdx.x + kThreads, ... in row-major order, with one
// division for the whole walk.
template <class F>
__device__ __forceinline__ void for_cells(int rows, int cols, F f) {
  int row = threadIdx.x / cols, col = threadIdx.x - row * cols;
  while (row < rows) {
    f(row, col);
    col += kThreads;
    while (col >= cols) {
      col -= cols;
      ++row;
    }
  }
}

// The seeds of lane g's first pass, in registers for the whole block.
template <int S>
__device__ __forceinline__ void first_seeds(const uint32_t* __restrict__ seeds,
                                            int g, int M, uint32_t (&s0)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) s0[k] = __ldg(seeds + min(g * S + k, M - 1));
}

// Seed lane g of lane group q walks the pool (rows 0 .. ndocs - 1, row bb's
// quads ending at quad end(bb), each row starting where the last ends) and
// leaves each row's minima in part[bb * M + m] by an atomic minimum.
template <int S, class End>
__device__ __forceinline__ void walk_pool(const Plan& p, int g, int q,
                                          const uint32_t (&s0)[S],
                                          const uint32_t* __restrict__ seeds,
                                          int M, const uint32_t* pool,
                                          int ndocs, End end, uint32_t* part) {
  const uint4* pool4 = reinterpret_cast<const uint4*>(pool);
  const int slices = p.slices;
  for (int pass = 0; pass < p.passes; ++pass) {
    const int m0 = (pass * p.lanes + g) * S;
    if (m0 >= M || q >= slices) break;  // lanes past the last group idle
    uint32_t s[S];
#pragma unroll
    for (int k = 0; k < S; ++k)
      s[k] = pass == 0 ? s0[k] : __ldg(seeds + min(m0 + k, M - 1));
    // Lane group q takes quads q, q + slices, ... of the pool; a row's
    // minima go to part when the walk leaves it.
    int j = q;
    for (int bb = 0; bb < ndocs; ++bb) {
      const int e = end(bb);
      if (j >= e) continue;
      uint32_t mn[S];
#pragma unroll
      for (int k = 0; k < S; ++k) mn[k] = 0xFFFFFFFFu;
#pragma unroll 1
      for (; j < e; j += slices) {
        const uint4 v = pool4[j];
#pragma unroll
        for (int k = 0; k < S; ++k) {
          mn[k] = min3(mn[k], repro::hash_u32(v.x, s[k]),
                       repro::hash_u32(v.y, s[k]));
          mn[k] = min3(mn[k], repro::hash_u32(v.z, s[k]),
                       repro::hash_u32(v.w, s[k]));
        }
      }
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (m0 + k < M) atomicMin(part + bb * M + m0 + k, mn[k]);
    }
  }
}

// Run Launch::run<S>(p, args...) for the plan's S.
template <class Launch, class... Args>
cudaError_t dispatch(const Plan& p, Args... args) {
  switch (p.S) {
    case 1: return Launch::template run<1>(p, args...);
    case 2: return Launch::template run<2>(p, args...);
    case 4: return Launch::template run<4>(p, args...);
    case 8: return Launch::template run<8>(p, args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace minhash_pool
