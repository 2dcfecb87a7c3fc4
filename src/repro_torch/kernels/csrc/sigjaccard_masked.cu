// K7: masked pair agreement counts -- the device-resident stage 2 of the
// sharded dedup step.
//
// Replaces the Pallas kernel behind repro.kernels.sigjaccard's
// masked_indexed_pair_counts and masked_pair_counts (body
// _sigjac_masked_kernel), which returned float32 counts.  These kernels
// return int32 counts: 0 where `valid` is false, else the number of m with
// a[m] == b[m].  The caller divides by M, correctly rounded.
//
// Two forms share one kernel, and K2's lane-group body
// (pair_counts_common.cuh):
//   * indexed: rows a_idx[p] and b_idx[p] of one (D, M) matrix, each index
//     clipped to [0, D - 1] first, as the reference clips before its
//     gather -- the sharded step passes shard-relative indices whose
//     invalid lanes point outside the shard;
//   * pre-gathered: rows p of two (P, M) matrices (cross-shard edges,
//     one side from the exchanged row buffer).
//
// What bounds it on the card: device-memory bytes, and only the valid
// lanes' rows need reading: the step's static edge buffers are mostly
// empty slots (2 % valid on the main path), while at paper scale half the
// lanes are valid.  So a warp takes 32 lanes at a time: each thread reads
// its lane's mask byte (and, if valid, its indices), a ballot compacts the
// valid lanes, and lane groups of G (32/G pairs at once) gather only those
// lanes' rows, in ceil(valid / (32/G)) rounds; each count is shuffled back
// to its lane, and the warp writes its 32 counts, zeros included, in one
// coalesced store.
#include <cstdint>
#include <cuda_runtime.h>

#include "pair_counts_common.cuh"

namespace {

using namespace pair_counts;

__device__ __forceinline__ int32_t clip_row(int32_t i, int64_t D) {
  return i < 0 ? 0 : (i >= D ? static_cast<int32_t>(D - 1) : i);
}

// Rows of the indexed form: a_idx[p] and b_idx[p] of one matrix, clipped.
// A valid lane loads its two clipped indices, 32 bits each, and the group
// that takes the lane turns them into row offsets.
struct IndexedRows {
  const uint32_t* a;  // the matrix, twice: both rows come from it
  const uint32_t* b;
  const int32_t* a_idx;
  const int32_t* b_idx;
  int64_t D;
  __device__ __forceinline__ void load(int64_t p, int32_t* ka,
                                       int32_t* kb) const {
    *ka = clip_row(__ldg(a_idx + p), D);
    *kb = clip_row(__ldg(b_idx + p), D);
  }
  __device__ __forceinline__ int64_t offset(int64_t, int32_t k,
                                            int M) const {
    return static_cast<int64_t>(k) * M;
  }
};

// Rows of the pre-gathered form: row p of each of two (P, M) matrices,
// found from the lane's own position; nothing is loaded for it.
struct GatheredRows {
  const uint32_t* a;
  const uint32_t* b;
  __device__ __forceinline__ void load(int64_t, int32_t* ka,
                                       int32_t* kb) const {
    *ka = *kb = 0;
  }
  __device__ __forceinline__ int64_t offset(int64_t p, int32_t,
                                            int M) const {
    return p * M;
  }
};

template <int G, bool kVec, class Rows>
__global__ void __launch_bounds__(kBlock, kMinBlocks) masked_pair_counts_kernel(
    Rows rows, int M, const uint8_t* __restrict__ valid, int64_t P,
    int32_t* __restrict__ counts) {
  constexpr int kPairs = 32 / G;  // pairs a warp holds at once
  const int lane = threadIdx.x & 31, grp = lane / G, sub = lane % G;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps * 32;
  for (int64_t p0 =
           (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32;
       p0 < P; p0 += stride) {  // the same for every lane of the warp
    const int64_t p = p0 + lane;
    const bool v = p < P && __ldg(valid + p) != 0;
    int32_t ka = 0, kb = 0;
    if (v) rows.load(p, &ka, &kb);
    const unsigned mask = __ballot_sync(kFull, v);
    const int n = __popc(mask);
    const int rank = __popc(mask & ((1u << lane) - 1u));  // among valid lanes
    int mine = 0;
    for (int first = 0; first < n; first += kPairs) {  // uniform in the warp
      // Group grp takes the valid lane of rank first + grp.
      const int k = first + grp;
      const bool active = k < n;
      const int src = nth_set_bit(mask, active ? k : 0);
      const int32_t sa = __shfl_sync(kFull, ka, src);
      const int32_t sb = __shfl_sync(kFull, kb, src);
      const int c = group_sum<G>(lane_agree<G, kVec>(
          rows.a + rows.offset(p0 + src, sa, M),
          rows.b + rows.offset(p0 + src, sb, M), M, sub, active));
      // Back to the lane it belongs to: rank r's count is in group r - first.
      const int got =
          __shfl_sync(kFull, c, ((rank - first) & (kPairs - 1)) * G);
      if (v && rank >= first && rank < first + kPairs) mine = got;
    }
    if (p < P) counts[p] = mine;
  }
}

template <class Rows>
struct Launch {
  template <int G, bool kVec>
  static cudaError_t run(Rows rows, int M, const uint8_t* valid, int64_t P,
                         int32_t* counts, cudaStream_t stream) {
    const unsigned grid =
        grid_for<&masked_pair_counts_kernel<G, kVec, Rows>>((P + 31) / 32);
    if (grid == 0) return cudaErrorInvalidValue;
    masked_pair_counts_kernel<G, kVec, Rows><<<grid, kBlock, 0, stream>>>(
        rows, M, valid, P, counts);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int masked_indexed_pair_counts_launch(
    const void* sig, int64_t D, int M, const void* a_idx, const void* b_idx,
    const void* valid, int64_t P, void* counts, void* stream) {
  if (D <= 0 || M <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const uint32_t*>(sig);
  const IndexedRows rows{s, s, static_cast<const int32_t*>(a_idx),
                         static_cast<const int32_t*>(b_idx), D};
  return static_cast<int>(pair_counts::dispatch<Launch<IndexedRows>>(
      pair_counts::schedule(M, sig, sig), rows, M,
      static_cast<const uint8_t*>(valid), P, static_cast<int32_t*>(counts),
      static_cast<cudaStream_t>(stream)));
}

extern "C" int masked_pair_counts_launch(const void* rows_a,
                                         const void* rows_b, int M,
                                         const void* valid, int64_t P,
                                         void* counts, void* stream) {
  if (M <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const GatheredRows rows{static_cast<const uint32_t*>(rows_a),
                          static_cast<const uint32_t*>(rows_b)};
  return static_cast<int>(pair_counts::dispatch<Launch<GatheredRows>>(
      pair_counts::schedule(M, rows_a, rows_b), rows, M,
      static_cast<const uint8_t*>(valid), P, static_cast<int32_t*>(counts),
      static_cast<cudaStream_t>(stream)));
}
