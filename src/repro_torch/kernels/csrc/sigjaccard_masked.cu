// K7: masked pair agreement counts -- the device-resident stage 2 of the
// sharded dedup step.
//
// Replaces the Pallas kernel behind repro.kernels.sigjaccard's
// masked_indexed_pair_counts and masked_pair_counts (body
// _sigjac_masked_kernel), which returned float32 counts.  These kernels
// return int32 counts: 0 where `valid` is false, else the number of m with
// a[m] == b[m].  The caller divides by M, correctly rounded.
//
// Two forms share one warp-per-pair body:
//   * indexed: rows a_idx[p] and b_idx[p] of one (D, M) matrix, each index
//     clipped to [0, D - 1] first, as the reference clips before its
//     gather -- the sharded step passes shard-relative indices whose
//     invalid lanes point outside the shard;
//   * pre-gathered: rows p of two (P, M) matrices (cross-shard edges,
//     one side from the exchanged row buffer).
//
// What bounds it on the card: device-memory bytes.  A valid pair reads two
// rows of M words; an invalid pair reads nothing but its index and mask
// bytes, since most slots of the step's static edge buffers are empty.
// Each pair gets one warp: lanes read neighbouring words of both rows
// (coalesced), compare, and one warp reduction gives the count.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ int64_t clip_row(int32_t i, int64_t D) {
  const int64_t x = i;
  return x < 0 ? 0 : (x >= D ? D - 1 : x);
}

__device__ __forceinline__ int count_agree(const uint32_t* __restrict__ ra,
                                           const uint32_t* __restrict__ rb,
                                           int M, int lane) {
  int c = 0;
  for (int m = lane; m < M; m += 32) c += ra[m] == rb[m];
  return __reduce_add_sync(0xFFFFFFFFu, c);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    masked_indexed_pair_counts_kernel(const uint32_t* __restrict__ sig,
                                      int64_t D, int M,
                                      const int32_t* __restrict__ a_idx,
                                      const int32_t* __restrict__ b_idx,
                                      const uint8_t* __restrict__ valid,
                                      int64_t P, int32_t* __restrict__ counts) {
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;  // the same for every lane of the warp
  if (!valid[p]) {
    if (lane == 0) counts[p] = 0;
    return;
  }
  const int c = count_agree(sig + clip_row(a_idx[p], D) * M,
                            sig + clip_row(b_idx[p], D) * M, M, lane);
  if (lane == 0) counts[p] = c;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    masked_pair_counts_kernel(const uint32_t* __restrict__ rows_a,
                              const uint32_t* __restrict__ rows_b, int M,
                              const uint8_t* __restrict__ valid, int64_t P,
                              int32_t* __restrict__ counts) {
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  if (!valid[p]) {
    if (lane == 0) counts[p] = 0;
    return;
  }
  const int c = count_agree(rows_a + p * M, rows_b + p * M, M, lane);
  if (lane == 0) counts[p] = c;
}

int blocks_for(int64_t P, unsigned* out) {
  const int64_t blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks <= 0 || blocks > 0x7FFFFFFF) return 0;
  *out = static_cast<unsigned>(blocks);
  return 1;
}

}  // namespace

extern "C" int masked_indexed_pair_counts_launch(
    const void* sig, int64_t D, int M, const void* a_idx, const void* b_idx,
    const void* valid, int64_t P, void* counts, void* stream) {
  unsigned blocks;
  if (D <= 0 || M <= 0 || !blocks_for(P, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  masked_indexed_pair_counts_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sig), D, M,
      static_cast<const int32_t*>(a_idx), static_cast<const int32_t*>(b_idx),
      static_cast<const uint8_t*>(valid), P, static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int masked_pair_counts_launch(const void* rows_a,
                                         const void* rows_b, int M,
                                         const void* valid, int64_t P,
                                         void* counts, void* stream) {
  unsigned blocks;
  if (M <= 0 || !blocks_for(P, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  masked_pair_counts_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows_a),
      static_cast<const uint32_t*>(rows_b), M,
      static_cast<const uint8_t*>(valid), P, static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
