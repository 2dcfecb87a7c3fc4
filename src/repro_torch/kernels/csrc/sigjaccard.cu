// K2: pair agreement counts -- gather two signature rows per candidate pair
// and count the entries on which they agree.
//
// Replaces the Pallas kernel repro.kernels.sigjaccard.indexed_pair_estimate
// (body _sigjac_kernel), which returned the agreement fraction.  This kernel
// returns int32 counts: the caller divides by M in PyTorch, correctly
// rounded, because the Pallas body's multiply by 1.0/M is 1 ulp off the
// numpy estimator for 30 of the 101 counts at M = 100.
//
// What bounds it, and the lane-group body that answers it, are in
// pair_counts_common.cuh.  Here a warp takes 32/G consecutive pairs at a
// time: lane i < 32/G loads pair i's two indices (one coalesced load a
// vector), the shuffles hand them to the pair's group, and the group's
// first lane writes the count.  A warp's work is that small so that the
// verifier's batches of at most 8,192 pairs still spread over every SM.
//
// Indices are int64 and must lie in [0, D): the kernel does not check
// them (verify.SignatureVerifier checks every batch on the host).
#include <cstdint>
#include <cuda_runtime.h>

#include "pair_counts_common.cuh"

namespace {

using namespace pair_counts;

template <int G, bool kVec>
__global__ void __launch_bounds__(kBlock, kMinBlocks) pair_counts_kernel(
    const uint32_t* __restrict__ sig, int M,
    const int64_t* __restrict__ a_idx, const int64_t* __restrict__ b_idx,
    int64_t P, int32_t* __restrict__ counts) {
  constexpr int kPairs = 32 / G;  // pairs a warp holds at once
  const int lane = threadIdx.x & 31, grp = lane / G, sub = lane % G;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       w * kPairs < P; w += stride) {  // the same for every lane of the warp
    const int64_t first = w * kPairs;
    int64_t ia = 0, ib = 0;
    if (lane < kPairs && first + lane < P) {
      ia = a_idx[first + lane];
      ib = b_idx[first + lane];
    }
    ia = __shfl_sync(kFull, ia, grp);
    ib = __shfl_sync(kFull, ib, grp);
    const bool active = first + grp < P;
    const int c = group_sum<G>(
        lane_agree<G, kVec>(sig + ia * M, sig + ib * M, M, sub, active));
    if (active && sub == 0) counts[first + grp] = c;
  }
}

struct Launch {
  template <int G, bool kVec>
  static cudaError_t run(const uint32_t* sig, int M, const int64_t* a_idx,
                         const int64_t* b_idx, int64_t P, int32_t* counts,
                         cudaStream_t stream) {
    const unsigned grid =
        grid_for<&pair_counts_kernel<G, kVec>>((P + 32 / G - 1) / (32 / G));
    if (grid == 0) return cudaErrorInvalidValue;
    pair_counts_kernel<G, kVec><<<grid, kBlock, 0, stream>>>(
        sig, M, a_idx, b_idx, P, counts);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int pair_counts_launch(const void* sig, int64_t D, int M,
                                  const void* a_idx, const void* b_idx,
                                  int64_t P, void* counts, void* stream) {
  if (D <= 0 || M <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pair_counts::dispatch<Launch>(
      pair_counts::schedule(M, sig, sig), static_cast<const uint32_t*>(sig),
      M,
      static_cast<const int64_t*>(a_idx), static_cast<const int64_t*>(b_idx),
      P, static_cast<int32_t*>(counts), static_cast<cudaStream_t>(stream)));
}

// The schedule the three pair-count launchers take for rows of M words at
// bases a and b: +G on the 16-byte path, -G on the scalar path.
extern "C" int pair_counts_schedule(int M, const void* a, const void* b) {
  return pair_counts::schedule(M, a, b);
}
