// K2: pair agreement counts -- gather two signature rows per candidate pair
// and count the entries on which they agree.
//
// Replaces the Pallas kernel repro.kernels.sigjaccard.indexed_pair_estimate
// (body _sigjac_kernel), which returned the agreement fraction.  This kernel
// returns int32 counts: the caller divides by M in PyTorch, correctly
// rounded, because the Pallas body's multiply by 1.0/M is 1 ulp off the
// numpy estimator for 30 of the 101 counts at M = 100.
//
// What bounds it on the card: device-memory bytes.  Each pair reads two
// rows of M words at random rows of the matrix, which at paper scale is
// far larger than the 50 MB L2, so the gathered rows stream from HBM.  The
// design gives each pair one warp: the lanes read neighbouring words of
// both rows (coalesced), compare, and one warp reduction turns the 32
// partial counts into the pair's count.  Nothing is staged in shared
// memory, because no row is reused inside a block.
//
// Indices are int64 and must lie in [0, D): the kernel does not check
// them (verify.SignatureVerifier checks every batch on the host).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32) pair_counts_kernel(
    const uint32_t* __restrict__ sig, int M,
    const int64_t* __restrict__ a_idx, const int64_t* __restrict__ b_idx,
    int64_t P, int32_t* __restrict__ counts) {
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;  // the same for every lane of the warp
  const uint32_t* ra = sig + a_idx[p] * M;
  const uint32_t* rb = sig + b_idx[p] * M;
  int c = 0;
  for (int m = lane; m < M; m += 32) c += ra[m] == rb[m];
  c = __reduce_add_sync(0xFFFFFFFFu, c);
  if (lane == 0) counts[p] = c;
}

}  // namespace

extern "C" int pair_counts_launch(const void* sig, int64_t D, int M,
                                  const void* a_idx, const void* b_idx,
                                  int64_t P, void* counts, void* stream) {
  if (D <= 0 || M <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  pair_counts_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sig), M,
      static_cast<const int64_t*>(a_idx), static_cast<const int64_t*>(b_idx),
      P, static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
