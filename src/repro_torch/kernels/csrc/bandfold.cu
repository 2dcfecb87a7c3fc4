// K5: band fold -- the (D, M) signature matrix to (D, M/r, 2) band values,
// each lane a chained h <- hash_u32(h, sig) over the band's r entries.
//
// Replaces the Pallas kernel repro.kernels.bandfold.band_values (body
// _bandfold_kernel).  It is K1's closing fold on its own, with the same
// device code (hash_common.cuh).
//
// What bounds it on the card: device-memory bytes.  Each band reads r words
// and writes two, and costs 2r hash steps of about ten integer operations:
// at r = 2 the operations take about a third of the bytes' time.  The
// design gives each (document, band) one thread, which computes both lanes
// and writes them as one 8-byte store; neighbouring threads read and write
// neighbouring words.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) band_values_kernel(
    const uint32_t* __restrict__ sig, uint2* __restrict__ bands,
    int64_t total, int r) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= total) return;
  // Bands are rows of r consecutive words: band j starts at word j * r.
  const uint32_t* v = sig + j * r;
  bands[j] = make_uint2(repro::fold_lane(v, r, repro::kLaneSeed0),
                        repro::fold_lane(v, r, repro::kLaneSeed1));
}

}  // namespace

extern "C" int band_values_launch(const void* sig, void* bands, int64_t D,
                                  int M, int r, void* stream) {
  if (D <= 0 || M <= 0 || r <= 0 || M % r != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = D * (M / r);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  band_values_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sig), static_cast<uint2*>(bands), total, r);
  return static_cast<int>(cudaGetLastError());
}
