// K6: byte token hashes -- raw UTF-8 bytes to per-position token ids.
//
// A token is a maximal run of ASCII alphanumerics; A-Z fold to a-z (+32);
// every other byte, every byte >= 0x80 and every position at or past the
// row's length is a separator.  Position i is a token end iff byte i - 1 is
// a token byte and byte i is not; there ends[d, i] = 1 and tok[d, i] =
// hash_u32(FNV-1a of the token's folded bytes, id_seed), and both are 0
// elsewhere.  A token needs a column after it to end in: bytes_to_bands
// pads one.
//
// Replaces the Pallas kernel repro.kernels.byte_shingle.byte_token_hashes
// (body _byte_kernel).  That kernel walked the byte columns in order with
// a lax.scan carrying the FNV state and the previous byte's class across
// sequential L tiles.  Here every position is a thread and finds its own
// boundary from two bytes; the thread at a token's end walks back to the
// token's start and hashes it forward.  Each byte is walked by the one
// thread that owns its token, so the work stays O(bytes), a row of one
// long run included.
//
// What bounds it on the card: device-memory bytes.  Each position reads one
// byte and writes eight (tok and ends, int32 as the reference's contract
// says); the operations per byte are a few compares and, once per token
// byte, an xor and a multiply.  Neighbouring threads read neighbouring
// bytes, so the loads coalesce, and the walk back re-reads bytes from L1.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;

__device__ __forceinline__ bool is_alnum(uint32_t b) {
  return (b - 'a' < 26u) || (b - 'A' < 26u) || (b - '0' < 10u);
}

__device__ __forceinline__ uint32_t fold_case(uint32_t b) {
  return b - 'A' < 26u ? b + 32u : b;
}

// Grid (D, ceil(LB / kThreads)): one thread per byte position.
__global__ void __launch_bounds__(kThreads) byte_token_hashes_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ lengths,
    uint32_t* __restrict__ tok, int32_t* __restrict__ ends, int LB,
    uint32_t id_seed) {
  const int64_t d = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= LB) return;
  const uint8_t* row = data + d * LB;
  const int len = lengths[d];
  // Byte j (j < i <= LB) is a token byte iff it lies in the row and is alnum.
  const bool here = i < len && is_alnum(row[i]);
  const bool end = i >= 1 && i - 1 < len && is_alnum(row[i - 1]) && !here;
  uint32_t id = 0u;
  if (end) {
    int s = i - 1;  // every byte before i - 1 lies in the row
    while (s > 0 && is_alnum(row[s - 1])) --s;
    uint32_t h = kFnvOffset;
    for (int j = s; j < i; ++j) h = (h ^ fold_case(row[j])) * kFnvPrime;
    id = repro::hash_u32(h, id_seed);
  }
  tok[d * LB + i] = id;
  ends[d * LB + i] = end ? 1 : 0;
}

}  // namespace

extern "C" int byte_token_hashes_launch(const void* data, const void* lengths,
                                        void* tok, void* ends, int64_t D,
                                        int LB, uint32_t id_seed,
                                        void* stream) {
  if (D <= 0 || D > 0x7FFFFFFF || LB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = static_cast<unsigned>((LB + kThreads - 1) / kThreads);
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  byte_token_hashes_kernel<<<dim3(static_cast<unsigned>(D), tiles), kThreads,
                             0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      static_cast<uint32_t*>(tok), static_cast<int32_t*>(ends), LB, id_seed);
  return static_cast<int>(cudaGetLastError());
}
