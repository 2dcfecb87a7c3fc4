// K3: rolling n-gram hashes -- fmix32 of the base-NGRAM_BASE polynomial of
// every length-n token window of a packed (D, L) token matrix.
//
// Replaces the Pallas kernel repro.kernels.ngram.ngram_hashes (body
// _ngram_kernel).  The Pallas kernel read each (8, 256) tile plus the next
// tile as a halo, clamped at the last tile, so its windows past column
// L - n read tokens of the tile itself; those positions are never valid.
// Here a window past column L reads zeros, as K1 and the plain
// core/shingle.ngram_hashes do.  Validity comes from the lengths, outside
// the kernel (kernels/ngram.py).
//
// What bounds it on the card: device-memory bytes.  Each position costs n
// multiply-adds and fmix32 (about 2n + 8 integer operations), and moves
// one token in and one hash out, 8 bytes: at n = 8 the operations take
// about a fifth of the bytes' time.  The design reads each token from
// device memory once: a block stages a tile of one row, plus the n - 1
// tokens of the halo, in shared memory with coalesced loads, and every
// thread hashes one position from there.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash_common.cuh"

namespace {

constexpr int kTile = 256;  // positions per block, one per thread

// Grid (D, ceil(L / kTile)).  Shared memory: tok[kTile + n - 1].
__global__ void __launch_bounds__(kTile) ngram_hashes_kernel(
    const uint32_t* __restrict__ tokens, uint32_t* __restrict__ hashes,
    int L, int n) {
  extern __shared__ uint32_t tok[];
  const int64_t d = blockIdx.x;
  const int l0 = blockIdx.y * kTile;
  const uint32_t* row = tokens + d * L;
  for (int i = threadIdx.x; i < kTile + n - 1; i += blockDim.x) {
    const int l = l0 + i;
    tok[i] = l < L ? row[l] : 0u;
  }
  __syncthreads();
  const int l = l0 + threadIdx.x;
  if (l < L) hashes[d * L + l] = repro::ngram_hash(tok + threadIdx.x, n);
}

}  // namespace

extern "C" int ngram_hashes_launch(const void* tokens, void* hashes,
                                   int64_t D, int L, int n, void* stream) {
  if (D <= 0 || D > 0x7FFFFFFF || L <= 0 || n <= 0 || n > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = static_cast<unsigned>((L + kTile - 1) / kTile);
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) * (kTile + n - 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ngram_hashes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ngram_hashes_kernel<<<dim3(static_cast<unsigned>(D), tiles), kTile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tokens), static_cast<uint32_t*>(hashes),
      L, n);
  return static_cast<int>(cudaGetLastError());
}
