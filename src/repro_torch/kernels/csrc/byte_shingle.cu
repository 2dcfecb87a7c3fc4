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
// sequential L tiles.
//
// What bounds it on the card: device-memory bytes.  Each position reads one
// byte and writes eight (tok and ends, int32 as the reference's contract
// says); the operations per byte are a few compares and, once per token
// byte, an xor and a multiply.  The design is a flat stream:
//
//   * The (D, W) matrices are flat arrays of D W positions, cut into chunks
//     of 16.  A thread owns a chunk: one 16-byte load of its bytes, and four
//     16-byte stores into each output, so alignment does not depend on W
//     (odd widths, W = 2,049, left every row of the one-thread-a-position
//     kernel misaligned).  One division a chunk finds its first row; rows
//     that start inside the chunk (W can be as small as 2) are found by
//     counting columns.
//   * Classes run as 16-bit masks (token byte, row start), and the FNV-1a
//     state runs forward in a register over the chunk's bytes.
//   * A token's end is owned by the chunk that holds it.  Where that token
//     began in an earlier chunk, the owner walks back to its start within
//     the row and hashes those bytes first, so each token's hash is
//     finished by one thread and every chunk's work is O(its bytes + the
//     one token it inherits).
//   * A warp's outputs go through shared memory (a swizzled 2 KB a warp and
//     output, free of bank conflicts), so each 16-byte store of the warp
//     covers 512 consecutive bytes.  Stored straight from the registers,
//     a thread's 64 bytes an output leave lanes 64 bytes apart, and the
//     kernel took 1.7x as long at paper scale (PERF.md).
//   * Where a base pointer is not 16-byte aligned (a view into storage), the
//     same map runs with 1-byte loads and 4-byte stores: the scalar path.
//     byte_token_hashes_schedule reports which path a launch takes.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;  // positions a thread
constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;

__device__ __forceinline__ bool is_alnum(uint32_t b) {
  return (b - 'a' < 26u) || (b - 'A' < 26u) || (b - '0' < 10u);
}

__device__ __forceinline__ uint32_t fold_case(uint32_t b) {
  return b - 'A' < 26u ? b + 32u : b;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The 16 bytes of chunk c (zeros past the end of the matrix): one 16-byte
// load on the vector path where the chunk is whole, else 1-byte loads.
template <bool kVec>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ data,
                                            int64_t total, int64_t c) {
  const int64_t p0 = c * kChunk;
  if (kVec && p0 + kChunk <= total)
    return __ldg(reinterpret_cast<const uint4*>(data + p0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kChunk; ++k)
    if (p0 + k < total) w[k >> 2] |= uint32_t{__ldg(data + p0 + k)} << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Chunk c's token ids and end mask (bit k: position 16 c + k is an end),
// from its bytes v.
__device__ __forceinline__ uint32_t chunk_tokens(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ lengths,
    int64_t D, int W, int64_t c, uint4 v, uint32_t id_seed,
    uint32_t (&ids)[kChunk]) {
  const int64_t p0 = c * kChunk;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const int64_t row = p0 / W;
  const int col = static_cast<int>(p0 - row * W);
  const int len = __ldg(lengths + row);
  // The byte before the chunk, in the same row, is a token byte.
  const uint32_t prev = col > 0 && col - 1 < len && is_alnum(__ldg(data + p0 - 1));

  uint32_t tmask = 0u, rmask = 0u;  // token bytes; row starts
  {
    int cc = col, rl = len;
    int64_t rr = row;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (cc == W) {
        cc = 0;
        ++rr;
        rl = rr < D ? __ldg(lengths + rr) : 0;
      }
      const uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
      rmask |= uint32_t{cc == 0} << k;
      tmask |= uint32_t{cc < rl && is_alnum(b)} << k;
      ++cc;
    }
  }
  const uint32_t before = (tmask << 1) | prev;  // bit k: byte k - 1 is a token byte
  const uint32_t emask = ~tmask & before & ~rmask & 0xFFFFu;
  const uint32_t smask = tmask & (~before | rmask);  // token starts

  // The token running into the chunk: hash its earlier bytes only where it
  // ends here (the first non-token byte comes before the row's end).
  uint32_t h = kFnvOffset;
  const uint32_t stop = (~tmask | rmask) & 0xFFFFu;
  if (prev && stop != 0u && !((rmask >> (__ffs(stop) - 1)) & 1u)) {
    int64_t s = p0 - 1;  // a token byte, so every byte before it lies in the row
    for (int sc = col - 1; sc > 0 && is_alnum(__ldg(data + s - 1)); --sc) --s;
    for (; s < p0; ++s) h = (h ^ fold_case(__ldg(data + s))) * kFnvPrime;
  }
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
    ids[k] = (emask >> k) & 1u ? repro::hash_u32(h, id_seed) : 0u;
    if ((tmask >> k) & 1u)
      h = (((smask >> k) & 1u ? kFnvOffset : h) ^ fold_case(b)) * kFnvPrime;
  }
  return emask;
}

// Word k (positions 4 k .. 4 k + 3) of a chunk's ids and of its ends.
__device__ __forceinline__ uint4 id_word(const uint32_t (&ids)[kChunk], int k) {
  return make_uint4(ids[4 * k], ids[4 * k + 1], ids[4 * k + 2], ids[4 * k + 3]);
}

__device__ __forceinline__ uint4 end_word(uint32_t emask, int k) {
  return make_uint4((emask >> (4 * k)) & 1u, (emask >> (4 * k + 1)) & 1u,
                    (emask >> (4 * k + 2)) & 1u, (emask >> (4 * k + 3)) & 1u);
}

// Slot of 16-byte word u (thread u / 4's word u % 4) in a warp's staging
// buffer: each quarter-warp's eight 16-byte accesses hit 8 distinct bank
// groups, writing (one word of 8 threads) and reading (8 consecutive words).
__device__ __forceinline__ int stage_slot(int u) {
  const int t = u >> 2;
  return (t << 2) | (((u & 3) + (t >> 1)) & 3);
}

// Warps stride over groups of 32 chunks; lane l takes chunk 32 w + l.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) byte_token_hashes_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ lengths,
    uint32_t* __restrict__ tok, int32_t* __restrict__ ends, int64_t D, int W,
    uint32_t id_seed) {
  __shared__ uint4 stage[kVec ? kWarps : 1][2][32 * kChunk / 4];
  const int64_t total = D * W;
  const int64_t chunks = (total + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       w * 32 < chunks; w += stride) {  // the same for every lane of the warp
    const int64_t c = w * 32 + lane;
    uint32_t ids[kChunk];
    uint32_t emask = 0u;
    if (c < chunks)
      emask = chunk_tokens(data, lengths, D, W, c,
                           load_chunk<kVec>(data, total, c), id_seed, ids);
    if constexpr (kVec) {
      uint4* st = stage[warp][0];
      uint4* se = stage[warp][1];
      if (c < chunks) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int slot = stage_slot(lane * 4 + k);
          st[slot] = id_word(ids, k);
          se[slot] = end_word(emask, k);
        }
      }
      __syncwarp();
      const int64_t base = w * 32 * kChunk;  // the warp's first position
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int u = 32 * k + lane;
        const int64_t p = base + 4 * u;
        if (p >= total) continue;
        const uint4 vt = st[stage_slot(u)], ve = se[stage_slot(u)];
        if (p + 4 <= total) {
          reinterpret_cast<uint4*>(tok)[p >> 2] = vt;
          reinterpret_cast<uint4*>(ends)[p >> 2] = ve;
        } else {
          const uint32_t t4[4] = {vt.x, vt.y, vt.z, vt.w};
          const uint32_t e4[4] = {ve.x, ve.y, ve.z, ve.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (p + j < total) {
              tok[p + j] = t4[j];
              ends[p + j] = static_cast<int32_t>(e4[j]);
            }
          }
        }
      }
      __syncwarp();
    } else if (c < chunks) {
      const int64_t p0 = c * kChunk;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (p0 + k < total) {
          tok[p0 + k] = ids[k];
          ends[p0 + k] = static_cast<int32_t>((emask >> k) & 1u);
        }
      }
    }
  }
}

// +1: the 16-byte path; 0: the scalar path.
int schedule(const void* data, const void* tok, const void* ends) {
  return aligned16(data) && aligned16(tok) && aligned16(ends) ? 1 : 0;
}

template <bool kVec>
cudaError_t launch(const void* data, const void* lengths, void* tok, void* ends,
                   int64_t D, int W, uint32_t id_seed, cudaStream_t stream) {
  const int64_t chunks = (D * W + kChunk - 1) / kChunk;
  int64_t grid = ((chunks + 31) / 32 + kWarps - 1) / kWarps;
  if (grid > 0x7FFFFFFF) grid = 0x7FFFFFFF;  // warps stride over the rest
  byte_token_hashes_kernel<kVec><<<static_cast<unsigned>(grid), kThreads, 0,
                                   stream>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      static_cast<uint32_t*>(tok), static_cast<int32_t*>(ends), D, W, id_seed);
  return cudaGetLastError();
}

}  // namespace

// The path a launch over these three base pointers takes: 1 for the
// 16-byte path, 0 for the scalar path.
extern "C" int byte_token_hashes_schedule(const void* data, const void* tok,
                                          const void* ends) {
  return schedule(data, tok, ends);
}

extern "C" int byte_token_hashes_launch(const void* data, const void* lengths,
                                        void* tok, void* ends, int64_t D,
                                        int LB, uint32_t id_seed,
                                        void* stream) {
  if (D <= 0 || D > 0x7FFFFFFF || LB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      schedule(data, tok, ends)
          ? launch<true>(data, lengths, tok, ends, D, LB, id_seed, s)
          : launch<false>(data, lengths, tok, ends, D, LB, id_seed, s));
}
