// Device code shared by the hashing kernels: the Murmur3 finalizer, the
// seeded hash built on it, the rolling n-gram hash and the two-lane band
// fold.  Every operation is uint32 arithmetic with wraparound, bit for bit
// the functions of core/hashing.py, core/shingle.py and core/lsh.py.
#pragma once

#include <cstdint>

namespace repro {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kNgramBase = 0x01000193u;
constexpr uint32_t kLaneSeed0 = 0x2545F491u;
constexpr uint32_t kLaneSeed1 = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// hash_u32(x, seed) = fmix32(x * GOLDEN32 + seed).
__device__ __forceinline__ uint32_t hash_u32(uint32_t x, uint32_t seed) {
  return fmix32(x * kGolden + seed);
}

// fmix32 of sum_k NGRAM_BASE^(n-1-k) * t[k], over t[0..n).
__device__ __forceinline__ uint32_t ngram_hash(const uint32_t* t, int n) {
  uint32_t acc = 0u;
  for (int k = 0; k < n; ++k) acc = acc * kNgramBase + t[k];
  return fmix32(acc);
}

// One lane of a band value: h = lane seed, then h <- hash_u32(h, v[k])
// over the band's r signature entries.
__device__ __forceinline__ uint32_t fold_lane(const uint32_t* v, int r,
                                              uint32_t lane_seed) {
  uint32_t h = lane_seed;
  for (int k = 0; k < r; ++k) h = hash_u32(h, v[k]);
  return h;
}

}  // namespace repro
