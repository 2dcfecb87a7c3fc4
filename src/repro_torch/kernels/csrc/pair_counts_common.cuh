// The body shared by K2 (sigjaccard.cu) and K7 (sigjaccard_masked.cu):
// count the words on which two signature rows of M uint32 words agree.
//
// What bounds it on the card: device-memory bytes.  A pair reads two rows
// of M words at random places of the matrix, so at paper scale (a 419 MB
// matrix, far past the 50 MB L2) every gathered row streams from HBM, and
// the floor is the gathered bytes (2 x 4M a pair) over 3.35 TB/s.  What
// reaches it is many rows in flight at once, each read in as few
// instructions as possible.  The design:
//
//   * Lane groups sized to M.  A row is ceil(M/4) chunks of 16 bytes.  A
//     pair gets G lanes (a power of two up to 32), the fewest that cover
//     the row in kBatch chunks a lane, so a warp holds 32/G pairs at once.
//     At M = 100: 25 chunks, G = 16, 2 pairs a warp, 2 chunks a lane; 25
//     of the 32 chunk slots a group has are used (78 %, as the warp-per-
//     pair kernel's 100 words over 4 passes of 32 lanes), but a warp now
//     has 2 pairs' rows in flight where it had one, with 4 loads of 16
//     bytes a lane where it took 8 of 4 bytes.  kBatch = 2 trades pairs
//     a warp against how much of a row one lane's loads cover.
//   * 16-byte loads through the read-only path (__ldg of uint4), every
//     load of both rows issued before the first compare.  They need
//     M % 4 == 0 and 16-byte-aligned bases; otherwise the scalar path runs
//     with the same lane map, one 4-byte load a word.  The launcher picks
//     the path from M and the pointers (schedule()).
//   * The group's partial counts are summed by xor shuffles; all 32 lanes
//     stay converged, idle ones with nothing to load.
//   * The grid is sized to the card (SMs x resident blocks), and warps
//     stride over the work.
//
// Counts are int32 and exact; the caller divides by M.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pair_counts {

constexpr int kBlock = 256;              // threads a block
constexpr int kWarps = kBlock / 32;      // warps a block
// Blocks an SM the kernels are compiled for: at most 64 registers a
// thread.  With no minimum ptxas packs them into 32 registers and spills.
constexpr int kMinBlocks = 4;
constexpr int kBatch = 2;  // chunks a lane loads per row before comparing
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

// Lanes per pair: the least power of two (at most 32) with G * kBatch >=
// ceil(M / 4).  The launchers report it through pair_counts_schedule.
__host__ __device__ constexpr int lane_group(int M) {
  const int chunks = (M + 3) / 4;
  const int need = (chunks + kBatch - 1) / kBatch;
  int g = 1;
  while (g < need && g < 32) g <<= 1;
  return g;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// What the launchers run for rows of M words at bases a and b: +G for the
// 16-byte path, -G for the scalar path.
inline int schedule(int M, const void* a, const void* b) {
  const int g = lane_group(M);
  return M % 4 == 0 && aligned16(a) && aligned16(b) ? g : -g;
}

// Chunk j (words 4j .. 4j+3) of row r.  Words at or past M read as `fill`,
// which the caller makes differ between the two rows.
template <bool kVec>
__device__ __forceinline__ uint4 load_chunk(const uint32_t* __restrict__ r,
                                            int j, int M, uint32_t fill) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(r) + j);
  } else {
    const int w = 4 * j;  // w < M: j is a chunk of the row
    uint4 v;
    v.x = __ldg(r + w);
    v.y = w + 1 < M ? __ldg(r + w + 1) : fill;
    v.z = w + 2 < M ? __ldg(r + w + 2) : fill;
    v.w = w + 3 < M ? __ldg(r + w + 3) : fill;
    return v;
  }
}

__device__ __forceinline__ int agree4(uint4 a, uint4 b) {
  return (a.x == b.x) + (a.y == b.y) + (a.z == b.z) + (a.w == b.w);
}

// This lane's share of the agreement count of rows ra and rb: chunks sub,
// sub + G, sub + 2G, ..., kBatch of them loaded from both rows before any
// compare.  A lane that is not `active` loads nothing and counts 0.
template <int G, bool kVec>
__device__ __forceinline__ int lane_agree(const uint32_t* __restrict__ ra,
                                          const uint32_t* __restrict__ rb,
                                          int M, int sub, bool active) {
  const int chunks = (M + 3) >> 2;
  int c = 0;
  // One pass for M <= 256 (lane_group covers the row in kBatch chunks).
  for (int base = 0; base < chunks; base += kBatch * G) {
    uint4 va[kBatch], vb[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = base + sub + k * G;
      if (active && j < chunks) {
        va[k] = load_chunk<kVec>(ra, j, M, 0u);
        vb[k] = load_chunk<kVec>(rb, j, M, kFull);
      } else {
        va[k] = make_uint4(0u, 0u, 0u, 0u);
        vb[k] = make_uint4(kFull, kFull, kFull, kFull);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) c += agree4(va[k], vb[k]);
  }
  return c;
}

// The sum of c over this lane's group of G lanes, in every lane of it.
template <int G>
__device__ __forceinline__ int group_sum(int c) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  return c;
}

// Position of the k-th (from 0) set bit of mask; mask has more than k.
__device__ __forceinline__ int nth_set_bit(unsigned mask, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int low = __popc(mask & ((1u << w) - 1u));
    if (k >= low) {
      k -= low;
      mask >>= w;
      pos += w;
    }
  }
  return pos;
}

// Blocks of Kernel the current card holds at once (SMs x resident blocks
// an SM), found once per device.
template <auto Kernel>
int card_blocks() {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kBlock,
                                                      0) != cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

// Grid for `warp_tasks` pieces of work, one a warp at a time: no more
// blocks than the work needs or the card holds.  0 if the card cannot be
// queried.
template <auto Kernel>
unsigned grid_for(int64_t warp_tasks) {
  const int64_t fit = card_blocks<Kernel>();
  const int64_t need = (warp_tasks + kWarps - 1) / kWarps;
  return static_cast<unsigned>(need < fit ? need : fit);
}

// Run Launch::run<G, kVec>(args...) for the schedule s (+G or -G).
template <class Launch, class... Args>
cudaError_t dispatch(int s, Args... args) {
  const bool vec = s > 0;
  switch (s > 0 ? s : -s) {
    case 1: return vec ? Launch::template run<1, true>(args...)
                       : Launch::template run<1, false>(args...);
    case 2: return vec ? Launch::template run<2, true>(args...)
                       : Launch::template run<2, false>(args...);
    case 4: return vec ? Launch::template run<4, true>(args...)
                       : Launch::template run<4, false>(args...);
    case 8: return vec ? Launch::template run<8, true>(args...)
                       : Launch::template run<8, false>(args...);
    case 16: return vec ? Launch::template run<16, true>(args...)
                        : Launch::template run<16, false>(args...);
    case 32: return vec ? Launch::template run<32, true>(args...)
                        : Launch::template run<32, false>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pair_counts
