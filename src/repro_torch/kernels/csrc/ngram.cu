// K3: rolling n-gram hashes -- fmix32 of the base-NGRAM_BASE polynomial of
// every length-n token window of a packed (D, L) token matrix -- and their
// validity, in one pass.
//
// Replaces the Pallas kernel repro.kernels.ngram.ngram_hashes (body
// _ngram_kernel), validity included: position l of a row of length len is
// valid iff l + n <= len, or l == 0 and 0 < len < n.  The Pallas kernel read
// each (8, 256) tile plus the next tile as a halo, clamped at the last tile,
// so its windows past column L - n read tokens of the tile itself; those
// positions are never valid.  Here a window past column L reads zeros, as K1
// and the plain core/shingle.ngram_hashes do.
//
// What bounds it on the card: device-memory bytes.  Each position moves a
// token in, a hash out and a validity flag out, 9 bytes; its hash costs
// about two multiply-adds and fmix32 (below), a fifth of the bytes' time at
// n = 8.  The design is a flat stream:
//
//   * The (D, L) matrix is a flat array of quads of positions.  The grid is
//     sized to the card (SMs x resident blocks) and walks tiles of kTile
//     quads, kQuads a thread (two 16-byte loads of each thread in flight);
//     a block stages its tile and the (n + 2) / 4 quads after it in shared
//     memory, each with one 16-byte load, and each thread writes a quad's
//     four hashes with one 16-byte store and its four flags with one 4-byte
//     store.  A quad never spans two rows (L % 4 ==
//     0), so one load of lengths and one column test a staged quad serve
//     the whole quad.
//   * The four windows of a quad roll: acc' = acc * B - t[l] * B^n +
//     t[l + n], exact in uint32 wraparound, so a quad costs n + 6
//     multiply-adds where four windows from scratch cost 4n.  The bytes
//     bound the kernel either way; the roll keeps the operations, at n = 8
//     a tenth of the bytes' time, off the critical path for longer n.
//   * Where L % 4 != 0 or a base is not aligned (16 bytes for tokens and
//     hashes, 4 for the flags), the same walk runs with 4-byte loads, each
//     position hashing its own window with its own row's column test: the
//     scalar path.  ngram_hashes_schedule reports which path a launch takes.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash_common.cuh"

namespace {

using repro::kNgramBase;

constexpr int kThreads = 256;
constexpr int kQuads = 2;                  // quads a thread a tile
constexpr int kTile = kThreads * kQuads;   // quads a tile
constexpr int kMaxDevices = 64;

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// 1: the 16-byte path; 0: the scalar path.
int schedule(const void* tokens, const void* hashes, const void* valid,
             int L) {
  return L % 4 == 0 && aligned(tokens, 16) && aligned(hashes, 16) &&
         aligned(valid, 4);
}

// How many positions of a row of length len are valid: they are a prefix.
__device__ __forceinline__ int nvalid(int len, int n) {
  return len >= n ? len - n + 1 : (len > 0 ? 1 : 0);
}

// Element k (0 <= k < 8) of the eight words a, b.
__device__ __forceinline__ uint32_t pick(const uint4& a, const uint4& b,
                                         int k) {
  const uint32_t lo = k & 2 ? (k & 1 ? a.w : a.z) : (k & 1 ? a.y : a.x);
  const uint32_t hi = k & 2 ? (k & 1 ? b.w : b.z) : (k & 1 ? b.y : b.x);
  return k & 4 ? hi : lo;
}

// The hashes and flags of the quad at flat position p0 (row, col), from its
// staged window w4: quad 0 is its own tokens, the next (n + 2) / 4 follow.
template <bool kVec>
__device__ __forceinline__ void hash_quad(
    const uint4* w4, const int32_t* __restrict__ lengths,
    uint32_t* __restrict__ hashes, bool* __restrict__ valid, int64_t total,
    int64_t p0, int64_t row, int col, int L, int n, uint32_t bn) {
  if (kVec) {
    // Quad u of the window is zeros where it lies past column L.
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    uint32_t acc = 0u;
    int u = 0;
    for (; 4 * u + 4 <= n; ++u) {
      const uint4 v = col + 4 * u < L ? w4[u] : zero;
      acc = acc * kNgramBase + v.x;
      acc = acc * kNgramBase + v.y;
      acc = acc * kNgramBase + v.z;
      acc = acc * kNgramBase + v.w;
    }
    // Words n .. n + 2 lie in quads u and u + 1, from word r of quad u.
    const int r = n - 4 * u;
    const uint4 a = col + 4 * u < L ? w4[u] : zero;
    const uint4 b = r >= 2 && col + 4 * u + 4 < L ? w4[u + 1] : zero;
    if (r > 0) acc = acc * kNgramBase + a.x;
    if (r > 1) acc = acc * kNgramBase + a.y;
    if (r > 2) acc = acc * kNgramBase + a.z;
    const uint4 own = w4[0];
    uint32_t h[4];
    h[0] = repro::fmix32(acc);
    acc = acc * kNgramBase + pick(a, b, r) - own.x * bn;
    h[1] = repro::fmix32(acc);
    acc = acc * kNgramBase + pick(a, b, r + 1) - own.y * bn;
    h[2] = repro::fmix32(acc);
    acc = acc * kNgramBase + pick(a, b, r + 2) - own.z * bn;
    h[3] = repro::fmix32(acc);
    reinterpret_cast<uint4*>(hashes)[p0 >> 2] =
        make_uint4(h[0], h[1], h[2], h[3]);
    const int nv = nvalid(__ldg(lengths + row), n);
    reinterpret_cast<uint32_t*>(valid)[p0 >> 2] =
        (col < nv ? 1u : 0u) | (col + 1 < nv ? 1u << 8 : 0u) |
        (col + 2 < nv ? 1u << 16 : 0u) | (col + 3 < nv ? 1u << 24 : 0u);
  } else {
    // Each position its own window and row: a quad may span rows.
    const uint32_t* tok = reinterpret_cast<const uint32_t*>(w4);
#pragma unroll 1
    for (int j = 0; j < 4 && p0 + j < total; ++j) {
      uint32_t acc = 0u;
      for (int k = 0; k < n; ++k)
        acc = acc * kNgramBase + (col + k < L ? tok[j + k] : 0u);
      hashes[p0 + j] = repro::fmix32(acc);
      valid[p0 + j] = col < nvalid(__ldg(lengths + row), n);
      if (++col == L) {
        col = 0;
        ++row;
      }
    }
  }
}

// Grid-stride over tiles of kTile quads, kQuads a thread: quads threadIdx.x
// + j kThreads of the tile.  Shared memory: tok4[kTile + halo] (the tile's
// tokens and the halo after it, zeros past the matrix).  bn = B^n.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) ngram_hashes_kernel(
    const uint32_t* __restrict__ tokens, const int32_t* __restrict__ lengths,
    uint32_t* __restrict__ hashes, bool* __restrict__ valid, int64_t D, int L,
    int n, uint32_t bn, int halo) {
  extern __shared__ __align__(16) uint4 tok4[];
  const int64_t total = D * L;
  const int64_t quads = (total + 3) / 4;
  const int span = kTile + halo;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTile;
  // Row and column of each of this thread's quads, moved by the stride's
  // rows and columns each tile: no division in the walk.
  const int64_t step_rows = 4 * stride / L;
  const int step_cols = static_cast<int>(4 * stride - step_rows * L);
  int64_t row[kQuads];
  int col[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int64_t p = 4 * (static_cast<int64_t>(blockIdx.x) * kTile +
                           j * kThreads + threadIdx.x);
    row[j] = p / L;
    col[j] = static_cast<int>(p - row[j] * L);
  }

  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile; t0 < quads;
       t0 += stride) {
    for (int i = threadIdx.x; i < span; i += kThreads) {
      const int64_t qi = t0 + i;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kVec) {
        if (qi < quads) v = __ldg(reinterpret_cast<const uint4*>(tokens) + qi);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * qi + k < total) w[k] = __ldg(tokens + 4 * qi + k);
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      tok4[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int lq = j * kThreads + threadIdx.x;
      const int64_t p0 = 4 * (t0 + lq);
      if (p0 < total)
        hash_quad<kVec>(tok4 + lq, lengths, hashes, valid, total, p0, row[j],
                        col[j], L, n, bn);
      row[j] += step_rows;
      col[j] += step_cols;
      if (col[j] >= L) {
        col[j] -= L;
        ++row[j];
      }
    }
    __syncthreads();
  }
}

// Blocks of the kernel the current card holds at once (SMs x resident
// blocks an SM at this shared memory), found once per device and size; 0 if
// the card cannot be queried.
template <bool kVec>
int64_t card_blocks(size_t smem) {
  static int64_t blocks[kMaxDevices] = {};
  static size_t sized[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (blocks[dev] == 0 || sized[dev] != smem) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ngram_hashes_kernel<kVec>, kThreads, smem) != cudaSuccess)
      return 0;
    blocks[dev] = static_cast<int64_t>(sms) * per_sm;
    sized[dev] = smem;
  }
  return blocks[dev];
}

template <bool kVec>
cudaError_t launch(const void* tokens, const void* lengths, void* hashes,
                   void* valid, int64_t D, int L, int n, cudaStream_t stream) {
  const int halo = (n + 2) / 4;
  const size_t smem = sizeof(uint4) * static_cast<size_t>(kTile + halo);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ngram_hashes_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t fit = card_blocks<kVec>(smem);
  if (fit <= 0) return cudaErrorInvalidValue;
  const int64_t tiles = ((D * L + 3) / 4 + kTile - 1) / kTile;
  uint32_t bn = 1u;
  for (int k = 0; k < n; ++k) bn *= kNgramBase;
  ngram_hashes_kernel<kVec><<<static_cast<unsigned>(tiles < fit ? tiles : fit),
                              kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(tokens), static_cast<const int32_t*>(lengths),
      static_cast<uint32_t*>(hashes), static_cast<bool*>(valid), D, L, n, bn,
      halo);
  return cudaGetLastError();
}

}  // namespace

// The path a launch over these base pointers and rows of L tokens takes: 1
// for the 16-byte path, 0 for the scalar path.
extern "C" int ngram_hashes_schedule(const void* tokens, const void* hashes,
                                     const void* valid, int L) {
  return schedule(tokens, hashes, valid, L);
}

extern "C" int ngram_hashes_launch(const void* tokens, const void* lengths,
                                   void* hashes, void* valid, int64_t D, int L,
                                   int n, void* stream) {
  if (D <= 0 || D > 0x7FFFFFFF || L <= 0 || n <= 0 || n > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      schedule(tokens, hashes, valid, L)
          ? launch<true>(tokens, lengths, hashes, valid, D, L, n, s)
          : launch<false>(tokens, lengths, hashes, valid, D, L, n, s));
}
