// K1: fused ingest -- rolling n-gram hash -> seeded minhash min -> two-lane
// band fold, in one pass over a packed (D, L) token matrix.
//
// Replaces the Pallas kernel repro.kernels.fused_ingest.fused_ingest
// (body _fused_kernel).  On the TPU the L axis was the innermost,
// sequential grid axis and the running minimum sat in the resident output
// block; here blocks run in any order, so the L axis is a loop inside the
// block and the running minima live in registers, then in shared memory.
//
// What bounds it on the card: integer work.  Every (document, valid
// position, seed) triple costs the seed's multiply-add, fmix32 (two
// multiplies, three shifts, three xors) and half a min (sm_90's
// three-input min takes two values at once).  Multiplies issue to the FMA
// pipe and xors and mins to the ALU pipe.  A right shift can run on the
// FMA pipe as the high word of a product, x >> k == hi32(x * 2^(32-k)),
// but on the H100 IMAD.HI and IMAD.WIDE issue at half IMAD's rate (31.4
// and 31.6 against 63.6 lanes an SM and clock, PERF.md), so a shift moved
// there costs the FMA pipe two slots and saves the ALU pipe one; measured,
// every such form was slower.  The shifts stay on the ALU
// pipe (SHF): 6.6 ALU and 3.1 FMA instructions a triple, 0.104 clocks a
// triple at full issue (a loop of one thread a seed took 7.25 and 0.113).
// The bytes moved (tokens in; signatures, bands and validity out) take a
// sixth of the operations' time at the memory rate.  The design:
//
//   * The lane map and the walk of minhash_pool_common.cuh, shared with K4
//     (fused_ingest_schedule reports the map): S seeds a lane in
//     registers, ceil(M / S) lanes a group, several rows a block sharing
//     one pool of hashes in shared memory (8 at L = 256, so the block's
//     fixed costs -- its launch, three barriers, the latency of its first
//     loads -- are shared), 16-byte broadcast reads of four hashes.  At
//     M = 100: S = 4, 5 groups of 25 lanes, 125 of 128 lanes (78 % with
//     one lane a seed).
//   * K1 fills the pool itself: each row's n-gram hashes in turn, padded to
//     whole quads with the row's first hash.  The rows' tokens reach shared
//     memory by cp.async, the validity flags leave four to a store.
//
// Bits: every operation is uint32 arithmetic with wraparound, as in the
// JAX kernel.  The window of position l reads the matrix's own values up
// to column L (past a document's length too) and zeros past L; position l
// is valid iff l + n <= len, or l == 0 and 0 < len < n; a document with no
// valid position gets 0xFFFFFFFF in every signature entry.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash_common.cuh"
#include "minhash_pool_common.cuh"

namespace {

using minhash_pool::for_cells;
using minhash_pool::kMaxDocs;
using minhash_pool::kMinBlocks;
using minhash_pool::kThreads;
using minhash_pool::Plan;
using repro::kLaneSeed0;
using repro::kLaneSeed1;

size_t smem_bytes(const Plan& p, int M, int n) {
  return sizeof(uint32_t) * static_cast<size_t>(p.docs) *
         (2 * static_cast<size_t>(p.tile) + n - 1 + static_cast<size_t>(M));
}

// A 4-byte copy from device memory to shared memory that the thread does
// not wait for (cp.async); zeros where `fill` is false.
__device__ __forceinline__ void copy_async(uint32_t* dst, const uint32_t* src,
                                           bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory: pool[docs x tile] (a round's n-gram hashes, document by
// document, each padded to whole quads; 16-byte aligned), tok[docs][tile +
// n - 1] (a round's tokens with the window halo), part[docs][M] (running
// minima).
template <int S>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fused_ingest_kernel(
    const uint32_t* __restrict__ tokens, const int32_t* __restrict__ lengths,
    const uint32_t* __restrict__ seeds, uint32_t* __restrict__ sig,
    uint32_t* __restrict__ bands, bool* __restrict__ valid, int64_t D, int L,
    int M, int n, int r, Plan p) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int nv[kMaxDocs];          // valid positions of each document
  __shared__ int qs[kMaxDocs + 1];      // its first quad in the pool
  const int tile = p.tile, span = p.tile + n - 1;
  uint32_t* pool = smem;
  uint32_t* tok = pool + p.docs * tile;
  uint32_t* part = tok + p.docs * span;

  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * p.docs;
  const int ndocs = static_cast<int>(D - d0 < p.docs ? D - d0 : p.docs);
  // This lane: seed lane g of lane group q.
  const int g = threadIdx.x % p.lanes;
  const int q = threadIdx.x / p.lanes;
  uint32_t s0[S];
  minhash_pool::first_seeds(seeds, g, M, s0);

  if (threadIdx.x < 32) {  // valid positions, and each row's first quad
    int v = 0;
    if (threadIdx.x < ndocs) {
      const int len = __ldg(lengths + d0 + threadIdx.x);
      v = min(L, len >= n ? len - n + 1 : (len > 0 ? 1 : 0));
      nv[threadIdx.x] = v;
    }
    int c = (min(v, tile) + 3) >> 2;  // quads in the first round
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, c, o);
      if (threadIdx.x >= o) c += up;
    }
    if (threadIdx.x < ndocs) qs[threadIdx.x + 1] = c;
    if (threadIdx.x == 0) qs[0] = 0;
  }
  for (int i = threadIdx.x; i < ndocs * M; i += kThreads) part[i] = 0xFFFFFFFFu;
  // The first round's tokens (zeros past column L), in flight meanwhile.
  for_cells(ndocs, span, [&](int bb, int j) {
    const uint32_t* row = tokens + (d0 + bb) * L;
    copy_async(tok + bb * span + j, row + (j < L ? j : 0), j < L);
  });
  copy_async_wait_all();
  __syncthreads();
  // Block-uniform: several documents a block each fit one round.
  const int rounds = p.docs == 1 ? (nv[0] + tile - 1) / tile : 1;

  for (int rd = 0; rd < rounds; ++rd) {
    const int l0 = rd * tile;
    if (rd > 0) {  // a long row: the next round's tokens
      __syncthreads();  // the previous round's readers are done
      for (int j = threadIdx.x; j < span; j += kThreads)
        copy_async(tok + j, tokens + d0 * L + (l0 + j < L ? l0 + j : 0),
                   l0 + j < L);
      copy_async_wait_all();
      __syncthreads();
    }
    const int nq_round = p.docs == 1 ? (min(tile, nv[0] - l0) + 3) >> 2 : 0;
    // The round's n-gram hashes; a row's last quad is padded with its
    // first hash of the round.
    for_cells(ndocs, tile, [&](int bb, int j) {
      const int nt = min(tile, nv[bb] - l0);
      if (j < ((nt + 3) & ~3))
        pool[4 * qs[bb] + j] =
            repro::ngram_hash(tok + bb * span + (j < nt ? j : 0), n);
    });
    __syncthreads();
    minhash_pool::walk_pool(p, g, q, s0, seeds, M, pool, ndocs, [&](int bb) {
      return p.docs == 1 ? nq_round : qs[bb + 1];
    }, part);
    __syncthreads();
  }

  for_cells(ndocs, M, [&](int bb, int m) {
    sig[(d0 + bb) * M + m] = part[bb * M + m];
  });
  const int nb = M / r;
  for_cells(ndocs, 2 * nb, [&](int bb, int j) {
    bands[(d0 + bb) * 2 * nb + j] = repro::fold_lane(
        part + bb * M + (j >> 1) * r, r, (j & 1) ? kLaneSeed1 : kLaneSeed0);
  });
  if ((L & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(valid) & 3) == 0) {
    // Four flags a 4-byte store.
    uint32_t* vw = reinterpret_cast<uint32_t*>(valid + d0 * L);
    for_cells(ndocs, L >> 2, [&](int bb, int w) {
      const int l = 4 * w, v = nv[bb];
      vw[bb * (L >> 2) + w] = (l < v ? 1u : 0u) | (l + 1 < v ? 1u << 8 : 0u) |
                              (l + 2 < v ? 1u << 16 : 0u) |
                              (l + 3 < v ? 1u << 24 : 0u);
    });
  } else {
    for_cells(ndocs, L, [&](int bb, int l) {
      valid[(d0 + bb) * L + l] = l < nv[bb];
    });
  }
}

struct Launch {
  template <int S>
  static cudaError_t run(const Plan& p, const void* tokens, const void* lengths,
                         const void* seeds, void* sig, void* bands, void* valid,
                         int64_t D, int L, int M, int n, int r,
                         cudaStream_t stream) {
    const size_t smem = smem_bytes(p, M, n);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fused_ingest_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    const int64_t grid = (D + p.docs - 1) / p.docs;
    fused_ingest_kernel<S><<<static_cast<unsigned>(grid), kThreads, smem,
                             stream>>>(
        static_cast<const uint32_t*>(tokens),
        static_cast<const int32_t*>(lengths),
        static_cast<const uint32_t*>(seeds), static_cast<uint32_t*>(sig),
        static_cast<uint32_t*>(bands), static_cast<bool*>(valid), D, L, M, n,
        r, p);
    return cudaGetLastError();
  }
};

}  // namespace

// The lane map a launch over rows of L tokens with M seeds takes:
// out = {threads, S, lanes, passes, slices, docs, tile}.
extern "C" int fused_ingest_schedule(int M, int L, int32_t* out) {
  if (M <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  minhash_pool::write_plan(minhash_pool::make_plan(M, L), out);
  return 0;
}

extern "C" int fused_ingest_launch(const void* tokens, const void* lengths,
                                   const void* seeds, void* sig, void* bands,
                                   void* valid, int64_t D, int L, int M, int n,
                                   int r, void* stream) {
  if (D <= 0 || D > 0x7FFFFFFF || L <= 0 || M <= 0 || n <= 0 || r <= 0 ||
      M % r != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(minhash_pool::dispatch<Launch>(
      minhash_pool::make_plan(M, L), tokens, lengths, seeds, sig, bands, valid,
      D, L, M, n, r, static_cast<cudaStream_t>(stream)));
}
