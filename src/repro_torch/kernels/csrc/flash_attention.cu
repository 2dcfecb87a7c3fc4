// K8: flash attention forward -- causal and sliding-window masks, GQA --
// on Hopper's tensor cores for bf16 inputs.
//
// Replaces the Pallas kernel repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py:35, pallas_call :127).  Same
// function: q (B, Sq, H, Dh), k and v (B, Skv, Hkv, Dh|Dv) -> out
// (B, Sq, H, Dv) in q's dtype; s = (q . k in float32) x scale; an online
// softmax whose statistics (m, l, acc) are float32 across KV tiles, l
// summing the unrounded float32 p and p rounded to bf16 (RN) only as the A
// operand of the PV product; out = acc / max(l, 1e-30), so a row with
// every key masked gives 0; masks k < Skv, k <= q (causal) and
// k > q - window, positions from 0.  flash_attention_launch is the one
// entry point: bf16 runs here, float32 on the register-tiled IEEE-FMA
// kernel of flash_attention_f32.cu (TF32 cannot meet the float32 tests'
// 3e-5).
//
// What bounds it on this card (H100 SXM, 4 Dh flops per unmasked (q, k)
// pair and head at the tensor cores' dense 989 TFLOP/s, against q, k, v
// and out moved once at 3.35 TB/s): operations at h2o-danube-1.8b's long
// prefill (S 6,144, 32 / 8 heads, Dh 80, window 4,096: 0.174 ms) and at
// olmo-1b's (S 2,048, 16 heads, Dh 128: 0.0174 ms); bytes at gemma-7b's
// (S 1,024, 16 heads, Dh 256: 0.0100 ms).
//
// Design: FlashAttention-2's shape on mma.sync.m16n8k16 (bf16 in, float32
// accumulators).
//   * One block of 8 warps per (batch x KV head, tile of kQRows = 128
//     folded q rows); two blocks an SM at widths up to 80 (the launch
//     bounds cap registers at 128 a thread), one above.  Row
//     r = pos * g + j holds query head hkv * g + j at position pos, the
//     order of q's and out's (B, S, H, D) layout, so the g heads of one KV
//     head share every staged K/V tile (the TPU kernel's GQA fold).  A
//     tile may split a position's heads.  Each warp owns 16 rows.  Blocks
//     run the heaviest (latest) q tiles first.
//   * The block walks its keys, from the window start of its first
//     position to its last position + 1, in tiles of kKeys (64; 48 at
//     Dh 80 and 32 at Dh 256, so that no tier spills), so tiles the masks
//     leave empty are never loaded.  K and V
//     tiles are bf16 in shared memory, rows padded by 8 bf16 so that
//     ldmatrix is free of bank conflicts (Dh 80 is 10 chunks of 16 bytes,
//     not a power of two, so no XOR swizzle), copied by 16-byte cp.async
//     into a 2-stage ring: tile t + 1 loads while tile t computes.  Keys
//     past the block's last one are zero-filled.
//   * S = Q K^T: Q's A fragments stay in registers for the whole key loop
//     (ldmatrix once; at Dh 256 they are read from shared memory per tile,
//     which keeps the float32 O accumulator of 128 registers a thread
//     unspilled); K by ldmatrix.  Head widths are zero-padded to the tier:
//     16, 80, 128 or 256.
//   * Softmax in registers: s x (scale x log2 e), ex2.approx; row max by
//     quad shuffles; masks applied element by element only on tiles that
//     cross the diagonal, the window edge or the last key; the reference's
//     m_safe / corr handling of rows with every key masked.
//   * O += P V: the float32 S fragment, already summed into l, converts
//     pairwise to bf16x2 and is the PV product's A fragment directly, with
//     no trip through shared memory; V by ldmatrix.trans.
//   * Epilogue: O / max(l, 1e-30) to bf16, stored from registers as bf16
//     pairs, rows masked to Sq.
//
// Left for later: wgmma on 64-row warpgroup tiles (mma.sync reaches only
// part of the tensor cores' rate), TMA loads fed by a producer warp, and a
// persistent grid.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQRows = kWarps * 16;  // folded q rows per block
constexpr int kPad = 8;              // bf16 padding per shared-memory row
constexpr int kMaxGroup = 32;        // query heads per KV head (the f32 kernel)
constexpr float kLog2e = 1.4426950408889634f;

// Tile sizes of one head-width tier kD (a multiple of 16).
template <int kD>
struct Tier {
  // Keys per K/V tile: as many as leave the tier unspilled (ptxas -v) at
  // its occupancy; at Dh 80, 64 spill under the cap of 128 registers.
  static constexpr int kKeys = kD == 256 ? 32 : kD == 80 ? 48 : 64;
  static constexpr int kStride = kD + kPad;          // bf16 per smem row
  static constexpr bool kQInRegs = kD <= 128;
  // Q tile, then two stages of K and two of V.
  static constexpr int kSmemBytes = (kQRows + 4 * kKeys) * kStride * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false, 16 zero bytes (src unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b for one 16 x 8 x 16 tile: a (16 x 16, row-major fragment), b
// (16 x 8, column fragment), d float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; a result below 2^-126 flushes to 0
// (p that small is far below what bf16 or l >= 1 can hold).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two float32 values rounded to bf16 (RN), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stages kRows rows of tier kD into shared memory: row i from
// row_ptr(i), or zeros where row_ptr gives nullptr, columns >= width zero.
// 16-byte cp.async copies when vec (width % 8 == 0 and 16-byte aligned
// rows), else one element at a time.
template <int kD, int kRows, class RowPtr>
__device__ __forceinline__ void stage_rows(bf16* dst, int width, bool vec,
                                           const bf16* any, RowPtr row_ptr) {
  constexpr int kChunks = kD / 8, kStride = Tier<kD>::kStride;
  for (int e = threadIdx.x; e < kRows * kChunks; e += kThreads) {
    const int i = e / kChunks, c = (e % kChunks) * 8;
    const bf16* src = row_ptr(i);
    bf16* d = dst + i * kStride + c;
    if (vec) {
      const bool ok = src != nullptr && c < width;
      cp_async16(smem_addr(d), ok ? src + c : any, ok);
    } else {
      for (int x = 0; x < 8; ++x)
        d[x] = src != nullptr && c + x < width ? src[c + x]
                                               : __float2bfloat16_rn(0.f);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, kD <= 80 ? 2 : 1)
flash_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Skv,
    int H, int Hkv, int Dh, int Dv, int causal, int has_window, int window,
    float scale_log2, int vec) {
  using T = Tier<kD>;
  constexpr int kKeys = T::kKeys, kStride = T::kStride;
  constexpr int kSteps = kD / 16;       // k-steps of Q K^T
  constexpr int kKeyTiles = kKeys / 8;  // n-tiles of S
  constexpr int kOutTiles = kD / 8;     // n-tiles of O
  constexpr int kStage = kKeys * kStride;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kQRows * kStride;  // two stages
  bf16* vs = ks + 2 * kStage;        // two stages

  const int g = H / Hkv;
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int64_t rows = static_cast<int64_t>(Sq) * g;
  // The latest q tile, the heaviest under the causal mask, runs first.
  const int64_t row0 =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kQRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // The keys position pos sees: [key_lo(pos), key_hi(pos)).
  auto key_lo = [&](int64_t pos) -> int {
    if (!has_window) return 0;
    const int64_t x = pos - window + 1;
    return static_cast<int>(x < 0 ? 0 : (x > Skv ? Skv : x));
  };
  auto key_hi = [&](int64_t pos) -> int {
    return causal && pos + 1 < Skv ? static_cast<int>(pos + 1) : Skv;
  };
  // The block's positions [pmin, pmax]: it loads keys [lo, hi), and a tile
  // inside [inner_lo, inner_hi) needs no mask for any of its rows.
  const int64_t pmin = row0 / g;
  const int64_t pmax = ((row0 + kQRows < rows ? row0 + kQRows : rows) - 1) / g;
  const int lo = key_lo(pmin), hi = key_hi(pmax);
  const int inner_lo = key_lo(pmax), inner_hi = key_hi(pmin);
  const int n_tiles = lo < hi ? (hi - lo + kKeys - 1) / kKeys : 0;

  // This thread's two accumulator rows, ra and ra + 8 of the warp's 16.
  int klo[2], khi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + warp * 16 + lane / 4 + 8 * h;
    klo[h] = r < rows ? key_lo(r / g) : 0;
    khi[h] = r < rows ? key_hi(r / g) : 0;
  }

  float o[kOutTiles][4];
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    // Key `key` of this KV head: k_head + key * Hkv * Dh, and so for v.
    const int64_t kv0 = static_cast<int64_t>(b) * Skv * Hkv + hkv;
    const bf16* k_head = k + kv0 * Dh;
    const bf16* v_head = v + kv0 * Dv;
    auto stage_kv = [&](int t) {
      const int k0 = lo + t * kKeys;
      stage_rows<kD, kKeys>(
          ks + (t & 1) * kStage, Dh, vec, k, [&](int i) -> const bf16* {
            return k0 + i < hi ? k_head + int64_t{k0 + i} * Hkv * Dh : nullptr;
          });
      stage_rows<kD, kKeys>(
          vs + (t & 1) * kStage, Dv, vec, v, [&](int i) -> const bf16* {
            return k0 + i < hi ? v_head + int64_t{k0 + i} * Hkv * Dv : nullptr;
          });
      cp_async_commit();
    };
    stage_rows<kD, kQRows>(
        qs, Dh, vec, q, [&](int i) -> const bf16* {
          const int64_t r = row0 + i;
          if (r >= rows) return nullptr;
          const int64_t pos = r / g;
          return q + ((static_cast<int64_t>(b) * Sq + pos) * H + hkv * g +
                      (r - pos * g)) * Dh;
        });
    cp_async_commit();
    stage_kv(0);

    // Per-lane ldmatrix offsets (bytes).  A (Q): lanes 0-15 rows 0-15 at
    // column 0, lanes 16-31 at column 8.  B of S (K, keys x width): keys
    // 0-7 then 8-15 of a key pair of n-tiles, each at width offsets 0
    // and 8.  B of O (V, keys x width, transposed): keys 0-7 and 8-15 at
    // width offset 0, then the same at width offset 8.
    const uint32_t q_lane = smem_addr(qs) +
        ((warp * 16 + lane % 16) * kStride + (lane / 16) * 8) * 2;
    const uint32_t k_lane = smem_addr(ks) +
        (((lane / 16) * 8 + lane % 8) * kStride + ((lane / 8) & 1) * 8) * 2;
    const uint32_t v_lane = smem_addr(vs) +
        ((((lane / 8) & 1) * 8 + lane % 8) * kStride + (lane / 16) * 8) * 2;

    uint32_t qf[T::kQInRegs ? kSteps : 1][4];
    if constexpr (T::kQInRegs) {
      cp_async_wait<1>();  // Q has landed; K/V tile 0 may be in flight
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) ldmatrix_x4(qf[kk], q_lane + kk * 32);
    }

    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) {
        stage_kv(t + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile t is in shared memory for every warp
      const uint32_t stage = (t & 1) * kStage * 2;

      float s[kKeyTiles][4];
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t a[4];
        if constexpr (T::kQInRegs) {
          a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2],
          a[3] = qf[kk][3];
        } else {
          ldmatrix_x4(a, q_lane + kk * 32);
        }
#pragma unroll
        for (int np = 0; np < kKeyTiles / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, k_lane + stage + (np * 16 * kStride + kk * 16) * 2);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // Scale into log2 units; mask only tiles that cross an edge.
      const int k0 = lo + t * kKeys;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale_log2;
      if (k0 < inner_lo || k0 + kKeys > inner_hi) {
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + nt * 8 + 2 * (lane % 4) + (e & 1);
            if (key < klo[e / 2] || key >= khi[e / 2])
              s[nt][e] = -CUDART_INF_F;
          }
      }

      float corr[2], m_safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        m_safe[h] = isfinite(m_new) ? m_new : 0.f;
        corr[h] = isfinite(m[h]) ? ex2(m[h] - m_safe[h]) : 0.f;
        m[h] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = ex2(s[nt][e] - m_safe[e / 2]);  // ex2(-inf) = 0
          psum[e / 2] += s[nt][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + psum[h];
#pragma unroll
      for (int dt = 0; dt < kOutTiles; ++dt) {
        o[dt][0] *= corr[0], o[dt][1] *= corr[0];
        o[dt][2] *= corr[1], o[dt][3] *= corr[1];
      }

      // O += P V, P's bf16 A fragment straight from S's accumulators.
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kD / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv,
                            v_lane + stage + (kk * 16 * kStride + dp * 16) * 2);
          mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
      __syncthreads();  // every warp is done with tile t's stage
    }
  }

  // l was summed per thread over its columns; the quad holds the row.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xFFFFFFFFu, l[h], 1);
    l[h] += __shfl_xor_sync(0xFFFFFFFFu, l[h], 2);
    const int64_t r = row0 + warp * 16 + lane / 4 + 8 * h;
    if (r >= rows) continue;
    const int64_t pos = r / g;
    bf16* orow = out + ((static_cast<int64_t>(b) * Sq + pos) * H + hkv * g +
                        (r - pos * g)) * Dv;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < kOutTiles; ++dt) {
      const int d = dt * 8 + 2 * (lane % 4);
      const float x0 = o[dt][2 * h] / denom, x1 = o[dt][2 * h + 1] / denom;
      if (vec) {  // Dv % 8 == 0: d < Dv implies d + 1 < Dv
        if (d < Dv) *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16(x0, x1);
      } else {
        if (d < Dv) orow[d] = __float2bfloat16_rn(x0);
        if (d + 1 < Dv) orow[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Skv, int H, int Hkv, int Dh, int Dv, int causal,
                int has_window, int window, float scale, cudaStream_t stream) {
  constexpr int kSmem = Tier<kD>::kSmemBytes;
  if constexpr (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t rows = static_cast<int64_t>(Sq) * (H / Hkv);
  const dim3 grid(static_cast<unsigned>((rows + kQRows - 1) / kQRows),
                  B * Hkv);
  const int vec = Dh % 8 == 0 && Dv % 8 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(out);
  flash_attention_bf16_kernel<kD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, H, Hkv,
      Dh, Dv, causal, has_window, window, scale * kLog2e, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The IEEE float32 kernel (flash_attention_f32.cu).
int flash_attention_f32_launch(const float* q, const float* k, const float* v,
                               float* out, int B, int Sq, int Skv, int H,
                               int Hkv, int Dh, int Dv, int causal,
                               int has_window, int window, float scale,
                               cudaStream_t stream);

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int Hkv, int Dh, int Dv,
                                      int causal, int has_window, int window,
                                      float scale, int bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxGroup || B * static_cast<int64_t>(Hkv) > 65535 ||
      Dh <= 0 || Dv <= 0 || Dh > 256 || Dv > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return flash_attention_f32_launch(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), B, Sq, Skv, H,
        Hkv, Dh, Dv, causal, has_window, window, scale, s);
  const int width = Dh > Dv ? Dh : Dv;
  // The ported configs' head widths: 16 (reduced), 80 (h2o-danube), 128
  // (olmo, phi3) and 256 (gemma).  Any other width runs zero-padded in the
  // next tier up.
  if (width <= 16)
    return launch_bf16<16>(q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv, causal,
                           has_window, window, scale, s);
  if (width <= 80)
    return launch_bf16<80>(q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv, causal,
                           has_window, window, scale, s);
  if (width <= 128)
    return launch_bf16<128>(q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv, causal,
                            has_window, window, scale, s);
  return launch_bf16<256>(q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv, causal,
                          has_window, window, scale, s);
}
