// K8, float32: flash attention forward on IEEE float32 FMAs -- causal and
// sliding-window masks, GQA.
//
// Replaces the float32 case of the Pallas kernel
// repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py:35, pallas_call :127).
// flash_attention_launch (flash_attention.cu) routes float32 inputs here
// and bf16 inputs to the tensor-core kernel.  Same function: q
// (B, Sq, H, Dh), k and v (B, Skv, Hkv, Dh|Dv) -> out (B, Sq, H, Dv); an
// online softmax whose statistics (m, l, acc) are float32 across KV tiles;
// out = acc / max(l, 1e-30), so a row with every key masked gives 0; masks
// k < Skv, k <= q (causal) and k > q - window, positions from 0.
//
// Why not the tensor cores: the float32 tests hold K8 to 3e-5
// (test_kernels.py's tolerance), which TF32's 10-bit mantissa cannot meet,
// so every product here is an IEEE float32 FMA: no HMMA, no TF32, no
// split into high and low parts.
//
// What bounds it on this card (H100 SXM): operations, 2 Dh FMAs an
// unmasked (q, k) pair and head on the 128 FP32 lanes of each of 132 SMs
// (67 TFLOP/s at 1.98 GHz); q, k, v and out move once in far less time.
// An SM issues one FMA a lane a clock only if nothing else takes the issue
// slot, so the design keeps shared-memory loads, shuffles and the softmax
// off the inner loops.
//
// Design: FlashAttention-2's shape on the CUDA cores, register-tiled.
//   * One block per (batch x KV head, tile of kRows folded q rows): row
//     r = pos * g + j holds query head hkv * g + j at position pos (q's and
//     out's (B, S, H, D) order), so the g heads of one KV head share every
//     staged K/V tile (the TPU kernel's GQA fold); a tile may split a
//     position's heads.  The grid is one-dimensional and tile-major, the
//     latest (heaviest) q tiles first, so every KV head's heavy tiles start
//     before any light one.
//   * Thread (ty, tx) of kRY x kRX (the kRX lanes of a row group are
//     neighbours in a warp) owns kTM = 4 rows, ty + kRY * i, and of every
//     tile of kKeys = 32 keys the kTN = 32 / kRX keys tx + kRX * j: a
//     4 x kTN micro-tile of S.  By tier: 128 threads, kRX 4 and 128 rows
//     up to width 80; 128 threads, kRX 8 and 64 rows at 128; 256 threads,
//     kRX 16 and 64 rows at 256, whose O accumulator of 4 rows x 256
//     columns would not fit 8 lanes' registers.  S = Q K^T walks the head
//     width four columns at a time: a 16-byte load of each of the
//     thread's 4 q rows and of its kTN k rows feeds 16 kTN FMAs (10.7 a
//     load at kRX 4, 8 at kRX 8, 5.3 at kRX 16).  Row strides of width + 4
//     floats keep those loads free of bank conflicts; the kRX lanes of a
//     row read one q row (a broadcast), the kRY row groups of a warp one k
//     row.
//   * Softmax once a key tile: scores times scale x log2 e (one multiply
//     a score, before the mask, so any sign of scale works), the row max
//     over the thread's keys, then over its kRX lanes (log2 kRX shuffles a
//     row a tile, none a score); p = ex2.approx(s - m); l summed per
//     thread and over the lanes at the end.  Masks are applied element by element only on tiles that cross
//     the diagonal, the window edge or the last key; interior tiles skip
//     the compares and the isfinite test.  p goes to shared memory
//     (kRows x 32, stride 32 + kRX: conflict-free both ways).
//   * O += P V: the thread owns the same 4 rows x kTD float4 columns, tx +
//     kRX * c (width / (4 kRX) of them: 5 at width 80), and walks the
//     tile's keys four at a time: one 16-byte p load a row, then one
//     16-byte v load a key and column group, each feeding 16 FMAs (64 kTD
//     FMAs for 4 + 4 kTD loads).  Head widths pad to the tier (16, 80, 128,
//     256) only as the micro-tile needs: h2o-danube's 80 pads nothing.
//   * The block walks its keys from the window start of its first position
//     to its last position + 1, so tiles the masks leave empty are never
//     loaded.  K and V tiles are copied by cp.async (16 bytes when the
//     widths are multiples of 4 and the bases aligned, else 4) into a
//     2-stage ring: tile t + 1 loads while tile t computes; keys past the
//     block's last one are zero-filled.  Q is staged once.  One block
//     barrier a tile (tile t landed, tile t - 1 consumed); a row's p is
//     written and read back only by its kRX lanes, in one warp, so a warp
//     barrier orders it.
//   * Epilogue: O / max(l, 1e-30), stored from registers, rows masked to Sq.
//
// What holds it back (ptxas: 168, 254, 204 and 214 registers by tier, no
// spills; dynamic shared memory 38,912, 104,448, 111,616 and 211,968
// bytes, so two blocks an SM up to width 128, one at 256; the SM clock stays
// at its maximum under this load): two warps a scheduler at width 80, so
// the barrier, the softmax's shuffle and ex2 chain and the loads' latency
// show through; at 256 the 5.3 FMAs a load of S = Q K^T.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kKeys = 32;  // keys per K/V tile, every tier
constexpr int kTM = 4;     // rows per thread
constexpr float kLog2e = 1.4426950408889634f;

// Tile sizes of one head-width tier kD (a multiple of 4 kRX).
template <int kD>
struct Tier {
  static constexpr int kThreads = kD <= 128 ? 128 : 256;
  static constexpr int kRX = kD <= 80 ? 4 : kD <= 128 ? 8 : 16;  // lanes a row
  static constexpr int kRY = kThreads / kRX;     // row groups
  static constexpr int kRows = kRY * kTM;        // folded q rows a block
  static constexpr int kTN = kKeys / kRX;        // keys a thread, a tile
  static constexpr int kTD = kD / (4 * kRX);     // float4 columns a thread
  static constexpr int kStride = kD + 4;         // floats a Q, K, V row
  static constexpr int kPStride = kKeys + kRX;   // floats a p row
  static constexpr int kStage = kKeys * kStride;
  // Q, two stages of K and two of V, p.
  static constexpr int kSmemBytes =
      (kRows * kStride + 4 * kStage + kRows * kPStride) * 4;
  static_assert(kD % (4 * kRX) == 0, "a tier is a multiple of 4 kRX");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; with valid false, zeros (src unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x on the special-function unit; a result below 2^-126 flushes to 0
// (p that small is far below what l >= 1 can hold); ex2(-inf) = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Stages kN rows of tier kD into shared memory: row i from row_ptr(i), or
// zeros where row_ptr gives nullptr, columns >= width zero.
template <int kD, int kN, class RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, int width, bool vec,
                                           const float* any, RowPtr row_ptr) {
  constexpr int kStride = kD + 4, kThreads = Tier<kD>::kThreads;
  if (vec) {
    constexpr int kChunks = kD / 4;
#pragma unroll 4
    for (int e0 = 0; e0 < kN * kChunks; e0 += kThreads) {
      const int e = e0 + threadIdx.x;
      if (kN * kChunks % kThreads != 0 && e >= kN * kChunks) break;
      const int i = e / kChunks, c = (e % kChunks) * 4;
      const float* src = row_ptr(i);
      const bool ok = src != nullptr && c < width;
      cp_async16(smem_addr(dst + i * kStride + c), ok ? src + c : any, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kN * kD; e += kThreads) {
      const int i = e / kD, c = e % kD;
      const float* src = row_ptr(i);
      const bool ok = src != nullptr && c < width;
      cp_async4(smem_addr(dst + i * kStride + c), ok ? src + c : any, ok);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(Tier<kD>::kThreads, kD <= 128 ? 2 : 1)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int Sq, int Skv, int H,
                           int Hkv, int Dh, int Dv, int causal,
                           int has_window, int window, float scale_log2,
                           int vec, int heads, int row_tiles) {
  using T = Tier<kD>;
  constexpr int kRX = T::kRX, kRY = T::kRY, kRows = T::kRows;
  constexpr int kTN = T::kTN, kTD = T::kTD;
  constexpr int kStride = T::kStride, kPStride = T::kPStride;
  constexpr int kStage = T::kStage;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // kRows x kStride
  float* ks = qs + kRows * kStride;  // two stages of kKeys x kStride
  float* vs = ks + 2 * kStage;       // two stages
  float* ps = vs + 2 * kStage;       // kRows x kPStride

  const int g = H / Hkv;
  // Tile-major: every (batch, KV head) of the latest q tile first.
  const int bh = blockIdx.x % heads;
  const int b = bh / Hkv, hkv = bh % Hkv;
  const int64_t rows = static_cast<int64_t>(Sq) * g;
  const int tile = row_tiles - 1 - static_cast<int>(blockIdx.x / heads);
  const int64_t row0 = static_cast<int64_t>(tile) * kRows;
  const int tx = threadIdx.x % kRX, ty = threadIdx.x / kRX;

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
  const int64_t pmax = ((row0 + kRows < rows ? row0 + kRows : rows) - 1) / g;
  const int lo = key_lo(pmin), hi = key_hi(pmax);
  const int inner_lo = key_lo(pmax), inner_hi = key_hi(pmin);
  const int n_tiles = lo < hi ? (hi - lo + kKeys - 1) / kKeys : 0;

  // This thread's rows ty + kRY * i and the keys each sees.
  int klo[kTM], khi[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t r = row0 + ty + kRY * i;
    klo[i] = r < rows ? key_lo(r / g) : 0;
    khi[i] = r < rows ? key_hi(r / g) : 0;
  }

  float4 o[kTM][kTD];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < kTD; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m[kTM], l[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) m[i] = -CUDART_INF_F, l[i] = 0.f;

  if (n_tiles > 0) {
    // Key `key` of this KV head: k_head + key * Hkv * Dh, and so for v.
    const int64_t kv0 = static_cast<int64_t>(b) * Skv * Hkv + hkv;
    const float* k_head = k + kv0 * Dh;
    const float* v_head = v + kv0 * Dv;
    const int64_t k_step = static_cast<int64_t>(Hkv) * Dh;
    const int64_t v_step = static_cast<int64_t>(Hkv) * Dv;
    auto stage_kv = [&](int t) {
      const int k0 = lo + t * kKeys;
      stage_rows<kD, kKeys>(ks + (t & 1) * kStage, Dh, vec, k,
                            [&](int i) -> const float* {
                              return k0 + i < hi ? k_head + (k0 + i) * k_step
                                                 : nullptr;
                            });
      stage_rows<kD, kKeys>(vs + (t & 1) * kStage, Dv, vec, v,
                            [&](int i) -> const float* {
                              return k0 + i < hi ? v_head + (k0 + i) * v_step
                                                 : nullptr;
                            });
      cp_async_commit();
    };
    stage_rows<kD, kRows>(qs, Dh, vec, q, [&](int i) -> const float* {
      const int64_t r = row0 + i;
      if (r >= rows) return nullptr;
      const int64_t pos = r / g;
      return q + ((static_cast<int64_t>(b) * Sq + pos) * H + hkv * g +
                  (r - pos * g)) * Dh;
    });
    stage_kv(0);  // one group: Q and tile 0

    const float* q_row = qs + ty * kStride;
    float* p_row = ps + ty * kPStride;
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait_all();
      // Tile t is in shared memory for every thread, and every thread is
      // done with tile t - 1 (its stage and p).
      __syncthreads();
      if (t + 1 < n_tiles) stage_kv(t + 1);
      const float* kt = ks + (t & 1) * kStage + tx * kStride;
      const float* vt = vs + (t & 1) * kStage + 4 * tx;

      // S = Q K^T, four head columns a step.
      float s[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kD; d += 4) {
        float4 qv[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              q_row + kRY * i * kStride + d);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(kt + kRX * j * kStride + d);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }

      // Scores in log2 units, scaled before the mask and the max as the
      // reference does, so any sign of scale works.
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) s[i][j] *= scale_log2;

      // Mask only a tile that crosses an edge.
      const int k0 = lo + t * kKeys;
      const bool edge = k0 < inner_lo || k0 + kKeys > inner_hi;
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            const int key = k0 + tx + kRX * j;
            if (key < klo[i] || key >= khi[i]) s[i][j] = -CUDART_INF_F;
          }
      }

      // Online softmax in log2 units; p to shared memory.
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < kTN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
        for (int x = 1; x < kRX; x *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, x));
        const float m_new = fmaxf(m[i], mx);
        // Only an edge tile can leave a row with no key so far.
        const float m_safe = edge && !isfinite(m_new) ? 0.f : m_new;
        const float corr = ex2(m[i] - m_safe);  // 0 while m[i] is -inf
        m[i] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const float p = ex2(s[i][j] - m_safe);
          psum += p;
          p_row[kRY * i * kPStride + tx + kRX * j] = p;
        }
        l[i] = l[i] * corr + psum;
#pragma unroll
        for (int c = 0; c < kTD; ++c) {
          o[i][c].x *= corr, o[i][c].y *= corr;
          o[i][c].z *= corr, o[i][c].w *= corr;
        }
      }
      // A row's p comes from the kRX lanes that share it, all in this
      // warp, and only they read it back.
      __syncwarp();

      // O += P V, four keys a step.
#pragma unroll
      for (int kq = 0; kq < kKeys; kq += 4) {
        float pv[kTM][4];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(
              p_row + kRY * i * kPStride + kq);
          pv[i][0] = x.x, pv[i][1] = x.y, pv[i][2] = x.z, pv[i][3] = x.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < kTD; ++c) {
            const float4 vv = *reinterpret_cast<const float4*>(
                vt + (kq + e) * kStride + 4 * kRX * c);
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
              o[i][c].x = fmaf(pv[i][e], vv.x, o[i][c].x);
              o[i][c].y = fmaf(pv[i][e], vv.y, o[i][c].y);
              o[i][c].z = fmaf(pv[i][e], vv.z, o[i][c].z);
              o[i][c].w = fmaf(pv[i][e], vv.w, o[i][c].w);
            }
          }
      }
    }
  }

  // l was summed per thread over its keys; the kRX lanes hold the row.
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int x = 1; x < kRX; x *= 2)
      lt += __shfl_xor_sync(0xFFFFFFFFu, lt, x);
    const int64_t r = row0 + ty + kRY * i;
    if (r >= rows) continue;
    const int64_t pos = r / g;
    float* orow = out + ((static_cast<int64_t>(b) * Sq + pos) * H + hkv * g +
                         (r - pos * g)) * Dv;
    const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int c = 0; c < kTD; ++c) {
      const int d = 4 * (tx + kRX * c);
      const float4 y = make_float4(o[i][c].x / denom, o[i][c].y / denom,
                                   o[i][c].z / denom, o[i][c].w / denom);
      if (vec) {  // Dv % 4 == 0: d < Dv implies d + 3 < Dv
        if (d < Dv) *reinterpret_cast<float4*>(orow + d) = y;
      } else {
        if (d < Dv) orow[d] = y.x;
        if (d + 1 < Dv) orow[d + 1] = y.y;
        if (d + 2 < Dv) orow[d + 2] = y.z;
        if (d + 3 < Dv) orow[d + 3] = y.w;
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kD>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Sq, int Skv, int H, int Hkv, int Dh, int Dv, int causal,
           int has_window, int window, float scale, cudaStream_t stream) {
  using T = Tier<kD>;
  constexpr int kSmem = T::kSmemBytes;
  if constexpr (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t rows = static_cast<int64_t>(Sq) * (H / Hkv);
  const int64_t row_tiles = (rows + T::kRows - 1) / T::kRows;
  const int64_t heads = static_cast<int64_t>(B) * Hkv;
  if (row_tiles * heads > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = Dh % 4 == 0 && Dv % 4 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(out);
  const unsigned blocks = static_cast<unsigned>(row_tiles * heads);
  flash_attention_f32_kernel<kD><<<blocks, T::kThreads, kSmem, stream>>>(
      q, k, v, out, Sq, Skv, H, Hkv, Dh, Dv, causal, has_window, window,
      scale * kLog2e, vec, static_cast<int>(heads),
      static_cast<int>(row_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Called by flash_attention_launch (flash_attention.cu), which has checked
// the shapes; g = H / Hkv <= 32.
int flash_attention_f32_launch(const float* q, const float* k, const float* v,
                               float* out, int B, int Sq, int Skv, int H,
                               int Hkv, int Dh, int Dv, int causal,
                               int has_window, int window, float scale,
                               cudaStream_t stream) {
  const int width = Dh > Dv ? Dh : Dv;
  // The ported configs' head widths: 16 (reduced), 80 (h2o-danube), 128
  // (olmo, phi3) and 256 (gemma).  Any other width up to 256 runs
  // zero-padded in the next tier up.
  if (width <= 16)
    return launch<16>(q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv, causal,
                      has_window, window, scale, stream);
  if (width <= 80)
    return launch<80>(q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv, causal,
                      has_window, window, scale, stream);
  if (width <= 128)
    return launch<128>(q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv, causal,
                       has_window, window, scale, stream);
  return launch<256>(q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv, causal,
                     has_window, window, scale, stream);
}

// Dynamic shared memory, in bytes, of a block of the tier that runs head
// width `width` (ptxas reports only static shared memory).
extern "C" int flash_attention_f32_smem_bytes(int width) {
  return width <= 16    ? Tier<16>::kSmemBytes
         : width <= 80  ? Tier<80>::kSmemBytes
         : width <= 128 ? Tier<128>::kSmemBytes
                        : Tier<256>::kSmemBytes;
}
