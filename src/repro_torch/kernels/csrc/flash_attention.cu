// K8: flash attention forward -- causal and sliding-window masks, GQA.
//
// Replaces the Pallas kernel repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py).  Same function: q (B, Sq, H, Dh),
// k and v (B, Skv, Hkv, Dh|Dv) -> out (B, Sq, H, Dv) in q's dtype; an online
// softmax whose statistics (m, l, acc) are float32 across KV tiles; out =
// acc / max(l, 1e-30), so a row with every key masked gives 0; masks
// k < Skv, k <= q (causal) and k > q - window, positions from 0; p rounded
// to v's dtype before the PV product.
//
// Design (simple, not yet fast).  One thread block per (batch x KV head,
// tile of folded q rows): the g = H / Hkv query heads of the KV head, at tq
// consecutive q positions, fold into g * tq <= 32 rows, so one staged K/V
// tile serves every head of the group, as the TPU kernel's GQA fold does.
// Four threads own a row: thread t holds elements t, t + 4, t + 8, ... of
// the row's q and of its output accumulator in registers.  A loop over KV
// tiles staged in shared memory (as float32) takes the place of the TPU's
// sequential KV grid axis; it starts and stops at the first and last key
// that the causal and window masks leave to the block's positions, so tiles
// the masks empty are never loaded.  Every product is an IEEE float32 FMA
// (no tensor cores, no TF32); a score is the sum of the four threads'
// partial dot products (two butterfly shuffles).
//
// What bounds it on this card: operations.  4 * Dh flops per unmasked
// (q, k) pair and head against 3.35 TB/s for q, k, v and out read or
// written once puts attention at long prefill far above the ridge point.
// The bound for bf16 inputs is the tensor cores' 989 TFLOP/s; this kernel
// runs on the FP32 lanes (67 TFLOP/s at most) and issues one shared-memory
// load per FMA, so it sits far above that bound.  Left on the table:
// mma.sync / wgmma on bf16 tiles, q tiles of 64+ rows per warpgroup, TMA
// loads double-buffered behind the math, and exp2 with a folded log2(e).
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanesPerRow = 4;
constexpr int kRows = kThreads / kLanesPerRow;  // folded q rows per block

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// kPer: elements of a head row per thread (head widths up to 4 * kPer).
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Skv, int H, int Hkv, int Dh, int Dv,
    int tq, int causal, int has_window, int window, float scale) {
  constexpr int kTK = kPer >= 48 ? 16 : 32;  // keys per shared-memory tile
  constexpr int kWidth = kLanesPerRow * kPer;
  __shared__ float ks[kTK][kWidth];
  __shared__ float vs[kTK][kWidth];

  const int g = H / Hkv;
  const int b = blockIdx.y / Hkv;
  const int hkv = blockIdx.y % Hkv;
  const int p0 = blockIdx.x * tq;
  const int p1 = min(p0 + tq, Sq);
  const int row = threadIdx.x / kLanesPerRow;
  const int t = threadIdx.x % kLanesPerRow;
  const int j = row / tq;  // query head within the group
  const int pos = p0 + row % tq;
  const bool active = j < g && pos < p1;
  const int h = hkv * g + j;

  float qr[kPer];
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = t + kLanesPerRow * i;
    qr[i] = active && d < Dh
                ? load_f32(q + ((static_cast<int64_t>(b) * Sq + pos) * H + h) *
                                   Dh + d)
                : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  // Keys the block's positions [p0, p1) can see.
  int64_t lo = 0, hi = Skv;
  if (causal && p1 < hi) hi = p1;
  if (has_window && static_cast<int64_t>(p0) - window + 1 > 0)
    lo = static_cast<int64_t>(p0) - window + 1;

  for (int64_t k0 = lo; k0 < hi; k0 += kTK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kTK * kWidth; e += kThreads) {
      const int kk = e / kWidth, d = e % kWidth;
      const int64_t key = k0 + kk;
      float kx = 0.f, vx = 0.f;
      if (key < hi) {
        const int64_t kv_row = (static_cast<int64_t>(b) * Skv + key) * Hkv + hkv;
        if (d < Dh) kx = load_f32(k + kv_row * Dh + d);
        if (d < Dv) vx = load_f32(v + kv_row * Dv + d);
      }
      ks[kk][d] = kx;
      vs[kk][d] = vx;
    }
    __syncthreads();

    float s[kTK];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        part = fmaf(qr[i], ks[kk][t + kLanesPerRow * i], part);
      part += __shfl_xor_sync(0xFFFFFFFFu, part, 1);
      part += __shfl_xor_sync(0xFFFFFFFFu, part, 2);
      const int64_t key = k0 + kk;
      bool ok = active && key < hi;
      if (causal) ok = ok && key <= pos;
      if (has_window) ok = ok && key > static_cast<int64_t>(pos) - window;
      s[kk] = ok ? part * scale : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[kk]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float corr = isfinite(m) ? expf(m - m_safe) : 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= corr;
    float psum = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      const float p = isfinite(s[kk]) ? expf(s[kk] - m_safe) : 0.f;
      psum += p;
      float pv = p;
      if constexpr (std::is_same_v<T, __nv_bfloat16>)
        pv = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[i] = fmaf(pv, vs[kk][t + kLanesPerRow * i], acc[i]);
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (!active) return;
  T* orow = out + ((static_cast<int64_t>(b) * Sq + pos) * H + h) * Dv;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = t + kLanesPerRow * i;
    if (d < Dv) store_from_f32(orow + d, acc[i] / denom);
  }
}

template <typename T, int kPer>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Hkv, int Dh, int Dv, int causal,
           int has_window, int window, float scale, cudaStream_t stream) {
  const int g = H / Hkv;
  const int tq = kRows / g;
  const dim3 grid((Sq + tq - 1) / tq, B * Hkv);
  flash_attention_kernel<T, kPer><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Hkv, Dh, Dv,
      tq, causal, has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int width, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Skv, int H, int Hkv, int Dh, int Dv,
             int causal, int has_window, int window, float scale,
             cudaStream_t stream) {
#define REPRO_K8_TIER(PER)                                                   \
  if (width <= kLanesPerRow * PER)                                           \
    return launch<T, PER>(q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv, causal, \
                          has_window, window, scale, stream);
  // The ported configs' head widths: 16 (reduced), 80 (h2o-danube, in the
  // 96 tier), 128 (olmo, phi3) and 256 (gemma).  Any other width up to 256
  // runs in the next tier up.
  REPRO_K8_TIER(4)
  REPRO_K8_TIER(24)
  REPRO_K8_TIER(32)
  REPRO_K8_TIER(64)
#undef REPRO_K8_TIER
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int Hkv, int Dh, int Dv,
                                      int causal, int has_window, int window,
                                      float scale, int bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kRows || B * static_cast<int64_t>(Hkv) > 65535 || Dh <= 0 ||
      Dv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int width = Dh > Dv ? Dh : Dv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(width, q, k, v, out, B, Sq, Skv, H, Hkv, Dh,
                                   Dv, causal, has_window, window, scale, s);
  return dispatch<float>(width, q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv,
                         causal, has_window, window, scale, s);
}
