// K8, float32: flash attention forward on IEEE float32 FMAs -- causal and
// sliding-window masks, GQA.
//
// Replaces the float32 case of the Pallas kernel
// repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py).  flash_attention_launch
// (flash_attention.cu) routes float32 inputs here and bf16 inputs to the
// tensor-core kernel.  Same function: q (B, Sq, H, Dh), k and v
// (B, Skv, Hkv, Dh|Dv) -> out (B, Sq, H, Dv); an online softmax whose
// statistics (m, l, acc) are float32 across KV tiles; out = acc /
// max(l, 1e-30), so a row with every key masked gives 0; masks k < Skv,
// k <= q (causal) and k > q - window, positions from 0.
//
// Why not the tensor cores: the float32 tests hold K8 to 3e-5
// (test_kernels.py's tolerance), which TF32's 10-bit mantissa cannot meet,
// so every product here is an IEEE float32 FMA.
//
// Design (simple, not fast).  One thread block per (batch x KV head, tile
// of folded q rows): the g = H / Hkv query heads of the KV head, at tq
// consecutive q positions, fold into g * tq <= 32 rows, so one staged K/V
// tile serves every head of the group, as the TPU kernel's GQA fold does.
// Four threads own a row: thread t holds elements t, t + 4, t + 8, ... of
// the row's q and of its output accumulator in registers.  A loop over KV
// tiles staged in shared memory takes the place of the TPU's sequential KV
// grid axis; it starts and stops at the first and last key that the causal
// and window masks leave to the block's positions, so tiles the masks
// empty are never loaded.  A score is the sum of the four threads' partial
// dot products (two butterfly shuffles).
//
// What bounds it on this card: operations, at the FP32 lanes' 67 TFLOP/s.
// It issues one shared-memory load per FMA, so it sits far above that
// bound; only the model's float32 correctness gates run it.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanesPerRow = 4;
constexpr int kRows = kThreads / kLanesPerRow;  // folded q rows per block

// kPer: elements of a head row per thread (head widths up to 4 * kPer).
template <int kPer>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Sq, int Skv,
    int H, int Hkv, int Dh, int Dv, int tq, int causal, int has_window,
    int window, float scale) {
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
                ? q[((static_cast<int64_t>(b) * Sq + pos) * H + h) * Dh + d]
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
        if (d < Dh) kx = k[kv_row * Dh + d];
        if (d < Dv) vx = v[kv_row * Dv + d];
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
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[i] = fmaf(p, vs[kk][t + kLanesPerRow * i], acc[i]);
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (!active) return;
  float* orow = out + ((static_cast<int64_t>(b) * Sq + pos) * H + h) * Dv;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = t + kLanesPerRow * i;
    if (d < Dv) orow[d] = acc[i] / denom;
  }
}

template <int kPer>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Sq, int Skv, int H, int Hkv, int Dh, int Dv, int causal,
           int has_window, int window, float scale, cudaStream_t stream) {
  const int g = H / Hkv;
  const int tq = kRows / g;
  const dim3 grid((Sq + tq - 1) / tq, B * Hkv);
  flash_attention_f32_kernel<kPer><<<grid, kThreads, 0, stream>>>(
      q, k, v, out, Sq, Skv, H, Hkv, Dh, Dv, tq, causal, has_window, window,
      scale);
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
#define REPRO_K8_TIER(PER)                                                   \
  if (width <= kLanesPerRow * PER)                                           \
    return launch<PER>(q, k, v, out, B, Sq, Skv, H, Hkv, Dh, Dv, causal,    \
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
