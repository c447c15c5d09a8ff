// Fused softmax cross-entropy (bf16 logits; int32 labels or f32 dense
// targets).
//
// Replaces the Pallas TPU kernels of the JAX package
//   distriflow_tpu/ops/fused_ce.py::_fwd_kernel  (sparse=True and sparse=False)
//   distriflow_tpu/ops/fused_ce.py::_bwd_kernel  (sparse=True and sparse=False)
// The template flag kDense picks the variant, as `sparse` does there.
//
// Forward: per row, lse = logsumexp(x) in f32 with an online max and
// exp-sum (fused_ce.py:57-104), and loss = lse - hit. Sparse: hit =
// x[label]; a label outside [0, V) matches no column, so its loss is the
// row's lse (fused_ce.py:469-479). Dense: hit = sum over columns of
// where(x > -1e30, x, 0) * t (fused_ce.py:94-97): a -inf logit with target
// 0 adds 0, not NaN.
// Backward: grad = (exp(x - lse) - t) * g, written in the logits' dtype
// (fused_ce.py:107-116), where t is onehot(label) (sparse) or the target
// row (dense).
//
// Grid: one block of 256 threads per row in every kernel. The TPU kernels
// tile the vocab on a sequential grid axis and carry m/l/hit in VMEM
// scratch; here each thread walks its share of the row with 16-byte loads
// (eight bf16 logits, and eight f32 targets in two loads) keeping its own
// online max, exp-sum and dense hit in registers, and the block combines
// the 256 threads' values with warp shuffles and shared memory. The sparse
// label hit is read once, by one thread, straight from the row. Any V
// works: rows whose width is not a multiple of 8 (or whose bases are not
// 16-byte aligned) take a scalar loop.
//
// Bound: every kernel streams the [N, V] logits once (dense: the [N, V]
// f32 targets too; the backward also writes the [N, V] gradient) and does a
// few f32 operations and one exp per element: ~1 FLOP per byte, so the
// floor is bytes / 3.35 TB/s. The design reads each logit and target
// exactly once per kernel and writes nothing but the [N] loss and lse
// (forward) or the gradient (backward).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Merge the running pair (m, l) with (m2, l2): max and exp-sum of the union.
__device__ __forceinline__ void combine(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// Eight f32 values from two 16-byte loads.
__device__ __forceinline__ void load8f(const float* __restrict__ src, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = v[i];
}

// A logit's share of the dense hit: x * t, with masked (-1e30 or -inf)
// logits contributing 0.
__device__ __forceinline__ float dense_hit(float x, float t) {
  return (x > dftt::kNegInf ? x : 0.f) * t;
}

template <bool kDense>
__global__ void __launch_bounds__(kThreads) ce_fwd_kernel(
    const __nv_bfloat16* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ targets, float* __restrict__ loss, float* __restrict__ lse,
    int V, int vec) {
  const int64_t row = blockIdx.x;
  const __nv_bfloat16* x = logits + row * V;
  const float* t = kDense ? targets + row * V : nullptr;
  float m = dftt::kNegInf;
  float l = 0.f;
  float hit = 0.f;
  if (vec) {
    for (int c = threadIdx.x * 8; c < V; c += kThreads * 8) {
      float f[8];
      dftt::load8(x + c, f);
      float mx = f[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) mx = fmaxf(mx, f[i]);
      const float mn = fmaxf(m, mx);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += expf(f[i] - mn);
      l = l * expf(m - mn) + s;
      m = mn;
      if constexpr (kDense) {
        float tt[8];
        load8f(t + c, tt);
#pragma unroll
        for (int i = 0; i < 8; ++i) hit += dense_hit(f[i], tt[i]);
      }
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) {
      const float xv = __bfloat162float(x[c]);
      combine(m, l, xv, 1.f);
      if constexpr (kDense) hit += dense_hit(xv, t[c]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    combine(m, l, m2, l2);
  }
  if constexpr (kDense) hit = dftt::warp_sum(hit);
  __shared__ float sm[kThreads / 32], sl[kThreads / 32], sh[kThreads / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sm[warp] = m;
    sl[warp] = l;
    sh[warp] = hit;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = sh[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      combine(sm[0], sl[0], sm[w], sl[w]);
      total += sh[w];
    }
    const float out = sm[0] + logf(fmaxf(sl[0], 1e-30f));
    if constexpr (!kDense) {
      const int lab = labels[row];
      total = (lab >= 0 && lab < V) ? __bfloat162float(x[lab]) : 0.f;
    }
    lse[row] = out;
    loss[row] = out - total;
  }
}

template <bool kDense>
__global__ void __launch_bounds__(kThreads) ce_bwd_kernel(
    const __nv_bfloat16* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ targets, const float* __restrict__ lse,
    const float* __restrict__ g, __nv_bfloat16* __restrict__ grad, int V, int vec) {
  const int64_t row = blockIdx.x;
  const __nv_bfloat16* x = logits + row * V;
  const float* t = kDense ? targets + row * V : nullptr;
  __nv_bfloat16* out = grad + row * V;
  const float lse_r = lse[row];
  const float g_r = g[row];
  const int lab = kDense ? -1 : labels[row];
  if (vec) {
    for (int c = threadIdx.x * 8; c < V; c += kThreads * 8) {
      float f[8], tt[8];
      dftt::load8(x + c, f);
      if constexpr (kDense) {
        load8f(t + c, tt);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) tt[i] = c + i == lab ? 1.f : 0.f;
      }
      __align__(16) __nv_bfloat162 o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = (expf(f[2 * i] - lse_r) - tt[2 * i]) * g_r;
        const float b = (expf(f[2 * i + 1] - lse_r) - tt[2 * i + 1]) * g_r;
        o[i] = __floats2bfloat162_rn(a, b);
      }
      *reinterpret_cast<uint4*>(out + c) = *reinterpret_cast<const uint4*>(o);
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) {
      const float p = expf(__bfloat162float(x[c]) - lse_r);
      const float tc = kDense ? t[c] : (c == lab ? 1.f : 0.f);
      out[c] = __float2bfloat16((p - tc) * g_r);
    }
  }
}

// 16-byte rows: V a multiple of 8 and every row base aligned.
int vector_rows(const void* a, const void* b, const void* c, int V) {
  return (V % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(b) % 16 == 0) && (reinterpret_cast<uintptr_t>(c) % 16 == 0);
}

template <bool kDense>
int forward(const void* logits, const void* labels, const void* targets, void* loss, void* lse,
            int N, int V, void* stream) {
  ce_fwd_kernel<kDense><<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(targets), static_cast<float*>(loss), static_cast<float*>(lse), V,
      vector_rows(logits, logits, kDense ? targets : logits, V));
  return static_cast<int>(cudaGetLastError());
}

template <bool kDense>
int backward(const void* logits, const void* labels, const void* targets, const void* lse,
             const void* g, void* grad, int N, int V, void* stream) {
  ce_bwd_kernel<kDense><<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(targets), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(grad), V,
      vector_rows(logits, grad, kDense ? targets : logits, V));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits: [N, V] bf16 contiguous; labels: [N] int32; loss, lse: [N] f32.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int dftt_fused_ce_fwd_bf16(const void* logits, const void* labels, void* loss,
                                      void* lse, int N, int V, void* stream) {
  return forward<false>(logits, labels, nullptr, loss, lse, N, V, stream);
}

// logits, grad: [N, V] bf16 contiguous; labels: [N] int32; lse, g: [N] f32.
extern "C" int dftt_fused_ce_bwd_bf16(const void* logits, const void* labels, const void* lse,
                                      const void* g, void* grad, int N, int V, void* stream) {
  return backward<false>(logits, labels, nullptr, lse, g, grad, N, V, stream);
}

// Dense targets: logits [N, V] bf16 and targets [N, V] f32, both
// contiguous; loss, lse: [N] f32.
extern "C" int dftt_fused_ce_dense_fwd_bf16(const void* logits, const void* targets, void* loss,
                                            void* lse, int N, int V, void* stream) {
  return forward<true>(logits, nullptr, targets, loss, lse, N, V, stream);
}

// Dense targets: logits, grad [N, V] bf16; targets [N, V] f32; lse, g [N] f32.
extern "C" int dftt_fused_ce_dense_bwd_bf16(const void* logits, const void* targets,
                                            const void* lse, const void* g, void* grad, int N,
                                            int V, void* stream) {
  return backward<true>(logits, nullptr, targets, lse, g, grad, N, V, stream);
}
