// Fused sparse softmax cross-entropy (bf16 logits, int32 labels).
//
// Replaces the Pallas TPU kernels of the JAX package
//   distriflow_tpu/ops/fused_ce.py::_fwd_kernel  (sparse=True)
//   distriflow_tpu/ops/fused_ce.py::_bwd_kernel  (sparse=True)
// The dense-target variant of the same Pallas bodies (sparse=False) is not
// ported yet.
//
// Forward: per row, lse = logsumexp(x) and loss = lse - x[label] in f32,
// with an online max and exp-sum (fused_ce.py:57-104). A label outside
// [0, V) matches no column: its loss is the row's lse (fused_ce.py:469-479).
// Backward: grad = (exp(x - lse) - onehot(label)) * g, written in the
// logits' dtype (fused_ce.py:107-116).
//
// Grid: one block of 256 threads per row in both kernels. The TPU kernels
// tile the vocab on a sequential grid axis and carry m/l/label-hit in VMEM
// scratch; here each thread walks its share of the row with 16-byte loads
// (eight bf16) keeping its own online max and exp-sum in registers, and the
// block combines the 256 pairs with warp shuffles and shared memory. The
// label hit is read once, by one thread, straight from the row. Any V
// works: rows whose width is not a multiple of 8 (or whose base is not
// 16-byte aligned) take a scalar loop.
//
// Bound: both kernels stream the [N, V] logits once (the backward also
// writes the [N, V] gradient) and do a few f32 operations and one exp per
// element: ~1 FLOP per byte, so the floor is bytes / 3.35 TB/s. The
// design reads each logit exactly once per kernel and writes nothing but
// the [N] loss and lse (forward) or the gradient (backward).

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

__global__ void __launch_bounds__(kThreads) ce_fwd_kernel(
    const __nv_bfloat16* __restrict__ logits, const int* __restrict__ labels,
    float* __restrict__ loss, float* __restrict__ lse, int V, int vec) {
  const int64_t row = blockIdx.x;
  const __nv_bfloat16* x = logits + row * V;
  float m = dftt::kNegInf;
  float l = 0.f;
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
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) combine(m, l, __bfloat162float(x[c]), 1.f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    combine(m, l, m2, l2);
  }
  __shared__ float sm[kThreads / 32], sl[kThreads / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) combine(sm[0], sl[0], sm[w], sl[w]);
    const float out = sm[0] + logf(fmaxf(sl[0], 1e-30f));
    const int lab = labels[row];
    const float hit = (lab >= 0 && lab < V) ? __bfloat162float(x[lab]) : 0.f;
    lse[row] = out;
    loss[row] = out - hit;
  }
}

__global__ void __launch_bounds__(kThreads) ce_bwd_kernel(
    const __nv_bfloat16* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ g,
    __nv_bfloat16* __restrict__ grad, int V, int vec) {
  const int64_t row = blockIdx.x;
  const __nv_bfloat16* x = logits + row * V;
  __nv_bfloat16* out = grad + row * V;
  const float lse_r = lse[row];
  const float g_r = g[row];
  const int lab = labels[row];
  if (vec) {
    for (int c = threadIdx.x * 8; c < V; c += kThreads * 8) {
      float f[8];
      dftt::load8(x + c, f);
      __align__(16) __nv_bfloat162 o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = (expf(f[2 * i] - lse_r) - (c + 2 * i == lab ? 1.f : 0.f)) * g_r;
        const float b = (expf(f[2 * i + 1] - lse_r) - (c + 2 * i + 1 == lab ? 1.f : 0.f)) * g_r;
        o[i] = __floats2bfloat162_rn(a, b);
      }
      *reinterpret_cast<uint4*>(out + c) = *reinterpret_cast<const uint4*>(o);
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) {
      const float p = expf(__bfloat162float(x[c]) - lse_r);
      out[c] = __float2bfloat16((p - (c == lab ? 1.f : 0.f)) * g_r);
    }
  }
}

// 16-byte rows: V a multiple of 8 and both row bases aligned.
int vector_rows(const void* a, const void* b, int V) {
  return (V % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(b) % 16 == 0);
}

}  // namespace

// logits: [N, V] bf16 contiguous; labels: [N] int32; loss, lse: [N] f32.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int dftt_fused_ce_fwd_bf16(const void* logits, const void* labels, void* loss,
                                      void* lse, int N, int V, void* stream) {
  ce_fwd_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits), static_cast<const int*>(labels),
      static_cast<float*>(loss), static_cast<float*>(lse), V, vector_rows(logits, logits, V));
  return static_cast<int>(cudaGetLastError());
}

// logits, grad: [N, V] bf16 contiguous; labels: [N] int32; lse, g: [N] f32.
extern "C" int dftt_fused_ce_bwd_bf16(const void* logits, const void* labels, const void* lse,
                                      const void* g, void* grad, int N, int V, void* stream) {
  ce_bwd_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<__nv_bfloat16*>(grad), V, vector_rows(logits, grad, V));
  return static_cast<int>(cudaGetLastError());
}
