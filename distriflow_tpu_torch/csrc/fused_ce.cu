// Fused softmax cross-entropy (bf16 or f32 logits; int32 labels or f32
// dense targets).
//
// Replaces the Pallas TPU kernels of the JAX package
//   distriflow_tpu/ops/fused_ce.py::_fwd_kernel  (sparse=True and sparse=False)
//   distriflow_tpu/ops/fused_ce.py::_bwd_kernel  (sparse=True and sparse=False)
// The template flag kDense picks the variant, as `sparse` does there, and
// the template type T the logits' element type, bf16 (a bf16 model's
// logits) or float (an f32 model's, the LM CLI's --dtype float32): the JAX
// kernels keep logits.dtype (fused_ce.py:345, :419) and write the gradient
// in it (:116). Every sum and exp is f32 in both.
//
// Forward: per row, lse = logsumexp(x) in f32 with a max shift
// (fused_ce.py:57-104), and loss = lse - hit. Sparse: hit = x[label]; a
// label outside [0, V) matches no column, so its loss is the row's lse
// (fused_ce.py:469-479). Dense: hit = sum over columns of
// where(x > -1e30, x, 0) * t (fused_ce.py:94-97): a -inf logit with target
// 0 adds 0, not NaN.
// Backward: grad = (exp(x - lse) - t) * g, written in the logits' dtype
// (fused_ce.py:107-116), where t is onehot(label) (sparse) or the target
// row (dense).
//
// Two layouts, picked by the wrapper (ops/fused_ce.py::_row_tile):
//
// Wide rows (V > 256, the LM's V 32000): one block of 256 threads per row.
// The TPU kernels tile the vocab on a sequential grid axis and carry m/l/hit
// in VMEM scratch; here each thread walks its share of the row with
// 16-byte loads (eight bf16 logits in one, eight f32 logits or targets in
// two)
// keeping its own online max, exp-sum and dense hit in registers, and the
// block combines the 256 threads' values with warp shuffles and shared
// memory. The sparse label hit is read once, by one thread, straight from
// the row. Rows whose width is not a multiple of 8 (or whose bases are not
// 16-byte aligned) take a scalar loop.
//
// Narrow rows (V <= 256, every dense-CE head of the port: V 10): a block
// of 256 threads owns R contiguous rows, a group of G lanes each (G the
// least power of two with 8 G >= V, R = 256 / G; the TPU kernel tiles 256
// rows a grid step, fused_ce.py:47). N 2048 at V 10 is 16 blocks in one
// wave, where one block a row took two. Forward: each lane loads the
// columns lane, lane + G, ... (at most 8) of its row, and the row's label,
// straight into registers, and the group reduces the max, then the
// exp-sum and the hit, with xor shuffles in a fixed order: no shared
// memory, no barrier, one round trip to memory. Backward: no reduction;
// the tile is one flat run of R V elements, eight consecutive ones a
// thread, each with its row's lse and g: a whole chunk on an aligned base
// takes 16-byte loads and one 16-byte store per 16 bytes (a tile is R V
// sizeof(T) = 512 V / G or 1024 V / G bytes, a multiple of 16, so every
// chunk of an aligned tensor is aligned), the
// last chunk of a partial tile and a base off 16 bytes (a sliced view) go
// element by element. Staging the forward's tile through shared memory
// with flat 16-byte loads, then reading the rows from there, measured
// 0.7-0.9 us slower on the H100 at N 2048 (a second memory step behind a
// barrier): these kernels are bound by latency, not bytes.
//
// Bound: every kernel streams the [N, V] logits once (dense: the [N, V]
// f32 targets too; the backward also writes the [N, V] gradient) and does a
// few f32 operations and one exp per element: ~1 FLOP per byte, so the
// floor is bytes / 3.35 TB/s. The design reads each logit and target
// exactly once per kernel and writes nothing but the [N] loss and lse
// (forward) or the gradient (backward). At V 10 the bytes take
// nanoseconds: a launch and one round trip to memory bound the narrow
// kernels.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The logits' element type T (bf16 or float): widen, narrow, and eight
// values by 16-byte loads and stores from an aligned base.
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

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

__device__ __forceinline__ void load8x(const __nv_bfloat16* __restrict__ src, float* dst) {
  dftt::load8(src, dst);
}
__device__ __forceinline__ void load8x(const float* __restrict__ src, float* dst) {
  load8f(src, dst);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  __align__(16) __nv_bfloat162 o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}
__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// A logit's share of the dense hit: x * t, with masked (-1e30 or -inf)
// logits contributing 0.
__device__ __forceinline__ float dense_hit(float x, float t) {
  return (x > dftt::kNegInf ? x : 0.f) * t;
}

template <bool kDense, typename T>
__global__ void __launch_bounds__(kThreads) ce_fwd_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ targets, float* __restrict__ loss, float* __restrict__ lse,
    int V, int vec) {
  const int64_t row = blockIdx.x;
  const T* x = logits + row * V;
  const float* t = kDense ? targets + row * V : nullptr;
  float m = dftt::kNegInf;
  float l = 0.f;
  float hit = 0.f;
  if (vec) {
    for (int c = threadIdx.x * 8; c < V; c += kThreads * 8) {
      float f[8];
      load8x(x + c, f);
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
      const float xv = to_f32(x[c]);
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
    const float out = sm[0] + logf(sl[0] < 1e-30f ? 1e-30f : sl[0]);  // keeps a NaN
    if constexpr (!kDense) {
      const int lab = labels[row];
      total = (lab >= 0 && lab < V) ? to_f32(x[lab]) : 0.f;
    }
    lse[row] = out;
    loss[row] = out - total;
  }
}

template <bool kDense, typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ targets, const float* __restrict__ lse,
    const float* __restrict__ g, T* __restrict__ grad, int V, int vec) {
  const int64_t row = blockIdx.x;
  const T* x = logits + row * V;
  const float* t = kDense ? targets + row * V : nullptr;
  T* out = grad + row * V;
  const float lse_r = lse[row];
  const float g_r = g[row];
  const int lab = kDense ? -1 : labels[row];
  if (vec) {
    for (int c = threadIdx.x * 8; c < V; c += kThreads * 8) {
      float f[8], tt[8], o[8];
      load8x(x + c, f);
      if constexpr (kDense) {
        load8f(t + c, tt);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) tt[i] = c + i == lab ? 1.f : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = (expf(f[i] - lse_r) - tt[i]) * g_r;
      store8(out + c, o);
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) {
      const float p = expf(to_f32(x[c]) - lse_r);
      const float tc = kDense ? t[c] : (c == lab ? 1.f : 0.f);
      out[c] = from_f32<T>((p - tc) * g_r);
    }
  }
}

// ---------------------------------------------------------------- narrow rows

// A narrow tile holds at most 256 / G rows of V <= 8 G columns: 2048
// elements, eight a thread.
constexpr int kTile = 2048;
constexpr int kPer = kTile / kThreads;

// Forward, narrow rows: block b owns rows [b R, b R + R) (fewer in the last
// block), a group of `lanes` (G) threads each. Every load (the lane's
// columns, its targets, the row's label) goes out before the first use.
template <bool kDense, typename T>
__global__ void __launch_bounds__(kThreads) ce_fwd_rows_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ targets, float* __restrict__ loss, float* __restrict__ lse,
    int N, int V, int lanes, int rows) {
  const int lane = threadIdx.x % lanes;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rows + threadIdx.x / lanes;
  // every thread joins the shuffles; a group past the last row reads nothing
  const int cols = row < N ? V : 0;
  const T* x = logits + row * V;
  const int lab = kDense || row >= N ? -1 : labels[row];
  float f[kPer], tt[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + j * lanes;
    f[j] = c < cols ? to_f32(x[c]) : dftt::kNegInf;
    if constexpr (kDense) tt[j] = c < cols ? targets[row * V + c] : 0.f;
  }
  float m = dftt::kNegInf;
#pragma unroll
  for (int j = 0; j < kPer; ++j) m = fmaxf(m, f[j]);
  for (int off = lanes >> 1; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float l = 0.f;
  float hit = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + j * lanes;
    if (c < cols) {
      l += expf(f[j] - m);
      // sparse: the label's column lies in one lane; the others add 0
      hit += kDense ? dense_hit(f[j], tt[j]) : (c == lab ? f[j] : 0.f);
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
    hit += __shfl_xor_sync(0xffffffffu, hit, off);
  }
  if (lane == 0 && row < N) {
    const float out = m + logf(l < 1e-30f ? 1e-30f : l);  // keeps a NaN
    lse[row] = out;
    loss[row] = out - hit;
  }
}

// One thread's chunk of the narrow backward: the eight elements from `at`
// (`e` within its tile, whose first row is `row0`), each with its row's
// lse and g (and label). kWhole: all eight lie in the tile and the base is
// aligned, so one 16-byte load of logits, two of targets and one 16-byte
// store; else element by element, up to the tile's end `n`.
template <bool kDense, bool kWhole, typename T>
__device__ __forceinline__ void bwd_chunk(
    const T* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ targets, const float* __restrict__ lse,
    const float* __restrict__ g, T* __restrict__ grad, int64_t row0, int64_t at,
    int e, int n, int V) {
  float f[kPer] = {}, tt[kPer] = {}, ls[kPer] = {}, gg[kPer] = {};
  if constexpr (kWhole) {
    load8x(logits + at, f);
    if constexpr (kDense) load8f(targets + at, tt);
  }
  int r = e / V;
  int c = e - r * V;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (kWhole || e + i < n) {
      if constexpr (!kWhole) {
        f[i] = to_f32(logits[at + i]);
        if constexpr (kDense) tt[i] = targets[at + i];
      }
      if constexpr (!kDense) tt[i] = c == labels[row0 + r] ? 1.f : 0.f;
      ls[i] = lse[row0 + r];
      gg[i] = g[row0 + r];
    }
    if (++c == V) {
      c = 0;
      ++r;
    }
  }
  float v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = (expf(f[i] - ls[i]) - tt[i]) * gg[i];
  if constexpr (kWhole) {
    store8(grad + at, v);
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (e + i < n) grad[at + i] = from_f32<T>(v[i]);
  }
}

// Backward, narrow rows: no reduction. The block's [R, V] tile is one flat
// run, eight consecutive elements a thread (bwd_chunk); the last chunk of
// a partial tile and a base off 16 bytes (a sliced view) go element by
// element. Every load goes out before the first use.
template <bool kDense, typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd_rows_kernel(
    const T* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ targets, const float* __restrict__ lse,
    const float* __restrict__ g, T* __restrict__ grad, int N, int V, int rows,
    int aligned) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(N - row0 < rows ? N - row0 : rows);
  const int n = nrows * V;
  const int e = threadIdx.x * kPer;  // R V <= 2048: one chunk a thread
  if (e >= n) return;
  const int64_t at = row0 * V + e;
  if (aligned && e + kPer <= n)
    bwd_chunk<kDense, true, T>(logits, labels, targets, lse, g, grad, row0, at, e, n, V);
  else
    bwd_chunk<kDense, false, T>(logits, labels, targets, lse, g, grad, row0, at, e, n, V);
}

// ---------------------------------------------------------------- launches

// The wrapper's tile: rows > 0 picks the narrow kernels (lanes * rows ==
// 256 threads, at most kTile elements; rows >= 8, so every tile of an
// aligned tensor starts on 16 bytes); rows == 0 the block-per-row ones.
// `aligned`: every base pointer lies on 16 bytes.
bool narrow_tile_ok(int V, int lanes, int rows) {
  return lanes > 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0 && lanes * rows == kThreads &&
         V <= 8 * lanes && rows * V <= kTile;
}

template <bool kDense, typename T>
int forward(const void* logits, const void* labels, const void* targets, void* loss, void* lse,
            int N, int V, int lanes, int rows, int aligned, void* stream) {
  const auto* x = static_cast<const T*>(logits);
  const auto* lab = static_cast<const int*>(labels);
  const auto* t = static_cast<const float*>(targets);
  auto* lo = static_cast<float*>(loss);
  auto* ls = static_cast<float*>(lse);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (!narrow_tile_ok(V, lanes, rows)) return static_cast<int>(cudaErrorInvalidValue);
    ce_fwd_rows_kernel<kDense, T><<<(N + rows - 1) / rows, kThreads, 0, s>>>(
        x, lab, t, lo, ls, N, V, lanes, rows);
  } else {
    ce_fwd_kernel<kDense, T><<<N, kThreads, 0, s>>>(x, lab, t, lo, ls, V, aligned && V % 8 == 0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kDense, typename T>
int backward(const void* logits, const void* labels, const void* targets, const void* lse,
             const void* g, void* grad, int N, int V, int lanes, int rows, int aligned,
             void* stream) {
  const auto* x = static_cast<const T*>(logits);
  const auto* lab = static_cast<const int*>(labels);
  const auto* t = static_cast<const float*>(targets);
  const auto* ls = static_cast<const float*>(lse);
  const auto* gg = static_cast<const float*>(g);
  auto* out = static_cast<T*>(grad);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (!narrow_tile_ok(V, lanes, rows)) return static_cast<int>(cudaErrorInvalidValue);
    ce_bwd_rows_kernel<kDense, T><<<(N + rows - 1) / rows, kThreads, 0, s>>>(
        x, lab, t, ls, gg, out, N, V, rows, aligned);
  } else {
    ce_bwd_kernel<kDense, T><<<N, kThreads, 0, s>>>(x, lab, t, ls, gg, out, V, aligned && V % 8 == 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched). (lanes, rows): the narrow tile of ops/fused_ce.py::
// _row_tile, or rows 0 for one block a row; `aligned`: every pointer
// argument's base lies on 16 bytes.

// The bf16 entries take bf16 logits and write a bf16 gradient; the f32
// entries (`_f32`) take f32 logits and write an f32 gradient.

// logits: [N, V] contiguous; labels: [N] int32; loss, lse: [N] f32.
extern "C" int dftt_fused_ce_fwd_bf16(const void* logits, const void* labels, void* loss,
                                      void* lse, int N, int V, int lanes, int rows, int aligned,
                                      void* stream) {
  return forward<false, __nv_bfloat16>(logits, labels, nullptr, loss, lse, N, V, lanes, rows,
                                       aligned, stream);
}
extern "C" int dftt_fused_ce_fwd_f32(const void* logits, const void* labels, void* loss,
                                     void* lse, int N, int V, int lanes, int rows, int aligned,
                                     void* stream) {
  return forward<false, float>(logits, labels, nullptr, loss, lse, N, V, lanes, rows, aligned,
                               stream);
}

// logits, grad: [N, V] contiguous; labels: [N] int32; lse, g: [N] f32.
extern "C" int dftt_fused_ce_bwd_bf16(const void* logits, const void* labels, const void* lse,
                                      const void* g, void* grad, int N, int V, int lanes, int rows,
                                      int aligned, void* stream) {
  return backward<false, __nv_bfloat16>(logits, labels, nullptr, lse, g, grad, N, V, lanes, rows,
                                        aligned, stream);
}
extern "C" int dftt_fused_ce_bwd_f32(const void* logits, const void* labels, const void* lse,
                                     const void* g, void* grad, int N, int V, int lanes, int rows,
                                     int aligned, void* stream) {
  return backward<false, float>(logits, labels, nullptr, lse, g, grad, N, V, lanes, rows, aligned,
                                stream);
}

// Dense targets: logits [N, V] and targets [N, V] f32, both contiguous;
// loss, lse: [N] f32.
extern "C" int dftt_fused_ce_dense_fwd_bf16(const void* logits, const void* targets, void* loss,
                                            void* lse, int N, int V, int lanes, int rows,
                                            int aligned, void* stream) {
  return forward<true, __nv_bfloat16>(logits, nullptr, targets, loss, lse, N, V, lanes, rows,
                                      aligned, stream);
}
extern "C" int dftt_fused_ce_dense_fwd_f32(const void* logits, const void* targets, void* loss,
                                           void* lse, int N, int V, int lanes, int rows,
                                           int aligned, void* stream) {
  return forward<true, float>(logits, nullptr, targets, loss, lse, N, V, lanes, rows, aligned,
                              stream);
}

// Dense targets: logits, grad [N, V]; targets [N, V] f32; lse, g [N] f32.
extern "C" int dftt_fused_ce_dense_bwd_bf16(const void* logits, const void* targets,
                                            const void* lse, const void* g, void* grad, int N,
                                            int V, int lanes, int rows, int aligned,
                                            void* stream) {
  return backward<true, __nv_bfloat16>(logits, nullptr, targets, lse, g, grad, N, V, lanes, rows,
                                       aligned, stream);
}
extern "C" int dftt_fused_ce_dense_bwd_f32(const void* logits, const void* targets,
                                           const void* lse, const void* g, void* grad, int N,
                                           int V, int lanes, int rows, int aligned,
                                           void* stream) {
  return backward<true, float>(logits, nullptr, targets, lse, g, grad, N, V, lanes, rows, aligned,
                               stream);
}
