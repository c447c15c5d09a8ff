// Attention forward and backward in f32, on the CUDA cores (FFMA).
//
// Replaces the Pallas TPU kernels of the JAX package on f32 inputs
//   distriflow_tpu/ops/flash_attention.py::_fwd_kernel   (forward: O and lse)
//   distriflow_tpu/ops/flash_attention.py::_dkvq_kernel  (fused: dK, dV, dQ partials)
//   distriflow_tpu/ops/flash_attention.py::_dq_kernel    (two-kernel layout: dQ)
//   distriflow_tpu/ops/flash_attention.py::_dkv_kernel   (two-kernel layout: dK, dV)
// and the sum over the fused kernel's dQ partials that the JAX package
// leaves to XLA (flash_attention.py:605). JAX runs them on f32 inputs for a
// model whose compute dtype is f32 (the LM CLI's --dtype float32; the
// two-kernel layout past 2048 positions, as at --seq 16384), with f32
// operands and f32 accumulation. These kernels keep that: every product,
// sum and exp is an f32 operation on the CUDA cores. TF32 wgmma would round
// each operand to 10 mantissa bits and so train another model than the
// JAX package's f32 one: it is not used. Built for head dims 64 and 32
// (template D).
//
// Numeric contract (flash_attention.py:103-159 and 297-336 at f32): the
// scores q.k are summed in f32 and scaled after the sum; masked scores
// carry exactly zero mass; O = sum(p v) / l with the online rescale, lse =
// m + log(l). Backward: P = exp(s * scale - lse), dP = dO.V^T, dS = P (dP -
// delta), dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K, every value f32
// (JAX's casts of P and dS to the input dtype are no-ops at f32).
//
// Layout: a block of 256 threads owns 64 rows, four threads a row.
// Forward: the rows are queries. Each tile of 64 keys and values is staged
// in shared memory, rows padded to D + 1 floats so that the four threads of
// a row and the eight rows of a warp read distinct banks. A thread holds
// its query row in registers, computes the scores of 16 keys (key 4 j +
// its lane), and the row's max and sum combine over its four threads by
// shuffles; P goes through shared memory, and the thread accumulates D / 4
// output columns (column 4 i + its lane) in registers.
// Fused backward: the rows are the 64 keys of one K/V tile. The block walks
// the Q tiles from the causal bound on; for each it writes P^T and dS^T (16
// queries a thread) into shared memory, adds to dK and dV (D / 4 columns a
// thread, in registers), and writes the Q tile's f32 dQ partial dS.K once
// into dqp[kv_tile, bh, q, :]. A second kernel sums each row's live
// partials in ascending KV tile. The two-kernel layout's dK/dV kernel is
// the same kernel without the dQ partial (bwd_kernel<D, false>).
// Its dQ kernel (dq_kernel<D>): the rows are 64 queries, four threads a row,
// each holding its query row and its dO row in registers. The block walks
// the key tiles from 0 to the causal bound in ascending order; for each it
// stages K and V (rows padded to D + 1), recomputes P = exp(s * scale -
// lse) and dP = dO.V^T for 16 keys a thread, writes dS = P (dP - delta)
// into shared memory and adds dS.K to D / 4 dQ columns a thread in
// registers. dQ is written once, scaled, at the end: no partials, no
// atomics. No kernel here uses atomics: every launch gives the same bits.
//
// Bound: per (b, h) the forward does 4 S^2 D FLOPs, the fused backward 10
// S^2 D, the dQ kernel 6 S^2 D and the dK/dV kernel 8 S^2 D (halved when
// causal) against 4 S D, 8 S D, 5 S D and 6 S D f32 values moved, so from
// a few dozen positions on the floor is operations over the f32 peak of 67
// TFLOP/s. These are the simple kernels: each FMA takes one operand from
// shared memory, so they run at a fraction of that peak; their times stand
// beside their bounds in PERF.md.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                 // a block's rows: queries (forward) or keys (backward)
constexpr int kTile = 64;                 // a streamed tile: keys (forward) or queries (backward)
constexpr int kLanes = kThreads / kRows;  // threads a row
constexpr int kPer = kTile / kLanes;      // tile columns a thread
constexpr int kPPad = kTile + 1;          // a padded row of a [64, 64] P or dS tile

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// Rows [r0, r0 + 64) of a [S, D] f32 slice into a tile of rows padded to
// D + 1 floats; rows past S read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0, int S) {
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r0 + r < S ? src[static_cast<int64_t>(r0 + r) * D + c] : 0.f;
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * kRows * (D + 1) + kRows * kPPad);
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * kRows * (D + 1) + 2 * kRows * kPPad + 2 * kTile);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kTile * (D + 1) + kRows * kPPad);
}

// One block per (b*h, 64-row Q tile); blockIdx.y counts the Q tiles from
// the last, so the longest causal rows start first.
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int S, float scale, int causal) {
  constexpr int kPad = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kRows * kPad;
  float* v_s = k_s + kRows * kPad;
  float* p_s = v_s + kRows * kPad;  // [64 queries][64 keys]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const int r = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int row = q0 + r;
  int n_kt = (S + kTile - 1) / kTile;
  // causal: key tiles wholly past this Q tile's last row are fully masked
  if (causal) n_kt = min(n_kt, (q0 + kRows + kTile - 1) / kTile);

  load_tile<D>(q_s, q + base, q0, S);
  __syncthreads();
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = q_s[r * kPad + d];
  float acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc[i] = 0.f;
  float m = dftt::kNegInf, l = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // every thread is done with the previous tile's K, V and P
    load_tile<D>(k_s, k + base, k0, S);
    load_tile<D>(v_s, v + base, k0, S);
    __syncthreads();
    float s[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = 0.f;
#pragma unroll  // whole: qr stays in registers
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[j] = fmaf(qd, k_s[(lane + kLanes * j) * kPad + d], s[j]);
    }
    float mx = dftt::kNegInf;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int key = k0 + lane + kLanes * j;
      s[j] = key >= S || (causal && key > row) ? dftt::kNegInf : s[j] * scale;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float safe = m_new <= dftt::kNegInf ? 0.f : m_new;
    const float corr = m <= dftt::kNegInf ? 0.f : expf(m - safe);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float p = s[j] <= dftt::kNegInf ? 0.f : expf(s[j] - safe);
      p_s[r * kPPad + lane + kLanes * j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // the row's P, written by its four threads of this warp
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) acc[i] *= corr;
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      const float p = p_s[r * kPPad + kk];
#pragma unroll
      for (int i = 0; i < D / kLanes; ++i)
        acc[i] = fmaf(p, v_s[kk * kPad + lane + kLanes * i], acc[i]);
    }
  }

  if (row < S) {
    const float lf = fmaxf(l, 1e-30f);
    float* dst = o + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) dst[lane + kLanes * i] = acc[i] / lf;
    if (lane == 0)
      lse[static_cast<int64_t>(bh) * S + row] = (m <= dftt::kNegInf ? 0.f : m) + logf(lf);
  }
}

// The KV tiles whose dQ partial the fused kernel writes for Q tile
// `q_tile`: all of them unless causal, else those at or before it (the
// tiles are both 64 rows). The second pass reads exactly these.
__device__ __forceinline__ int live_kv_tiles(int q_tile, int S, int causal) {
  const int n_kv = (S + kRows - 1) / kRows;
  return causal && q_tile + 1 < n_kv ? q_tile + 1 : n_kv;
}

// One block per (b*h, 64-key K/V tile), in ascending order. kDq: the fused
// kernel (dQ partials into dqp); without it, the two-kernel layout's dK/dV
// kernel (dqp unused).
template <int D, bool kDq>
__global__ void __launch_bounds__(kThreads) bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dqp, int S, float scale, int causal) {
  constexpr int kPad = D + 1;
  extern __shared__ float smem[];
  float* k_s = smem;  // this block's keys and values
  float* v_s = k_s + kRows * kPad;
  float* q_s = v_s + kRows * kPad;  // the streamed Q and dO tiles
  float* do_s = q_s + kTile * kPad;
  float* pt_s = do_s + kTile * kPad;  // P^T [64 keys][64 queries]
  float* dst_s = pt_s + kRows * kPPad;  // dS^T
  float* lse_s = dst_s + kRows * kPPad;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const int r = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int key = k0 + r;
  // causal: Q tiles wholly before this K tile see none of it
  const int qt0 = causal ? k0 / kTile : 0;
  const int n_qt = (S + kTile - 1) / kTile;

  load_tile<D>(k_s, k + base, k0, S);
  load_tile<D>(v_s, v + base, k0, S);
  float acc_dk[D / kLanes], acc_dv[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every thread is done with the previous Q tile (and K/V have landed)
    load_tile<D>(q_s, q + base, q0, S);
    load_tile<D>(do_s, dout + base, q0, S);
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const bool in = q0 + e < S;
      lse_s[e] = in ? lse[static_cast<int64_t>(bh) * S + q0 + e] : 0.f;
      delta_s[e] = in ? delta[static_cast<int64_t>(bh) * S + q0 + e] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for this thread's key and queries 4 j + lane
    float s[kPer], dp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[r * kPad + d], vd = v_s[r * kPad + d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qi = lane + kLanes * j;
        s[j] = fmaf(kd, q_s[qi * kPad + d], s[j]);
        dp[j] = fmaf(vd, do_s[qi * kPad + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int qi = lane + kLanes * j;
      const int qpos = q0 + qi;
      float p = expf(s[j] * scale - lse_s[qi]);
      if (qpos >= S || key >= S || (causal && qpos < key)) p = 0.f;
      pt_s[r * kPPad + qi] = p;
      dst_s[r * kPPad + qi] = p * (dp[j] - delta_s[qi]);
    }
    if constexpr (kDq) {
      __syncthreads();  // dQ reads every key's dS^T
    } else {
      __syncwarp();  // the row's P^T and dS^T, written by its four threads of this warp
    }

    // dV += P^T dO and dK += dS^T Q for this thread's key
#pragma unroll 4
    for (int qi = 0; qi < kTile; ++qi) {
      const float p = pt_s[r * kPPad + qi], ds = dst_s[r * kPPad + qi];
#pragma unroll
      for (int i = 0; i < D / kLanes; ++i) {
        const int c = lane + kLanes * i;
        acc_dv[i] = fmaf(p, do_s[qi * kPad + c], acc_dv[i]);
        acc_dk[i] = fmaf(ds, q_s[qi * kPad + c], acc_dk[i]);
      }
    }
    if constexpr (kDq) {
      // the Q tile's dQ partial dS.K over this block's keys: query row q0 + r
      float acc_dq[D / kLanes];
#pragma unroll
      for (int i = 0; i < D / kLanes; ++i) acc_dq[i] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kRows; ++kk) {
        const float ds = dst_s[kk * kPPad + r];
#pragma unroll
        for (int i = 0; i < D / kLanes; ++i)
          acc_dq[i] = fmaf(ds, k_s[kk * kPad + lane + kLanes * i], acc_dq[i]);
      }
      const int qrow = q0 + r;
      if (qrow < S) {
        float* dst = dqp + ((static_cast<int64_t>(blockIdx.y) * gridDim.x + bh) * S + qrow) * D;
#pragma unroll
        for (int i = 0; i < D / kLanes; ++i) dst[lane + kLanes * i] = acc_dq[i];
      }
    }
  }

  if (key < S) {
    const int64_t off = base + static_cast<int64_t>(key) * D;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) {
      dk[off + lane + kLanes * i] = acc_dk[i] * scale;
      dv[off + lane + kLanes * i] = acc_dv[i];
    }
  }
}

// The two-kernel layout's dQ: one block per (b*h, 64-row Q tile); blockIdx.y
// counts the Q tiles from the last, so the longest causal rows start first.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int S, float scale, int causal) {
  constexpr int kPad = D + 1;
  extern __shared__ float smem[];
  float* k_s = smem;  // the streamed K and V tiles (first the block's Q and dO)
  float* v_s = k_s + kTile * kPad;
  float* ds_s = v_s + kTile * kPad;  // dS [64 queries][64 keys]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const int r = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int row = q0 + r;
  int n_kt = (S + kTile - 1) / kTile;
  // causal: key tiles wholly past this Q tile's last row are fully masked
  if (causal) n_kt = min(n_kt, (q0 + kRows + kTile - 1) / kTile);

  load_tile<D>(k_s, q + base, q0, S);
  load_tile<D>(v_s, dout + base, q0, S);
  __syncthreads();
  float qr[D], dor[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = k_s[r * kPad + d];
    dor[d] = v_s[r * kPad + d];
  }
  const float lse_r = row < S ? lse[static_cast<int64_t>(bh) * S + row] : 0.f;
  const float delta_r = row < S ? delta[static_cast<int64_t>(bh) * S + row] : 0.f;
  float acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // every thread is done with the previous tiles (or Q and dO)
    load_tile<D>(k_s, k + base, k0, S);
    load_tile<D>(v_s, v + base, k0, S);
    __syncthreads();
    // S and dP for this thread's query and keys 4 j + lane
    float s[kPer], dp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = dp[j] = 0.f;
#pragma unroll  // whole: qr and dor stay in registers
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], od = dor[d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kj = (lane + kLanes * j) * kPad + d;
        s[j] = fmaf(qd, k_s[kj], s[j]);
        dp[j] = fmaf(od, v_s[kj], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int key = k0 + lane + kLanes * j;
      float p = expf(s[j] * scale - lse_r);
      if (row >= S || key >= S || (causal && key > row)) p = 0.f;
      ds_s[r * kPPad + lane + kLanes * j] = p * (dp[j] - delta_r);
    }
    __syncwarp();  // the row's dS, written by its four threads of this warp
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      const float ds = ds_s[r * kPPad + kk];
#pragma unroll
      for (int i = 0; i < D / kLanes; ++i)
        acc[i] = fmaf(ds, k_s[kk * kPad + lane + kLanes * i], acc[i]);
    }
  }

  if (row < S) {
    float* dst = dq + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) dst[lane + kLanes * i] = acc[i] * scale;
  }
}

// The fused backward's second pass: dq = scale * sum of dqp[j] over the
// live KV tiles j of each row's Q tile, in ascending j; one thread an
// element (n = B*H * S * D).
__global__ void __launch_bounds__(256) dq_sum_kernel(const float* __restrict__ dqp,
                                                     float* __restrict__ dq, int64_t n, int S,
                                                     int D, float scale, int causal) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = static_cast<int>((i / D) % S);
  const int stop = live_kv_tiles(row / kTile, S, causal);
  float acc = dqp[i];
  for (int j = 1; j < stop; ++j) acc += dqp[i + j * n];
  dq[i] = acc * scale;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
               int causal, float scale, cudaStream_t st) {
  constexpr size_t bytes = fwd_smem_bytes<D>();
  const int err = prepare(fwd_kernel<D>, bytes);
  if (err) return err;
  fwd_kernel<D><<<dim3(BH, (S + kRows - 1) / kRows), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, void* dqp, void* dq, int BH, int S,
               int causal, float scale, cudaStream_t st) {
  constexpr size_t bytes = bwd_smem_bytes<D>();
  int err = prepare(bwd_kernel<D, true>, bytes);
  if (err) return err;
  bwd_kernel<D, true><<<dim3(BH, (S + kRows - 1) / kRows), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dqp), S, scale, causal);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t n = static_cast<int64_t>(BH) * S * D;
  dq_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dqp), static_cast<float*>(dq), n, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int BH, int S, int causal, float scale,
              cudaStream_t st) {
  constexpr size_t bytes = dq_smem_bytes<D>();
  const int err = prepare(dq_kernel<D>, bytes);
  if (err) return err;
  dq_kernel<D><<<dim3(BH, (S + kRows - 1) / kRows), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int S, int causal, float scale,
               cudaStream_t st) {
  constexpr size_t bytes = bwd_smem_bytes<D>();
  const int err = prepare(bwd_kernel<D, false>, bytes);
  if (err) return err;
  bwd_kernel<D, false><<<dim3(BH, (S + kRows - 1) / kRows), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      nullptr, S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every tensor is contiguous f32: q, k, v, o, dout and the gradients
// [BH, S, D], lse and delta [BH, S], dqp [ceil(S / 64), BH, S, D] (never
// zeroed). D = 64 or 32; any other D returns cudaErrorInvalidValue. Each
// launches on `stream` and returns a CUDA error code (0 = launched).
// Signatures as the bf16 entry points' (flash_attention.cu,
// flash_attention_bwd.cu).

extern "C" int dftt_flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                            void* lse, int BH, int S, int D, int causal,
                                            float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_fwd<64>(q, k, v, o, lse, BH, S, causal, scale, st);
  if (D == 32) return launch_fwd<32>(q, k, v, o, lse, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused backward: dk = scale * sum of dS^T Q, dv = sum of P^T dO, and
// dq = scale * sum of dS K through the dqp partials (two kernels).
extern "C" int dftt_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, void* dqp, void* dq, int BH, int S, int D, int causal,
    float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_bwd<64>(q, k, v, dout, lse, delta, dk, dv, dqp, dq, BH, S, causal, scale, st);
  if (D == 32) return launch_bwd<32>(q, k, v, dout, lse, delta, dk, dv, dqp, dq, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The two-kernel layout's dQ: dq = scale * sum of dS K, one kernel.
extern "C" int dftt_flash_attention_dq_f32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dq, int BH, int S, int D, int causal, float scale,
                                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, S, causal, scale, st);
  if (D == 32) return launch_dq<32>(q, k, v, dout, lse, delta, dq, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The two-kernel layout's dK and dV: dk = scale * sum of dS^T Q, dv = sum of
// P^T dO, one kernel.
extern "C" int dftt_flash_attention_dkv_f32(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dk, void* dv, int BH, int S, int D, int causal,
                                            float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, S, causal, scale, st);
  if (D == 32) return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
