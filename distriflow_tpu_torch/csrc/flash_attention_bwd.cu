// Attention backward (bf16): the fused kernel and the two-kernel layout.
//
// Replaces the Pallas TPU kernels of the JAX package
//   distriflow_tpu/ops/flash_attention.py::_dkvq_kernel  (fused: dK, dV, dQ)
//   distriflow_tpu/ops/flash_attention.py::_dq_kernel    (two-kernel: dQ)
//   distriflow_tpu/ops/flash_attention.py::_dkv_kernel   (two-kernel: dK, dV)
// The JAX package takes the fused kernel while its backward tiles give at
// most _FUSED_BWD_MAX_KV_BLOCKS = 8 KV blocks (the flagship's S = 1024) and
// the two kernels past that (bf16 at D 64: S > 8192, long-context
// training); the wrappers in ops/flash_attention.py take the same decision.
//
// Numeric contract (flash_attention.py:171-336): S = Q.K^T from bf16
// operands with f32 accumulation, scale folded in after the product;
// P = exp(S*scale - lse) with masked pairs at exactly 0; P is rounded to
// bf16 before P^T.dO; dP = dO.V^T in f32; dS = P (dP - delta) is rounded to
// bf16 before dS^T.Q and dS.K; every sum is f32; dK and dQ are scaled once
// at the end and written in bf16 with dV. lse and delta are plain f32
// [B*H, S] rows (delta = rowsum(dO * O), minus any lse cotangent, computed
// by the caller).
//
// Every kernel runs blocks of 4 warps over 64-position tiles, WMMA bf16
// products with f32 accumulators, and stages S, dP, P and dS in shared
// memory. Rows and columns past S are zero-filled and masked, so any S
// works.
//
// fused (bwd_kernel): one block per (b*h, K/V tile) walks the Q tiles at or
// after the causal bound (all of them when not causal), keeps dK/dV in
// fragments (each warp owning 16 key rows) and adds each Q tile's dQ
// partial dS.K into a zeroed [B*H, S, D] f32 buffer with atomicAdd; the
// caller scales and casts it. The TPU kernel writes n_kv f32 partial copies
// of dQ instead; with 64-wide tiles that would be S/64 copies. The order in
// which the K tiles' partials reach dQ is not fixed: dQ may differ between
// runs in its last f32 bits before the bf16 cast.
//
// dQ (dq_kernel): one block per (b*h, 64-row Q tile) walks the K tiles up to
// the causal bound, recomputes S and P, forms dP and dS for its own rows
// and accumulates dQ += dS.K in fragments (each warp its 16 query rows). It
// writes dQ*scale in bf16 once: no atomics, so dQ adds its K tiles in one
// fixed order and is the same every run. At S = 16384 the fused kernel
// would add 256 K tiles' partials into every dQ row with atomics; this is
// the reason for the two layouts on this card too.
// dK/dV (dkv_kernel): the fused kernel without the dQ partial.
//
// Bound: per (b, h) the fused kernel runs 5 products of S*S*D/2
// multiply-adds (causal), the dQ kernel 3 (S, dP, dQ) and the dK/dV kernel 4
// (S, dP, dV, dK), on about 7*S*D*2 bytes of inputs and outputs: at
// training lengths and beyond the floor is FLOPs / 989 TF/s. This first
// version is simple rather than fast: synchronous tile loads, WMMA rather
// than wgmma, shared-memory round trips for S, dP, P and dS, causal work
// spread unevenly over the blocks (a K tile near the start meets every Q
// tile, one near the end almost none).

#include <cstdint>

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kB = 64;  // positions per tile

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;

// Shared memory of every kernel: K, V, Q, dO tiles; P and dS in bf16; S and
// dP in f32; lse and delta rows. (The dQ kernel leaves P unused.)
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (4 * kB * D + 2 * kB * kB) +
         sizeof(float) * (2 * kB * kB + 2 * kB);
}

template <int D>
struct Tiles {
  __nv_bfloat16 *Ks, *Vs, *Qs, *dOs, *Ps, *dSs;
  float *Ss, *dPs, *lse_s, *delta_s;

  __device__ explicit Tiles(unsigned char* smem) {
    Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [kB][D]
    Vs = Ks + kB * D;                              // [kB][D]
    Qs = Vs + kB * D;                              // [kB][D]
    dOs = Qs + kB * D;                             // [kB][D]
    Ps = dOs + kB * D;                             // [q][k] bf16
    dSs = Ps + kB * kB;                            // [q][k] bf16
    Ss = reinterpret_cast<float*>(dSs + kB * kB);  // [q][k] f32
    dPs = Ss + kB * kB;                            // [q][k] f32
    lse_s = dPs + kB * kB;
    delta_s = lse_s + kB;
  }
};

template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, int row0, int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kB * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(row0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * D + col) = val;
  }
}

__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, int row0, int S) {
  for (int i = threadIdx.x; i < kB; i += kThreads) dst[i] = row0 + i < S ? src[row0 + i] : 0.f;
}

// S = Q K^T and dP = dO V^T for this warp's 16 query rows, into Ss and dPs.
template <int D>
__device__ __forceinline__ void warp_scores(const Tiles<D>& t, int warp) {
  FragAcc s_acc[kB / 16], p_acc[kB / 16];
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) {
    wmma::fill_fragment(s_acc[j], 0.f);
    wmma::fill_fragment(p_acc[j], 0.f);
  }
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragARow aq, ado;
    wmma::load_matrix_sync(aq, t.Qs + warp * 16 * D + kk, D);
    wmma::load_matrix_sync(ado, t.dOs + warp * 16 * D + kk, D);
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      FragBCol bk, bv;
      wmma::load_matrix_sync(bk, t.Ks + j * 16 * D + kk, D);
      wmma::load_matrix_sync(bv, t.Vs + j * 16 * D + kk, D);
      wmma::mma_sync(s_acc[j], aq, bk, s_acc[j]);
      wmma::mma_sync(p_acc[j], ado, bv, p_acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) {
    wmma::store_matrix_sync(t.Ss + warp * 16 * kB + j * 16, s_acc[j], kB, wmma::mem_row_major);
    wmma::store_matrix_sync(t.dPs + warp * 16 * kB + j * 16, p_acc[j], kB, wmma::mem_row_major);
  }
}

// P = exp(S*scale - lse), 0 where masked, and dS = P (dP - delta), both in
// bf16, for this warp's 16 query rows (P only when kWithP).
template <int D, bool kWithP>
__device__ __forceinline__ void warp_probs(const Tiles<D>& t, int warp, int lane, int q0, int k0,
                                           int S, float scale, int causal) {
  for (int i = lane; i < 16 * kB; i += 32) {
    const int r = warp * 16 + i / kB;
    const int c = i % kB;
    const int qpos = q0 + r;
    const int kpos = k0 + c;
    const bool ok = qpos < S && kpos < S && (!causal || qpos >= kpos);
    const float p = ok ? expf(t.Ss[r * kB + c] * scale - t.lse_s[r]) : 0.f;
    if (kWithP) t.Ps[r * kB + c] = __float2bfloat16(p);
    t.dSs[r * kB + c] = __float2bfloat16(p * (t.dPs[r * kB + c] - t.delta_s[r]));
  }
}

// dV += P^T dO and dK += dS^T Q for this warp's 16 key rows (reads every
// query row of P and dS).
template <int D>
__device__ __forceinline__ void warp_dkv(const Tiles<D>& t, int warp, FragAcc* dk_acc,
                                         FragAcc* dv_acc) {
#pragma unroll
  for (int kk = 0; kk < kB; kk += 16) {
    FragACol pt, dst;
    wmma::load_matrix_sync(pt, t.Ps + warp * 16 + kk * kB, kB);
    wmma::load_matrix_sync(dst, t.dSs + warp * 16 + kk * kB, kB);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragBRow bdo, bq;
      wmma::load_matrix_sync(bdo, t.dOs + kk * D + j * 16, D);
      wmma::load_matrix_sync(bq, t.Qs + kk * D + j * 16, D);
      wmma::mma_sync(dv_acc[j], pt, bdo, dv_acc[j]);
      wmma::mma_sync(dk_acc[j], dst, bq, dk_acc[j]);
    }
  }
}

// acc += dS K for this warp's 16 query rows.
template <int D>
__device__ __forceinline__ void warp_ds_k(const Tiles<D>& t, int warp, FragAcc* acc) {
#pragma unroll
  for (int kk = 0; kk < kB; kk += 16) {
    FragARow ads;
    wmma::load_matrix_sync(ads, t.dSs + warp * 16 * kB + kk, kB);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragBRow bk;
      wmma::load_matrix_sync(bk, t.Ks + kk * D + j * 16, D);
      wmma::mma_sync(acc[j], ads, bk, acc[j]);
    }
  }
}

// A warp's 16 x D accumulator staged row-major at `stage` (16 * kB floats of
// its own), then written as bf16(acc * mul) to rows [row0, row0 + 16) of
// `dst` ([S, D]), skipping rows past S.
template <int D>
__device__ __forceinline__ void store_rows(float* stage, const FragAcc* acc, __nv_bfloat16* dst,
                                           int row0, int S, float mul, int lane) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(stage + j * 16, acc[j], D, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32)
    if (row0 + i / D < S) dst[static_cast<int64_t>(row0) * D + i] = __float2bfloat16(stage[i] * mul);
}

// The K/V tile's side of the backward: dK and dV over the Q tiles it meets,
// plus (kDq) each Q tile's dQ partial added to dq_acc with atomics.
template <int D, bool kDq>
__device__ __forceinline__ void dkv_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ dq_acc, int S, float scale, int causal) {
  static_assert(D % 16 == 0 && D <= kB, "staging reuses the 64x64 f32 tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<D> t(smem);
  const int k0 = blockIdx.x * kB;
  const int64_t bh = blockIdx.y;
  const int64_t off = bh * S * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<D>(k + off, t.Ks, k0, S);
  load_tile<D>(v + off, t.Vs, k0, S);

  FragAcc dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  const int n_q = (S + kB - 1) / kB;
  // causal: Q tiles wholly before this K tile see none of it
  for (int qb = causal ? blockIdx.x : 0; qb < n_q; ++qb) {
    const int q0 = qb * kB;
    __syncthreads();  // the previous step's readers are done with the tiles
    load_tile<D>(q + off, t.Qs, q0, S);
    load_tile<D>(dout + off, t.dOs, q0, S);
    load_rows(lse + bh * S, t.lse_s, q0, S);
    load_rows(delta + bh * S, t.delta_s, q0, S);
    __syncthreads();
    warp_scores<D>(t, warp);
    __syncwarp();
    warp_probs<D, true>(t, warp, lane, q0, k0, S, scale, causal);
    __syncthreads();  // dV and dK read every query row of P and dS
    warp_dkv<D>(t, warp, dk_acc, dv_acc);
    if (kDq) {  // dQ partial = dS K for this warp's 16 query rows
      FragAcc acc[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
      warp_ds_k<D>(t, warp, acc);
      // stage in this warp's own rows of Ss: no other warp reads them
      float* stage = t.Ss + warp * 16 * kB;
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wmma::store_matrix_sync(stage + j * 16, acc[j], D, wmma::mem_row_major);
      __syncwarp();
      const int row0 = q0 + warp * 16;
      float* dst = dq_acc + off + static_cast<int64_t>(row0) * D;
      for (int i = lane; i < 16 * D; i += 32)
        if (row0 + i / D < S) atomicAdd(dst + i, stage[i]);
    }
  }
  __syncthreads();

  // dK = scale * acc and dV = acc in bf16, this warp's 16 key rows
  const int row0 = k0 + warp * 16;
  store_rows<D>(t.Ss + warp * 16 * kB, dk_acc, dk + off, row0, S, scale, lane);
  store_rows<D>(t.dPs + warp * 16 * kB, dv_acc, dv + off, row0, S, 1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ dq_acc, int S, float scale, int causal) {
  dkv_body<D, true>(q, k, v, dout, lse, delta, dk, dv, dq_acc, S, scale, causal);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, float scale,
    int causal) {
  dkv_body<D, false>(q, k, v, dout, lse, delta, dk, dv, nullptr, S, scale, causal);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int S, float scale, int causal) {
  static_assert(D % 16 == 0 && D <= kB, "staging reuses the 64x64 f32 tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<D> t(smem);
  const int q0 = blockIdx.x * kB;
  const int64_t bh = blockIdx.y;
  const int64_t off = bh * S * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<D>(q + off, t.Qs, q0, S);
  load_tile<D>(dout + off, t.dOs, q0, S);
  load_rows(lse + bh * S, t.lse_s, q0, S);
  load_rows(delta + bh * S, t.delta_s, q0, S);

  FragAcc acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  // causal: K tiles wholly after this Q tile's last row see none of it
  const int last = causal ? blockIdx.x : (S + kB - 1) / kB - 1;
  for (int kb = 0; kb <= last; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();  // the previous step's readers are done with K and V
    load_tile<D>(k + off, t.Ks, k0, S);
    load_tile<D>(v + off, t.Vs, k0, S);
    __syncthreads();
    // every step below touches only this warp's 16 query rows of S, dP, dS
    warp_scores<D>(t, warp);
    __syncwarp();
    warp_probs<D, false>(t, warp, lane, q0, k0, S, scale, causal);
    __syncwarp();
    warp_ds_k<D>(t, warp, acc);
  }
  __syncwarp();
  store_rows<D>(t.Ss + warp * 16 * kB, acc, dq + off, q0 + warp * 16, S, scale, lane);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// q, k, v, dout, dk, dv: [BH, S, D] bf16 contiguous; lse, delta: [BH, S]
// f32; dq_acc: [BH, S, D] f32, zeroed by the caller, receives the unscaled
// dQ (sum over K tiles of dS.K). Launches on `stream`; returns
// cudaGetLastError() (0 = launched). Built for D = 64 only, the head dim of
// the trained and served configuration.
extern "C" int dftt_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* dq_acc,
    int BH, int S, int D, int causal, float scale, void* stream) {
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = smem_bytes<64>();
  const int err = prepare(bwd_kernel<64>, bytes);
  if (err) return err;
  bwd_kernel<64><<<dim3((S + kB - 1) / kB, BH), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<float*>(dq_acc), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The two-kernel layout, first half: dq [BH, S, D] bf16 = scale * sum over
// K tiles of dS.K, written once per Q tile. Inputs as above.
extern "C" int dftt_flash_attention_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int BH, int S, int D, int causal, float scale, void* stream) {
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = smem_bytes<64>();
  const int err = prepare(dq_kernel<64>, bytes);
  if (err) return err;
  dq_kernel<64><<<dim3((S + kB - 1) / kB, BH), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The two-kernel layout, second half: dk = scale * sum over Q tiles of
// dS^T.Q and dv = sum of P^T.dO, both [BH, S, D] bf16. Inputs as above.
extern "C" int dftt_flash_attention_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int BH, int S, int D, int causal, float scale, void* stream) {
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = smem_bytes<64>();
  const int err = prepare(dkv_kernel<64>, bytes);
  if (err) return err;
  dkv_kernel<64><<<dim3((S + kB - 1) / kB, BH), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
