// Fused attention backward (bf16): dK, dV and dQ from one P per tile pair.
//
// Replaces the Pallas TPU kernel of the JAX package
//   distriflow_tpu/ops/flash_attention.py::_dkvq_kernel
// (the fused backward the JAX package takes while the KV-block count stays
// within _FUSED_BWD_MAX_KV_BLOCKS, which covers the flagship's S = 1024).
//
// Numeric contract (flash_attention.py:297-336): S = Q.K^T from bf16
// operands with f32 accumulation, scale folded in after the product;
// P = exp(S*scale - lse) with masked pairs at exactly 0; P is rounded to
// bf16 before P^T.dO; dP = dO.V^T in f32; dS = P (dP - delta) is rounded to
// bf16 before dS^T.Q and dS.K; every sum is f32; dK is scaled once at the
// end and written in bf16 with dV. dQ is not finished here: each block adds
// its f32 partial dS.K into a zeroed [B*H, S, D] f32 buffer, and the
// caller scales and casts it. lse and delta are plain f32 [B*H, S] rows
// (delta = rowsum(dO * O), minus any lse cotangent, computed by the caller).
//
// Grid: one block of 4 warps per (b*h, 64-position K/V tile); blockIdx.x is
// the K/V tile. The TPU kernel walks Q blocks on a sequential grid axis and
// carries dK/dV in VMEM scratch; here the block itself loops over the Q
// tiles at or after the causal bound (all of them when not causal) and
// keeps the dK/dV accumulators in WMMA fragments in registers, each warp
// owning 16 key rows. Per Q tile: S and dP (each warp its 16 query rows),
// P and dS in shared memory, then dV += P^T dO and dK += dS^T Q (each warp
// its 16 key rows), then the dQ partial dS K (each warp its 16 query rows)
// staged in shared memory and added to device memory with f32 atomicAdd.
// Rows and columns past S are zero-filled and masked, so any S works.
//
// dQ: the TPU kernel writes n_kv f32 partial copies of dQ and sums them
// outside; with 64-wide K tiles that would be S/64 copies (16 at the
// flagship's S = 1024, 268 MB per layer), so the partials are added with
// atomics instead. The order in which the K tiles' partials reach dQ is
// therefore not fixed: dQ may differ between runs in its last f32 bits
// before the bf16 cast.
//
// Bound: per (b, h) the work is 5 products of S*S*D/2 multiply-adds
// (S and dP recomputed, dV, dK, dQ; causal), 5*S*S*D FLOPs, on about
// 7*S*D*2 bytes of inputs and outputs: 5*S/14 FLOP per byte, ~366 at
// S = 1024, just past the H100's ~295 ridge, so at training lengths the
// floor is FLOPs / 989 TF/s with the byte floor close behind. This first
// version is simple rather than fast: synchronous tile loads, WMMA rather
// than wgmma, shared-memory round trips for S, dP, P and dS, and scalar
// atomics for dQ.

#include <cstdint>

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kB = 64;  // K/V positions per block, query rows per step

template <int D>
constexpr size_t smem_bytes() {
  // K, V, Q, dO tiles; P and dS in bf16; S and dP in f32; lse and delta rows
  return sizeof(__nv_bfloat16) * (4 * kB * D + 2 * kB * kB) +
         sizeof(float) * (2 * kB * kB + 2 * kB);
}

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

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ dq_acc, int S, float scale, int causal) {
  static_assert(D % 16 == 0 && D <= kB, "staging reuses the 64x64 f32 tiles");
  using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  using FragARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
  using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [kB][D]
  __nv_bfloat16* Vs = Ks + kB * D;                               // [kB][D]
  __nv_bfloat16* Qs = Vs + kB * D;                               // [kB][D]
  __nv_bfloat16* dOs = Qs + kB * D;                              // [kB][D]
  __nv_bfloat16* Ps = dOs + kB * D;                              // [q][k] bf16
  __nv_bfloat16* dSs = Ps + kB * kB;                             // [q][k] bf16
  float* Ss = reinterpret_cast<float*>(dSs + kB * kB);           // [q][k] f32
  float* dPs = Ss + kB * kB;                                     // [q][k] f32
  float* lse_s = dPs + kB * kB;
  float* delta_s = lse_s + kB;

  const int k0 = blockIdx.x * kB;
  const int64_t bh = blockIdx.y;
  const int64_t off = bh * S * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<D>(k + off, Ks, k0, S);
  load_tile<D>(v + off, Vs, k0, S);

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
    load_tile<D>(q + off, Qs, q0, S);
    load_tile<D>(dout + off, dOs, q0, S);
    load_rows(lse + bh * S, lse_s, q0, S);
    load_rows(delta + bh * S, delta_s, q0, S);
    __syncthreads();

    {  // S = Q K^T and dP = dO V^T for this warp's 16 query rows
      FragAcc s_acc[kB / 16], p_acc[kB / 16];
#pragma unroll
      for (int j = 0; j < kB / 16; ++j) {
        wmma::fill_fragment(s_acc[j], 0.f);
        wmma::fill_fragment(p_acc[j], 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        FragARow aq, ado;
        wmma::load_matrix_sync(aq, Qs + warp * 16 * D + kk, D);
        wmma::load_matrix_sync(ado, dOs + warp * 16 * D + kk, D);
#pragma unroll
        for (int j = 0; j < kB / 16; ++j) {
          FragBCol bk, bv;
          wmma::load_matrix_sync(bk, Ks + j * 16 * D + kk, D);
          wmma::load_matrix_sync(bv, Vs + j * 16 * D + kk, D);
          wmma::mma_sync(s_acc[j], aq, bk, s_acc[j]);
          wmma::mma_sync(p_acc[j], ado, bv, p_acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kB / 16; ++j) {
        wmma::store_matrix_sync(Ss + warp * 16 * kB + j * 16, s_acc[j], kB, wmma::mem_row_major);
        wmma::store_matrix_sync(dPs + warp * 16 * kB + j * 16, p_acc[j], kB, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // P = exp(S*scale - lse), 0 where masked; dS = P (dP - delta); own rows
    for (int i = lane; i < 16 * kB; i += 32) {
      const int r = warp * 16 + i / kB;
      const int c = i % kB;
      const int qpos = q0 + r;
      const int kpos = k0 + c;
      const bool ok = qpos < S && kpos < S && (!causal || qpos >= kpos);
      const float p = ok ? expf(Ss[r * kB + c] * scale - lse_s[r]) : 0.f;
      Ps[r * kB + c] = __float2bfloat16(p);
      dSs[r * kB + c] = __float2bfloat16(p * (dPs[r * kB + c] - delta_s[r]));
    }
    __syncthreads();  // dV and dK read every query row of P and dS

    // dV += P^T dO and dK += dS^T Q for this warp's 16 key rows
#pragma unroll
    for (int kk = 0; kk < kB; kk += 16) {
      FragACol pt, dst;
      wmma::load_matrix_sync(pt, Ps + warp * 16 + kk * kB, kB);
      wmma::load_matrix_sync(dst, dSs + warp * 16 + kk * kB, kB);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragBRow bdo, bq;
        wmma::load_matrix_sync(bdo, dOs + kk * D + j * 16, D);
        wmma::load_matrix_sync(bq, Qs + kk * D + j * 16, D);
        wmma::mma_sync(dv_acc[j], pt, bdo, dv_acc[j]);
        wmma::mma_sync(dk_acc[j], dst, bq, dk_acc[j]);
      }
    }

    {  // dQ partial = dS K for this warp's 16 query rows, added with atomics
      FragAcc acc[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < kB; kk += 16) {
        FragARow ads;
        wmma::load_matrix_sync(ads, dSs + warp * 16 * kB + kk, kB);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          FragBRow bk;
          wmma::load_matrix_sync(bk, Ks + kk * D + j * 16, D);
          wmma::mma_sync(acc[j], ads, bk, acc[j]);
        }
      }
      // stage in this warp's own rows of Ss: no other warp reads them
      float* stage = Ss + warp * 16 * kB;
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
  float* stage_k = Ss + warp * 16 * kB;
  float* stage_v = dPs + warp * 16 * kB;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(stage_k + j * 16, dk_acc[j], D, wmma::mem_row_major);
    wmma::store_matrix_sync(stage_v + j * 16, dv_acc[j], D, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = k0 + warp * 16 + i / D;
    if (r < S) {
      const int64_t g = off + static_cast<int64_t>(r) * D + i % D;
      dk[g] = __float2bfloat16(stage_k[i] * scale);
      dv[g] = __float2bfloat16(stage_v[i]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, void* dq_acc,
           int BH, int S, int causal, float scale, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kB - 1) / kB, BH);
  bwd_kernel<D><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<float*>(dq_acc), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, dout, lse, delta, dk, dv, dq_acc, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
