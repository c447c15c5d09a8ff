// Prefill attention forward (bf16), writing O and the per-row logsumexp.
//
// Replaces the Pallas TPU kernel of the JAX package
//   distriflow_tpu/ops/flash_attention.py::_fwd_kernel
// (causal or non-causal online-softmax attention with a causal tile skip).
//
// Numeric contract (flash_attention.py:103-159): Q.K^T takes bf16 operands
// with f32 accumulation, the 1/sqrt(D) scale folds in after the product,
// masked scores are -1e30 and carry exactly zero mass, p is rounded to
// bf16 for the PV product, the accumulator and m/l stay f32. O is written
// in bf16; lse = m + log(l) is written as a plain f32 [B*H, S] array (the
// TPU kernel's 128-lane replicated copy was a TPU layout artifact).
//
// Grid: one block of 4 warps per (b*h, 64-row query tile); blockIdx.x is
// the query tile. The block walks 64-position K/V tiles up to the causal
// bound, keeping Q, the current K/V tile, the score and probability tiles
// and the f32 output accumulator in shared memory. Both products run on
// the tensor cores through WMMA 16x16x16 bf16 fragments; each warp owns 16
// query rows. Rows and columns past S are zero-filled and masked, so any
// S works and the shared-memory footprint does not depend on S.
//
// Bound: at prefill lengths (S of a few hundred to a few thousand) the
// work is 4*S^2*D FLOPs (halved when causal) against 4*S*D*2 bytes per
// (b, h), so the floor is FLOPs / 989 TF/s. This first version is simple
// rather than fast: synchronous tile loads, WMMA rather than wgmma, and a
// shared-memory round trip for the score tile.

#include <cstdint>

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kBQ = 64;
constexpr int kBK = 64;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (kBQ * D + 2 * kBK * D + kBQ * kBK) +
         sizeof(float) * (kBQ * kBK + kBQ * D + 3 * kBQ);
}

template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, int row0, int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(row0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * D + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][D]
  __nv_bfloat16* Ks = Qs + kBQ * D;                               // [BK][D]
  __nv_bfloat16* Vs = Ks + kBK * D;                               // [BK][D]
  __nv_bfloat16* Ps = Vs + kBK * D;                               // [BQ][BK]
  float* Ss = reinterpret_cast<float*>(Ps + kBQ * kBK);           // [BQ][BK]
  float* Os = Ss + kBQ * kBK;                                     // [BQ][D]
  float* m_s = Os + kBQ * D;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int64_t bh = blockIdx.y;
  const int64_t off = bh * S * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  load_tile<D>(q + off, Qs, q0, S);
  for (int i = tid; i < kBQ * D; i += kThreads) Os[i] = 0.f;
  if (tid < kBQ) {
    m_s[tid] = dftt::kNegInf;
    l_s[tid] = 0.f;
  }

  int n_kb = (S + kBK - 1) / kBK;
  if (causal) {
    // K tiles wholly past this Q tile's last row are fully masked: skip them
    const int last = (q0 + kBQ + kBK - 1) / kBK;
    n_kb = n_kb < last ? n_kb : last;
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    load_tile<D>(k + off, Ks, k0, S);
    load_tile<D>(v + off, Vs, k0, S);
    __syncthreads();

    {  // S = Q K^T for this warp's 16 rows, 4 fragments across the tile
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * D + kk, D);
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, Ks + j * 16 * D + kk, D);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * kBK + j * 16, acc[j], kBK, wmma::mem_row_major);
    }
    __syncthreads();

    {  // online softmax: two neighbouring lanes per query row, 32 columns each
      const int r = tid >> 1;
      const int c0 = (tid & 1) * (kBK / 2);
      const int qpos = q0 + r;
      float* srow = Ss + r * kBK;
      float mx = dftt::kNegInf;
      for (int c = c0; c < c0 + kBK / 2; ++c) {
        const int kpos = k0 + c;
        const bool ok = kpos < S && (!causal || qpos >= kpos);
        const float s = ok ? srow[c] * scale : dftt::kNegInf;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float safe = m_new <= dftt::kNegInf ? 0.f : m_new;
      float sum = 0.f;
      for (int c = c0; c < c0 + kBK / 2; ++c) {
        const float s = srow[c];
        const float p = s <= dftt::kNegInf ? 0.f : expf(s - safe);
        Ps[r * kBK + c] = __float2bfloat16(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = m_old <= dftt::kNegInf ? 0.f : expf(m_old - safe);
      if ((tid & 1) == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // O = O * corr + P V, this warp's 16 rows (its rows only: no block sync)
    for (int i = tid & 31; i < 16 * D; i += 32) {
      const int r = warp * 16 + i / D;
      Os[r * D + i % D] *= c_s[r];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + warp * 16 * D + j * 16, D, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + warp * 16 * kBK + kk, kBK);
        wmma::load_matrix_sync(bv, Vs + kk * D + j * 16, D);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + warp * 16 * D + j * 16, acc, D, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    if (q0 + r < S) {
      const float lf = fmaxf(l_s[r], 1e-30f);
      o[off + static_cast<int64_t>(q0 + r) * D + i % D] = __float2bfloat16(Os[i] / lf);
    }
  }
  if (tid < kBQ && q0 + tid < S) {
    const float lf = fmaxf(l_s[tid], 1e-30f);
    const float mm = m_s[tid] <= dftt::kNegInf ? 0.f : m_s[tid];
    lse[bh * S + q0 + tid] = mm + logf(lf);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int S, int causal, float scale, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  fwd_kernel<D><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [BH, S, D] bf16 contiguous; lse: [BH, S] f32. Launches on
// `stream`; returns cudaGetLastError() (0 = launched). Built for D = 64
// only, the head dim of the served configuration.
extern "C" int dftt_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int BH,
    int S, int D, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, o, lse, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
