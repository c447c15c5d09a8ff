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
// Kernels 6 and 7 (fused, dQ) run blocks of 4 warps over 64-position
// tiles, WMMA bf16 products with f32 accumulators, and stage S, dP, P and
// dS in shared memory. Rows and columns past S are zero-filled and masked,
// so any S works.
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
//
// dK/dV (dkv_kernel) is built for Hopper: TMA loads, mbarriers and wgmma
// with every intermediate in registers (see its own note below). No
// atomics either, so it gives the same bits every run.
//
// Bound: per (b, h) the fused kernel runs 5 products of S*S*D/2
// multiply-adds (causal), the dQ kernel 3 (S, dP, dQ) and the dK/dV kernel 4
// (S, dP, dV, dK), on about 7*S*D*2 bytes of inputs and outputs: at
// training lengths and beyond the floor is FLOPs / 989 TF/s. Kernels 6 and
// 7 are simple rather than fast: synchronous tile loads, WMMA rather than
// wgmma, shared-memory round trips for S, dP, P and dS, causal work spread
// unevenly over the blocks (a K tile near the start meets every Q tile,
// one near the end almost none).

#include <cstdint>

#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

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

// The K/V tile's side of the fused backward: dK and dV over the Q tiles it
// meets, plus each Q tile's dQ partial added to dq_acc with atomics.
template <int D>
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
    {  // dQ partial = dS K for this warp's 16 query rows
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
  dkv_body<D>(q, k, v, dout, lse, delta, dk, dv, dq_acc, S, scale, causal);
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

// ---------------------------------------------------------------------------
// dK/dV for Hopper (kernel 8).
//
// One block per (b*h, 128-key K/V tile): two consumer warpgroups own 64 key
// rows each and keep their dK and dV accumulators in f32 registers for the
// whole walk; one producer warp loads the K/V tile once by TMA and then
// streams 64-row Q and dO tiles, from the causal bound on, through a ring
// of kStages stages. The producer's 32 lanes also read that tile's lse and
// delta rows from the plain [B*H, S] rows (zeros past S, where P is masked
// to 0) into the same stage, and each lane arrives on the stage's full
// barrier, so the consumers see them with the TMA bytes. For each Q tile a
// warpgroup runs four wgmma products:
//   S^T = K.Q^T and dP^T = V.dO^T (both operands in shared memory, K-major),
//   P^T = exp(S^T * scale - lse) in registers (lse indexes the column; expf
//   of the same f32 argument as the plain version),
//   dV += P^T.dO with P^T as bf16 in registers (dO read MN-major),
//   dS^T = P^T (dP^T - delta) as bf16 in registers, dK += dS^T.Q.
// S, dP, P and dS never touch shared memory. The numeric contract is the
// two-kernel one above: P and dS rounded to bf16 before their products,
// every sum f32, dK scaled once at the end. No atomics and one fixed walk
// order: the same bits every launch. blockIdx.x is the head and blockIdx.y
// the K tile in ascending order, so the heaviest causal tiles start first.
namespace {
namespace dkv {

using namespace dftt::hopper;

constexpr int kD = 64;
constexpr int kConsumers = 2;            // warpgroups, 64 key rows each
constexpr int kBKV = 64 * kConsumers;    // key rows per block
constexpr int kBQ = 64;                  // query rows per streamed tile
constexpr int kStages = 3;
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr uint32_t kKVBytes = kBKV * kRowBytes;
constexpr uint32_t kQBytes = kBQ * kRowBytes;
using Pipe = Ring<kStages>;

constexpr size_t kSmemBytes = kSwizzleBytes + 2 * kKVBytes + 2 * kStages * kQBytes +
                              2 * kStages * kBQ * sizeof(float) +
                              sizeof(uint64_t) * (1 + 2 * kStages);

__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, float scale,
    int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = aligned_smem(smem_raw);
  unsigned char* v_s = k_s + kKVBytes;
  unsigned char* q_s = v_s + kKVBytes;
  unsigned char* do_s = q_s + kStages * kQBytes;
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * kQBytes);
  float* delta_s = lse_s + kStages * kBQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + kStages * kBQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBKV;
  // causal: Q tiles wholly before this K tile see none of it
  const int qt0 = causal ? k0 / kBQ : 0;
  const int n_steps = (S + kBQ - 1) / kBQ - qt0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's lanes
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * kKVBytes);
      tma_load_rows(k_s, &tm_k, k0, bh, kv_full);
      tma_load_rows(v_s, &tm_v, k0, bh, kv_full);
    }
    const float* lse_bh = lse + static_cast<int64_t>(bh) * S;
    const float* delta_bh = delta + static_cast<int64_t>(bh) * S;
    for (int t = 0; t < n_steps; ++t) {
      const int s = Pipe::stage(t);
      const int q0 = (qt0 + t) * kBQ;
      // this lane's rows q0 + lane and q0 + lane + 32, read before the wait
      float l[2], d[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q0 + lane + 32 * i;
        l[i] = r < S ? lse_bh[r] : 0.f;
        d[i] = r < S ? delta_bh[r] : 0.f;
      }
      mbar_wait(&empty[s], Pipe::empty_parity(t));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse_s[s * kBQ + lane + 32 * i] = l[i];
        delta_s[s * kBQ + lane + 32 * i] = d[i];
      }
      // each lane's arrive releases its own stores to the consumers
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
        tma_load_rows(q_s + s * kQBytes, &tm_q, q0, bh, &full[s]);
        tma_load_rows(do_s + s * kQBytes, &tm_do, q0, bh, &full[s]);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: key rows first_key .. first_key + 63; this thread
  // holds keys key0 and key0 + 8 and, of each Q tile, the query columns
  // 8n + col + {0, 1}
  const int wg = warp / 4;
  const int first_key = k0 + 64 * wg;
  const int key0 = first_key + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  float acc_dk[kD / 2], acc_dv[kD / 2], acc_s[kBQ / 2], acc_dp[kBQ / 2];
#pragma unroll
  for (int r = 0; r < kD / 2; ++r) acc_dk[r] = acc_dv[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kBQ / 2; ++r) acc_s[r] = acc_dp[r] = 0.f;

  mbar_wait(kv_full, 0);
  const uint64_t desc_k = desc_kmajor(k_s + 64 * wg * kRowBytes);
  const uint64_t desc_v = desc_kmajor(v_s + 64 * wg * kRowBytes);

  for (int t = 0; t < n_steps; ++t) {
    const int s = Pipe::stage(t);
    const int q0 = (qt0 + t) * kBQ;
    mbar_wait(&full[s], Pipe::full_parity(t));
    // causal: every query of this tile precedes every key of this warpgroup
    if (causal && q0 + kBQ - 1 < first_key) {
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const unsigned char* q_t = q_s + s * kQBytes;
    const unsigned char* do_t = do_s + s * kQBytes;
    const uint64_t desc_q = desc_kmajor(q_t), desc_do = desc_kmajor(do_t);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kD / 16; ++j)
      wgmma_m64n64k16_ss<0>(acc_s, desc_k + kmajor_step(j), desc_q + kmajor_step(j), j > 0);
#pragma unroll
    for (int j = 0; j < kD / 16; ++j)
      wgmma_m64n64k16_ss<0>(acc_dp, desc_v + kmajor_step(j), desc_do + kmajor_step(j), j > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    fence_regs(acc_dp);

    // P^T (f32) into acc_s and dS^T (f32) into acc_dp
    const bool masked = q0 + kBQ > S || (causal && q0 < first_key + 63);
    const float* lse_t = lse_s + s * kBQ;
    const float* delta_t = delta_s + s * kBQ;
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
      const float2 lq = *reinterpret_cast<const float2*>(lse_t + 8 * n + col);
      const float2 dq = *reinterpret_cast<const float2*>(delta_t + 8 * n + col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 4 * n + 2 * i + j;
          float p = expf(acc_s[r] * scale - (j ? lq.y : lq.x));
          if (masked) {
            const int qpos = q0 + 8 * n + col + j;
            if (qpos >= S || (causal && qpos < key0 + 8 * i)) p = 0.f;
          }
          acc_s[r] = p;
          acc_dp[r] = p * (acc_dp[r] - (j ? dq.y : dq.x));
        }
    }
    uint32_t p_a[kBQ / 16][4], ds_a[kBQ / 16][4];
    acc_to_a(acc_s, p_a);
    acc_to_a(acc_dp, ds_a);

    const uint64_t desc_do_mn = desc_mnmajor(do_t), desc_q_mn = desc_mnmajor(q_t);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBQ / 16; ++c)
      wgmma_m64n64k16_rs<1>(acc_dv, p_a[c], desc_do_mn + mnmajor_step(c), 1);
#pragma unroll
    for (int c = 0; c < kBQ / 16; ++c)
      wgmma_m64n64k16_rs<1>(acc_dk, ds_a[c], desc_q_mn + mnmajor_step(c), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    fence_regs(p_a);
    fence_regs(ds_a);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with the stage
  }

  // dK = scale * acc and dV = acc in bf16, straight from registers
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= S) continue;
    const int64_t off = (static_cast<int64_t>(bh) * S + key) * kD + col;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) = __floats2bfloat162_rn(
          acc_dk[4 * n + 2 * i] * scale, acc_dk[4 * n + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(acc_dv[4 * n + 2 * i], acc_dv[4 * n + 2 * i + 1]);
    }
  }
}

}  // namespace dkv
}  // namespace

// The two-kernel layout, second half: dk = scale * sum over Q tiles of
// dS^T.Q and dv = sum of P^T.dO, both [BH, S, D] bf16; q, k, v, dout as
// above (16-byte aligned); lse and delta are the plain f32 [BH, S] rows.
// Returns a CUDA error code (0 = launched; a tensor map that cannot
// be encoded returns cudaErrorInvalidValue).
extern "C" int dftt_flash_attention_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int BH, int S, int D, int causal, float scale, void* stream) {
  if (D != dkv::kD) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = dftt::hopper::make_row_map(&tm_q, q, BH, S, dkv::kBQ);
  if (!err) err = dftt::hopper::make_row_map(&tm_do, dout, BH, S, dkv::kBQ);
  if (!err) err = dftt::hopper::make_row_map(&tm_k, k, BH, S, dkv::kBKV);
  if (!err) err = dftt::hopper::make_row_map(&tm_v, v, BH, S, dkv::kBKV);
  if (err) return err;
  err = prepare(dkv::dkv_kernel, dkv::kSmemBytes);
  if (err) return err;
  dkv::dkv_kernel<<<dim3(BH, (S + dkv::kBKV - 1) / dkv::kBKV), dkv::kThreads, dkv::kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
