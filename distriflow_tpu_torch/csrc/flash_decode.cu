// Single-token decode attention over a paged or a slab KV cache, bf16 or
// int8.
//
// Replaces four Pallas TPU kernels of the JAX package:
//   distriflow_tpu/ops/flash_decode.py::_paged_kernel        (paged pool + page table)
//   distriflow_tpu/ops/flash_decode.py::_decode_kernel       (contiguous [B, S, H*D] slab)
//   distriflow_tpu/ops/flash_decode.py::_paged_kernel_quant  (the same, int8 K/V + scales)
//   distriflow_tpu/ops/flash_decode.py::_decode_kernel_quant
// One kernel per cache type serves both layouts: a slab row is a page table
// that is the identity, with pages of 128 positions. Both therefore
// accumulate in the same order (one tile per page), so engine decode on the
// paged pool and solo decode on the slab produce the same bits for the same
// context.
//
// Numeric contract, bf16 (flash_decode.py:46-55, 176-215): q, K and V enter
// the score and PV products as bf16; scores, the running max m and the
// running sum l stay f32; p is rounded to bf16 for the PV product; the
// accumulator is f32. Positions at or past the row's valid length score
// -1e30.
//
// Numeric contract, int8 (flash_decode.py:245-271, 545-551): each (row,
// head) block quantizes its own q, qs = max(max|q| / 127, 1e-20) and
// q8 = clip(rint(q / qs), -127, 127), with IEEE division and rintf (round
// half to even; never built with fast math). The score is the int32 dot
// K8 . q8 (exact: __dp4a), converted to f32 (exact, |dot| < 2^24), times
// k_scale[pos, h], times qs / sqrt(D), in that order. l sums the unscaled
// p; the PV operand is bf16(p * v_scale[pos, h]) times V int8 (exact as
// f32); the output is acc * (1 / max(l, 1e-30)).
//
// Grid: one block of 128 threads per (row, head). The block reads its own
// page-table entries (no scalar prefetch on this card), walks the row's
// pages up to its valid length, and keeps the online softmax in registers
// and shared memory. Each position's head slice (D = 64 values: 128 bytes
// bf16, 64 bytes int8) is read by neighbouring lanes with one 16-byte load
// each (8 lanes bf16, 4 lanes int8).
//
// Bound: decode reads every live K and V position once, 2 * len * D * 2
// bytes per (row, head) in bf16 and 2 * len * (D + 4) in int8 (the two f32
// scales), and does 4 * len * D operations on it: about 1 per byte, far
// below the H100's ~295 FLOP/byte ridge, so the floor is bytes / 3.35
// TB/s. The design reads only live positions (tiles past valid_len are
// never touched, the last tile only up to valid_len) and never writes
// scores to device memory. One block per (row, head) gives B*H blocks,
// which underfills 132 SMs at small batch; splitting a row's pages across
// blocks (a second combine pass) is the next step.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTile = 256;

template <int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, H, D]
    const __nv_bfloat16* __restrict__ k,    // paged: [n_pages, T, H*D]; slab: [B, S, H*D]
    const __nv_bfloat16* __restrict__ v,
    const int32_t* __restrict__ table,      // [B, n_tiles] page ids, or nullptr (slab)
    const int32_t* __restrict__ lens,       // [B] valid positions per row
    __nv_bfloat16* __restrict__ out,        // [B, H, D]
    int H, int T, int n_tiles, int S, int n_pages, float scale) {
  constexpr int kVec = 8;                       // bf16 per 16-byte load
  constexpr int kLanes = D / kVec;              // lanes per position
  constexpr int kGroupsPerWarp = 32 / kLanes;
  constexpr int kGroups = (kThreads / 32) * kGroupsPerWarp;

  __shared__ float s_p[kMaxTile];
  __shared__ float s_red[kThreads / 32];
  __shared__ float s_acc[kGroups][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % kLanes;
  const int grp = warp * kGroupsPerWarp + lane / kLanes;
  const int64_t hd = static_cast<int64_t>(H) * D;

  float qv[kVec];
  dftt::load8(q + static_cast<int64_t>(bh) * D + sub * kVec, qv);
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  float m = dftt::kNegInf;
  float l = 0.f;

  const int len = lens[b];
  int tiles = len > 0 ? (len + T - 1) / T : 0;
  tiles = tiles < n_tiles ? tiles : n_tiles;

  for (int t = 0; t < tiles; ++t) {
    int64_t base;   // element offset of this tile's first position
    int live;       // positions of this tile below the valid length
    if (table != nullptr) {
      int pg = table[static_cast<int64_t>(b) * n_tiles + t];
      pg = pg < n_pages - 1 ? pg : n_pages - 1;   // sentinel entries clamp
      pg = pg > 0 ? pg : 0;
      base = static_cast<int64_t>(pg) * T * hd;
      live = len - t * T;
    } else {
      base = (static_cast<int64_t>(b) * S + static_cast<int64_t>(t) * T) * hd;
      live = min(len, S) - t * T;
    }
    live = live < T ? live : T;
    const int64_t head = base + static_cast<int64_t>(h) * D + sub * kVec;

    // scores: one position per lane group, reduced over its kLanes lanes
    for (int p0 = 0; p0 < T; p0 += kGroups) {
      const int p = p0 + grp;
      float part = 0.f;
      if (p < live) {
        float kv[kVec];
        dftt::load8(k + head + p * hd, kv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) part = fmaf(qv[i], kv[i], part);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (sub == 0 && p < T) s_p[p] = p < live ? part * scale : dftt::kNegInf;
    }
    __syncthreads();

    float mx = dftt::kNegInf;
    for (int p = tid; p < T; p += kThreads) mx = fmaxf(mx, s_p[p]);
    mx = dftt::warp_max(mx);
    if (lane == 0) s_red[warp] = mx;
    __syncthreads();
    float tile_max = s_red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) tile_max = fmaxf(tile_max, s_red[w]);
    __syncthreads();  // every thread has read s_red before it is reused

    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    for (int p = tid; p < T; p += kThreads) {
      const float pv = expf(s_p[p] - m_new);
      s_p[p] = pv;
      psum += pv;
    }
    psum = dftt::warp_sum(psum);
    if (lane == 0) s_red[warp] = psum;
    __syncthreads();
    float tile_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) tile_sum += s_red[w];
    l = l * corr + tile_sum;
    m = m_new;

#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] *= corr;
    for (int p = grp; p < live; p += kGroups) {
      // p enters the PV product as bf16, like the TPU kernel's pw.astype
      const float pw = __bfloat162float(__float2bfloat16(s_p[p]));
      float vv[kVec];
      dftt::load8(v + head + p * hd, vv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(pw, vv[i], acc[i]);
    }
    __syncthreads();  // s_p and s_red are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kVec; ++i) s_acc[grp][sub * kVec + i] = acc[i];
  __syncthreads();
  if (tid < D) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) total += s_acc[g][tid];
    const float inv = 1.f / fmaxf(l, 1e-30f);
    out[static_cast<int64_t>(bh) * D + tid] = __float2bfloat16(total * inv);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) decode_kernel_int8(
    const __nv_bfloat16* __restrict__ q,    // [B, H, D]
    const int8_t* __restrict__ k,           // paged: [n_pages, T, H*D]; slab: [B, S, H*D]
    const int8_t* __restrict__ v,
    const float* __restrict__ ks,           // paged: [n_pages, T, H]; slab: [B, S, H]
    const float* __restrict__ vs,
    const int32_t* __restrict__ table,      // [B, n_tiles] page ids, or nullptr (slab)
    const int32_t* __restrict__ lens,       // [B] valid positions per row
    __nv_bfloat16* __restrict__ out,        // [B, H, D]
    int H, int T, int n_tiles, int S, int n_pages, float scale) {
  constexpr int kVec = 16;                      // int8 per 16-byte load
  constexpr int kLanes = D / kVec;              // lanes per position
  constexpr int kGroupsPerWarp = 32 / kLanes;
  constexpr int kGroups = (kThreads / 32) * kGroupsPerWarp;
  static_assert(D <= kThreads, "one thread per q element");

  __shared__ float s_p[kMaxTile];
  __shared__ float s_red[kThreads / 32];
  __shared__ float s_acc[kGroups][D];
  __shared__ __align__(16) int8_t s_q8[D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % kLanes;
  const int grp = warp * kGroupsPerWarp + lane / kLanes;
  const int64_t hd = static_cast<int64_t>(H) * D;

  // q quantization: absmax over this (row, head)'s D values
  const float qv = tid < D ? __bfloat162float(q[static_cast<int64_t>(bh) * D + tid]) : 0.f;
  float amax = dftt::warp_max(fabsf(qv));
  if (lane == 0) s_red[warp] = amax;
  __syncthreads();
  amax = s_red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, s_red[w]);
  const float qs = fmaxf(amax / 127.f, 1e-20f);
  if (tid < D) s_q8[tid] = static_cast<int8_t>(fminf(fmaxf(rintf(qv / qs), -127.f), 127.f));
  __syncthreads();  // s_q8 written, s_red read before it is reused
  const int4 qw = *reinterpret_cast<const int4*>(s_q8 + sub * kVec);
  const float qscale = __fmul_rn(qs, scale);

  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  float m = dftt::kNegInf;
  float l = 0.f;

  const int len = lens[b];
  int tiles = len > 0 ? (len + T - 1) / T : 0;
  tiles = tiles < n_tiles ? tiles : n_tiles;

  for (int t = 0; t < tiles; ++t) {
    int64_t pos0;   // index of this tile's first position in the pool / slab
    int live;       // positions of this tile below the valid length
    if (table != nullptr) {
      int pg = table[static_cast<int64_t>(b) * n_tiles + t];
      pg = pg < n_pages - 1 ? pg : n_pages - 1;   // sentinel entries clamp
      pg = pg > 0 ? pg : 0;
      pos0 = static_cast<int64_t>(pg) * T;
      live = len - t * T;
    } else {
      pos0 = static_cast<int64_t>(b) * S + static_cast<int64_t>(t) * T;
      live = min(len, S) - t * T;
    }
    live = live < T ? live : T;
    const int64_t head = pos0 * hd + static_cast<int64_t>(h) * D + sub * kVec;
    const int64_t sc = pos0 * H + h;   // scale of the tile's first position

    // scores: one position per lane group, an exact int dot over its lanes
    for (int p0 = 0; p0 < T; p0 += kGroups) {
      const int p = p0 + grp;
      int part = 0;
      if (p < live) {
        const int4 kw = *reinterpret_cast<const int4*>(k + head + p * hd);
        part = __dp4a(kw.x, qw.x, part);
        part = __dp4a(kw.y, qw.y, part);
        part = __dp4a(kw.z, qw.z, part);
        part = __dp4a(kw.w, qw.w, part);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (sub == 0 && p < T)
        s_p[p] = p < live
            ? __fmul_rn(__fmul_rn(static_cast<float>(part), ks[sc + static_cast<int64_t>(p) * H]),
                        qscale)
            : dftt::kNegInf;
    }
    __syncthreads();

    float mx = dftt::kNegInf;
    for (int p = tid; p < T; p += kThreads) mx = fmaxf(mx, s_p[p]);
    mx = dftt::warp_max(mx);
    if (lane == 0) s_red[warp] = mx;
    __syncthreads();
    float tile_max = s_red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) tile_max = fmaxf(tile_max, s_red[w]);
    __syncthreads();  // every thread has read s_red before it is reused

    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    for (int p = tid; p < T; p += kThreads) {
      const float pv = expf(s_p[p] - m_new);
      s_p[p] = pv;
      psum += pv;
    }
    psum = dftt::warp_sum(psum);
    if (lane == 0) s_red[warp] = psum;
    __syncthreads();
    float tile_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) tile_sum += s_red[w];
    l = l * corr + tile_sum;   // the unscaled p
    m = m_new;

#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] *= corr;
    for (int p = grp; p < live; p += kGroups) {
      // p * v_scale enters the PV product as bf16 (the TPU kernel's pw.astype)
      const float pw = __bfloat162float(__float2bfloat16(
          __fmul_rn(s_p[p], vs[sc + static_cast<int64_t>(p) * H])));
      const int4 vw = *reinterpret_cast<const int4*>(v + head + p * hd);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&vw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(pw, static_cast<float>(vb[i]), acc[i]);
    }
    __syncthreads();  // s_p and s_red are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kVec; ++i) s_acc[grp][sub * kVec + i] = acc[i];
  __syncthreads();
  if (tid < D) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) total += s_acc[g][tid];
    const float inv = 1.f / fmaxf(l, 1e-30f);
    out[static_cast<int64_t>(bh) * D + tid] = __float2bfloat16(total * inv);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// table == nullptr selects the slab layout: row b's tile t covers slab
// positions [t*T, t*T + T) of a [B, S, H*D] cache. Built for D = 64 only,
// the head dim of the served configuration.
extern "C" int dftt_flash_decode_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* lens, void* out, int B, int H, int D, int T, int n_tiles,
    int S, int n_pages, float scale, void* stream) {
  if (T <= 0 || T > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* tp = static_cast<const int32_t*>(table);
  const auto* lp = static_cast<const int32_t*>(lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 64) {
    decode_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, tp, lp, op, H, T, n_tiles, S, n_pages, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The int8 kernel (layouts as above); k_scale/v_scale are f32 [n_pages, T, H]
// pools (paged) or [B, S, H] slabs. Every K/V pointer and the H*D row
// stride must be 16-byte aligned.
extern "C" int dftt_flash_decode_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* lens, void* out, int B,
    int H, int D, int T, int n_tiles, int S, int n_pages, float scale, void* stream) {
  if (T <= 0 || T > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const int8_t*>(k);
  const auto* vp = static_cast<const int8_t*>(v);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  const auto* tp = static_cast<const int32_t*>(table);
  const auto* lp = static_cast<const int32_t*>(lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 64) {
    decode_kernel_int8<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, ksp, vsp, tp, lp, op, H, T,
                                                      n_tiles, S, n_pages, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
