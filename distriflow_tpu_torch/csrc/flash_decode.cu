// Single-token decode attention over a paged or a slab KV cache, bf16, f32
// or int8, as split-KV kernels with a fixed-order combine.
//
// Replaces four Pallas TPU kernels of the JAX package:
//   distriflow_tpu/ops/flash_decode.py::_paged_kernel        (paged pool + page table)
//   distriflow_tpu/ops/flash_decode.py::_decode_kernel       (contiguous [B, S, H*D] slab)
//   distriflow_tpu/ops/flash_decode.py::_paged_kernel_quant  (the same, int8 K/V + scales)
//   distriflow_tpu/ops/flash_decode.py::_decode_kernel_quant
// The first two on bf16 and on f32 caches (the JAX LM CLI's --dtype
// float32). One kernel per cache type serves both layouts: a slab row is a
// page table that is the identity, with tiles of SLAB_TILE = 128 positions.
// A tile is a page (paged) or 128 slab positions, and splits cut a row at
// the same multiples of split_tiles tiles in both layouts, so engine decode
// on the paged pool (pages of 128) and solo decode on the slab produce the
// same bits for the same context. The split kernel is a template on the
// head dim and the cache type (Cache::kBf16, kF32, kInt8): bf16 is built at
// head dim 64, f32 at 64 and 32, int8 at 64; bf16 at head dim 32 is a kernel
// of its own, d32::decode_kernel (below). A position's head slice is read
// as 16-byte chunks: 8 bf16, 4 f32 or 16 int8 values a lane, so D / 8, D /
// 4 or D / 16 lanes a position (<32, kF32>: 8 lanes, 16 positions a pass);
// the partial rows are D + 2 floats, read and written one float at a time.
//
// Numeric contract, bf16 (ops/flash_decode.py, the plain version follows
// the same order): q, K and V enter the score and PV products as bf16;
// scores, the running max m and the running sum l stay f32; p is rounded to
// bf16 for the PV product; the accumulator is f32. Positions at or past the
// row's valid length score -1e30 (they are never read).
//
// Numeric contract, f32 (the JAX package's "bf16-compute contract for f32
// caches", flash_decode.py:46-56): the kernel reads f32 q, K and V and
// rounds each value to bf16 (round to nearest even, __float2bfloat16_rn:
// JAX's .astype(jnp.bfloat16), the plain version's .to(torch.bfloat16))
// before its product; everything after is the bf16 contract, and the
// output is written in f32, unrounded (q's dtype).
//
// Numeric contract, int8: each block quantizes its own q,
// qs = max(max|q| / 127, 1e-20) and q8 = clip(rint(q / qs), -127, 127),
// with IEEE division and rintf (round half to even; never built with fast
// math). The score is the int32 dot K8 . q8 (exact: __dp4a), converted to
// f32 (exact, |dot| < 2^24), times k_scale[pos, h], times qs / sqrt(D), in
// that order. l sums the unscaled p; the PV operand is bf16(p * v_scale[pos,
// h]) times V int8 (exact as f32).
//
// Split-KV. Grid (n_splits, H, B), 128 threads a block: block (s, h, b)
// runs the online-softmax recurrence above from a fresh (m = -1e30, l = 0,
// acc = 0) over tiles [s * split_tiles, (s + 1) * split_tiles) of row b,
// head h, stopping at the row's last live tile, min(ceil(len / T),
// n_tiles). n_tiles is the page table's width or ceil(S / 128), known on
// the host, so no length is read there; a block whose split starts at or
// past the last live tile exits without writing. split_tiles is an
// argument, from ops/flash_decode.py::split_tiles(T): SPLIT_TILES (2) at
// T = 128, so pages of 128 and slab tiles split at the same positions.
// Each live block writes f32 (m, l, acc[D]) once into the scratch [B, H,
// n_splits, D + 2] (torch.empty, never zeroed: only live splits are
// written, and only live splits are read; 264 bytes a split, 1.1 MB at
// B8 H8 and 64 splits, 16k context). The combine kernel, one block per
// (row, head), reads the live splits in ascending order: M = max m_i,
// acc = sum acc_i * exp(m_i - M), l = sum l_i * exp(m_i - M) (each product
// and sum rounded on its own, as the plain version's torch ops are), out =
// acc * (1 / max(l, 1e-30)), rounded to bf16 for a bf16 or int8 cache and
// kept in f32 for an f32 one; a row of length 0 gives 0. No atomics: every
// launch gives the same bits. The combine is a programmatic dependent
// launch (griddepcontrol), so its launch overlaps the split grid's tail.
//
// Inside a block. A tile's K and V head slices (D values: 128 bytes bf16,
// 256 f32, 64 int8, at a stride of H*D) and, for int8, the page's [T, H] f32
// scales (contiguous, copied whole with 4-byte copies, coalesced) are
// copied by all 128 threads with cp.async into a ring of min(split_tiles,
// 3) shared-memory stages; each thread's copies arrive on the stage's
// mbarrier (cp.async.mbarrier.arrive.noinc, count 128), which the block
// waits on. Every stage is filled before the first tile is used, so a
// split of up to three tiles has all its copies in flight at once and the
// next tiles land while a tile's softmax and PV run; a longer split
// refills a stage after a block barrier. A lane group (D / 8 lanes bf16,
// D / 4 f32, D / 16 int8; 16 bytes each) owns positions grp, grp + 128 /
// lanes, ... of every tile: it reduces its scores with shuffles, keeps them
// in registers and applies p to its own V rows, so the only block barrier
// of a tile is the tile max; l is summed per lane group and added across
// groups at the end of the split, with acc.
//
// Shared memory at f32. A stage is 2 * T * D * 4 bytes: 32 KB at T 128 and
// D 32, 64 KB at D 64, 128 KB for one page of 256 at D 64. The ring holds
// min(split_tiles, 3) stages (1 at T 256, 2 at T 128, 3 at T 64: 96 KB at D
// 64), under the 200 KB a block asks for (kSmemLimit, opted in for every
// instantiation; the static part adds at most 8.4 KB, within the card's 227
// KB). The f32 gate takes pages of 128 to 256 only, so a block holds 64 to
// 128 KB at D 64 (one or two blocks an SM) and 32 to 64 KB at D 32 (three
// to six).
//
// No wgmma: a decode query is one row per head (M = 1) and the flagship has
// no grouped heads, so a tensor-core tile would be 1/64 full. These are
// bandwidth kernels: every live K and V position is read once, 2 * len * D
// * 2 bytes per (row, head) in bf16, twice that in f32 and 2 * len * (D +
// 4) in int8, for 4 * len * D operations, far below the H100's ~295
// FLOP/byte ridge, so their yardstick is bytes / 3.35 TB/s. Per block
// (ptxas, -Xptxas -v, as chip_smoke.py prints it; no spills): the split
// kernel 72 registers and 4.2 KB of static shared memory (bf16), 72 and
// 8.4 KB (int8); the combine 40 and 16.5 KB. The dynamic ring is n_stages
// * (2 * T * D * itemsize + 2 * 16-aligned(T * H * 4) for int8): 32 KB bf16
// and 24 KB int8 a stage at T 128, H 8, two stages at SPLIT_TILES 2.
//
// Head dim 32 on a bf16 cache: d32::decode_kernel, one launch and no
// scratch. The same splits, the same recurrence within a split (the tile
// max, p rounded to bf16 against it) and the same combine as above, so the
// same plain versions hold it; what changes is where each step runs. Grid
// (C, H, B) in clusters of C CTAs (cudaLaunchAttributeClusterDimension): the
// cluster of (row, head). C is a power of two from 1 to 16, picked on the
// host from n_splits (ops/flash_decode.py::d32_cluster: the least power of
// two at or above n_splits, at most 16), so no length is read there. CTA
// rank r takes the row's live splits r, r + C, r + 2C, ... (it reads lens
// on the device); each of its 4 warps runs one of them at a time, alone:
// a position is 2 lanes of 16 dims (32 bytes), 16 positions a pass; the
// scores of a tile's passes stay in registers, reduced over the 2 lanes by
// a shuffle, the tile max is a shuffle max over the warp's 16 position
// groups (no block barrier), then the exponentials and P.V; l and acc are
// summed per position group and over the groups by shuffles at the end of
// the split, and the split's f32 (m, l, acc[32]) goes into slot j of the
// CTA's shared memory (split r + C j). The K and V head slices (64 bytes at
// a stride of H * 64) stream by cp.async through a ring of 4 copy groups
// a warp, each 4 passes of one tile's K or of its V (4 KB; 16 KB a warp, 64
// KB a CTA), one commit group each: the warp waits once a
// group and runs its passes side by side. Each lane reads back only the
// chunks it copied, so cp.async.wait_group orders each copy before its
// read without a barrier. A warp's first page is read beside the row's
// length, not after it. After a cluster barrier, rank 0's threads read
// the live splits' partials through distributed shared memory (mapa +
// ld.shared::cluster, 16 bytes a load) into its ring, free by then, take
// M, each split's weight and its products side by side, and warp 0 adds
// them in ascending order (each product and sum rounded on its own); lane
// d writes output element d. A
// second cluster barrier keeps every CTA resident while rank 0 reads. CTAs
// past the live splits join both barriers. A split's partial depends on its
// positions alone, not on C, the rank, the warp or the table width, so
// every C gives the same bits, and paged (pages of 128) equals slab. The
// slots take ceil(n_splits / C) x 144 bytes: the kernel takes up to 967
// slots a CTA (15,472 splits a row at C 16), under the 200 KB a CTA may
// ask for.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 256;
constexpr int kMaxStages = 3;
constexpr int kSmemLimit = 200 * 1024;  // dynamic shared memory a block may ask for
constexpr int kCombineChunk = 64;       // splits the combine stages in shared memory at once

using dftt::hopper::mbar_init;
using dftt::hopper::mbar_wait;
using dftt::hopper::smem_addr;

// The cache's element type: the template parameter of the split kernel.
enum class Cache { kBf16, kF32, kInt8 };

struct DecodeArgs {
  const void* q;            // [B, H, D]: bf16 (bf16 and int8 caches) or f32 (f32 cache)
  const void* k;            // paged: [n_pages, T, H*D]; slab: [B, S, H*D]; bf16, f32 or int8
  const void* v;
  const float* ks;          // int8 only: paged [n_pages, T, H]; slab [B, S, H]
  const float* vs;
  const int32_t* table;     // [B, n_tiles] page ids, or nullptr (slab)
  const int32_t* lens;      // [B] valid positions per row, or nullptr: len_all for every row
  float* partial;           // [B, H, n_splits, D + 2]: (m, l, acc)
  void* out;                // [B, H, D] in q's dtype
  int H, T, n_tiles, S, n_pages, split_tiles, n_splits, len_all, n_stages;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Arrives on `bar` once every cp.async this thread issued before has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__host__ __device__ __forceinline__ int round16(int bytes) { return (bytes + 15) & ~15; }

__device__ __forceinline__ int row_len(const DecodeArgs& a, int b) {
  return a.lens != nullptr ? a.lens[b] : a.len_all;
}

// Live tiles of a row: min(ceil(len / T), n_tiles), 0 for len <= 0.
__device__ __forceinline__ int live_tiles(const DecodeArgs& a, int len) {
  const int tiles = len > 0 ? (len + a.T - 1) / a.T : 0;
  return tiles < a.n_tiles ? tiles : a.n_tiles;
}

template <int D, Cache C>
struct Layout {
  static constexpr bool kInt8 = C == Cache::kInt8;
  static constexpr int kItem = kInt8 ? 1 : C == Cache::kBf16 ? 2 : 4;
  static constexpr int kRowBytes = D * kItem;         // one position's head slice
  static constexpr int kVec = 16 / kItem;             // values per 16-byte chunk
  static constexpr int kLanes = D / kVec;             // lanes (chunks) per position
  static constexpr int kGroups = kThreads / kLanes;   // positions a pass
  static constexpr int kPerGroup = kMaxTile / kGroups;
  static_assert(kRowBytes % 16 == 0 && 32 % kLanes == 0, "a position is whole 16-byte chunks");
  __host__ __device__ static int stage_bytes(int T, int H) {
    return 2 * T * kRowBytes + (kInt8 ? 2 * round16(T * H * 4) : 0);
  }
};

// Issues the copies of tile j of row b, head h (its `live` positions) into
// `stage` and arrives on `bar`.
template <int D, Cache C>
__device__ __forceinline__ void load_tile(const DecodeArgs& a, unsigned char* stage, uint64_t* bar,
                                          int b, int h, int j, int live, int tid) {
  using L = Layout<D, C>;
  int64_t pos0;  // index of the tile's first position in the pool or slab
  if (a.table != nullptr) {
    int pg = a.table[static_cast<int64_t>(b) * a.n_tiles + j];
    pg = pg < a.n_pages - 1 ? pg : a.n_pages - 1;  // sentinel entries clamp
    pg = pg > 0 ? pg : 0;
    pos0 = static_cast<int64_t>(pg) * a.T;
  } else {
    pos0 = static_cast<int64_t>(b) * a.S + static_cast<int64_t>(j) * a.T;
  }
  const int64_t row_stride = static_cast<int64_t>(a.H) * L::kRowBytes;
  const int64_t head = pos0 * row_stride + static_cast<int64_t>(h) * L::kRowBytes;
  const auto* kg = static_cast<const unsigned char*>(a.k) + head;
  const auto* vg = static_cast<const unsigned char*>(a.v) + head;
  unsigned char* sk = stage;
  unsigned char* sv = stage + a.T * L::kRowBytes;
  for (int c = tid; c < live * L::kLanes; c += kThreads) {
    const int p = c / L::kLanes;
    const int off = (c % L::kLanes) * 16;
    cp_async16(sk + p * L::kRowBytes + off, kg + p * row_stride + off);
    cp_async16(sv + p * L::kRowBytes + off, vg + p * row_stride + off);
  }
  if constexpr (L::kInt8) {
    float* sks = reinterpret_cast<float*>(sv + a.T * L::kRowBytes);
    float* svs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sks) +
                                          round16(a.T * a.H * 4));
    const float* ksg = a.ks + pos0 * a.H;
    const float* vsg = a.vs + pos0 * a.H;
    for (int c = tid; c < live * a.H; c += kThreads) {
      cp_async4(sks + c, ksg + c);
      cp_async4(svs + c, vsg + c);
    }
  }
  cp_async_arrive(bar);
}

// One 16-byte chunk of a bf16 or f32 head slice as f32 values, each f32
// value rounded to bf16 first (round to nearest even: the TPU kernel's
// .astype(jnp.bfloat16) of an f32 tile).
template <Cache C>
__device__ __forceinline__ void load_chunk(const void* src, float* dst) {
  if constexpr (C == Cache::kF32) {
    const float4 raw = *reinterpret_cast<const float4*>(src);
    dst[0] = __bfloat162float(__float2bfloat16_rn(raw.x));
    dst[1] = __bfloat162float(__float2bfloat16_rn(raw.y));
    dst[2] = __bfloat162float(__float2bfloat16_rn(raw.z));
    dst[3] = __bfloat162float(__float2bfloat16_rn(raw.w));
  } else {
    dftt::load8(static_cast<const __nv_bfloat16*>(src), dst);
  }
}

template <int D, Cache C>
__global__ void __launch_bounds__(kThreads) split_kernel(const DecodeArgs a) {
  using L = Layout<D, C>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int kVec = L::kVec;
  constexpr int kLanes = L::kLanes;
  constexpr int kGroups = L::kGroups;

  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ uint64_t full[kMaxStages];
  __shared__ float s_red[2][kWarps];
  __shared__ float s_acc[kGroups][D];
  __shared__ float s_l[kGroups];
  __shared__ __align__(16) int8_t s_q8[D];

  // the combine grid may start once every block here has started; it
  // waits for this grid's end before it reads a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % kLanes;
  const int grp = tid / kLanes;

  const int len = row_len(a, b);
  const int tiles = live_tiles(a, len);
  const int t0 = split * a.split_tiles;
  if (t0 >= tiles) return;  // a dead split
  const int n_local = min(a.split_tiles, tiles - t0);
  const int ns = a.n_stages;
  const int stage_bytes = L::stage_bytes(a.T, a.H);
  // positions of the row that may be read: the valid length, cut to the slab
  const int valid = a.table != nullptr ? len : min(len, a.S);

  if (tid == 0) {
    for (int i = 0; i < ns; ++i) mbar_init(&full[i], kThreads);
    dftt::hopper::fence_barrier_init();
  }
  __syncthreads();
  // every stage's tile is in flight while q is prepared
  const int ahead = min(n_local, ns);
  for (int i = 0; i < ahead; ++i)
    load_tile<D, C>(a, ring + i * stage_bytes, &full[i], b, h, t0 + i,
                    min(valid - (t0 + i) * a.T, a.T), tid);

  // q: this lane's chunk as bf16 values, or the int8 chunk and its scale
  float qv[kInt8 ? 1 : kVec];
  int4 qw = make_int4(0, 0, 0, 0);
  float qscale = 0.f;
  if constexpr (kInt8) {
    const auto* qg = static_cast<const __nv_bfloat16*>(a.q);
    const float x = tid < D ? __bfloat162float(qg[bh * D + tid]) : 0.f;
    float amax = dftt::warp_max(fabsf(x));
    if (lane == 0) s_red[1][warp] = amax;
    // fmaxf drops a NaN, where the plain version's (and JAX's) absmax
    // keeps it: a NaN in q makes the scale NaN, and so every score
    const bool q_nan = __syncthreads_or(x != x);
    amax = s_red[1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, s_red[1][w]);
    const float qs = fmaxf(amax / 127.f, 1e-20f);
    if (tid < D) s_q8[tid] = static_cast<int8_t>(fminf(fmaxf(rintf(x / qs), -127.f), 127.f));
    __syncthreads();  // s_q8 written; s_red[1] read before tile 1 rewrites it
    qw = *reinterpret_cast<const int4*>(s_q8 + sub * kVec);
    qscale = q_nan ? __int_as_float(0x7fffffff) : __fmul_rn(qs, a.scale);
  } else {
    load_chunk<C>(static_cast<const unsigned char*>(a.q) + (bh * D + sub * kVec) * L::kItem, qv);
  }

  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  float m = dftt::kNegInf;
  float l = 0.f;  // this lane group's share of the sum

  for (int i = 0; i < n_local; ++i) {
    const int live = min(valid - (t0 + i) * a.T, a.T);
    const int st = i % ns;
    const unsigned char* sk = ring + st * stage_bytes;
    const unsigned char* sv = sk + a.T * L::kRowBytes;
    const float* sks = reinterpret_cast<const float*>(sv + a.T * L::kRowBytes);
    const float* svs = reinterpret_cast<const float*>(reinterpret_cast<const unsigned char*>(sks) +
                                                      round16(a.T * a.H * 4));
    mbar_wait(&full[st], (i / ns) & 1);

    // scores of this group's positions, reduced over its kLanes lanes (every
    // lane ends with the same sum)
    float sc[L::kPerGroup];
    float mx = dftt::kNegInf;
#pragma unroll
    for (int r = 0; r < L::kPerGroup; ++r) {
      if (r * kGroups >= live) break;  // uniform across the block
      const int p = grp + r * kGroups;
      float s;
      if constexpr (kInt8) {
        int part = 0;
        if (p < live) {
          const int4 kw = *reinterpret_cast<const int4*>(sk + p * L::kRowBytes + sub * 16);
          part = __dp4a(kw.x, qw.x, part);
          part = __dp4a(kw.y, qw.y, part);
          part = __dp4a(kw.z, qw.z, part);
          part = __dp4a(kw.w, qw.w, part);
        }
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s = p < live ? __fmul_rn(__fmul_rn(static_cast<float>(part), sks[p * a.H + h]), qscale)
                     : dftt::kNegInf;
      } else {
        float part = 0.f;
        if (p < live) {
          float kv[kVec];
          load_chunk<C>(sk + p * L::kRowBytes + sub * 16, kv);
#pragma unroll
          for (int e = 0; e < kVec; ++e) part = fmaf(qv[e], kv[e], part);
        }
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s = p < live ? part * a.scale : dftt::kNegInf;
      }
      sc[r] = s;
      mx = fmaxf(mx, s);
    }
    mx = dftt::warp_max(mx);
    if (lane == 0) s_red[i & 1][warp] = mx;
    __syncthreads();  // the tile's one block barrier: the tile max
    float tile_max = s_red[i & 1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tile_max = fmaxf(tile_max, s_red[i & 1][w]);

    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= corr;
#pragma unroll
    for (int r = 0; r < L::kPerGroup; ++r) {
      if (r * kGroups >= live) break;
      const int p = grp + r * kGroups;
      if (p < live) {
        const float pv = expf(sc[r] - m_new);
        l += pv;
        if constexpr (kInt8) {
          // p * v_scale enters the PV product as bf16 (the TPU kernel's pw.astype)
          const float pw = __bfloat162float(__float2bfloat16(__fmul_rn(pv, svs[p * a.H + h])));
          const int4 vw = *reinterpret_cast<const int4*>(sv + p * L::kRowBytes + sub * 16);
          const int8_t* vb = reinterpret_cast<const int8_t*>(&vw);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] = fmaf(pw, static_cast<float>(vb[e]), acc[e]);
        } else {
          // p enters the PV product as bf16, like the TPU kernel's pw.astype
          const float pw = __bfloat162float(__float2bfloat16(pv));
          float vv[kVec];
          load_chunk<C>(sv + p * L::kRowBytes + sub * 16, vv);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] = fmaf(pw, vv[e], acc[e]);
        }
      }
    }
    m = m_new;
    if (i + ns < n_local) {  // a split longer than the ring: refill this stage
      __syncthreads();       // every thread is done with tile i
      load_tile<D, C>(a, ring + st * stage_bytes, &full[st], b, h, t0 + i + ns,
                      min(valid - (t0 + i + ns) * a.T, a.T), tid);
    }
  }

#pragma unroll
  for (int e = 0; e < kVec; ++e) s_acc[grp][sub * kVec + e] = acc[e];
  if (sub == 0) s_l[grp] = l;
  __syncthreads();
  if (tid < D) {
    float total = 0.f;
    float lsum = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      total += s_acc[g][tid];
      lsum += s_l[g];
    }
    float* row = a.partial + (bh * a.n_splits + split) * (D + 2);
    row[2 + tid] = total;
    if (tid == 0) {
      row[0] = m;
      row[1] = lsum;
    }
  }
}

__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }
__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }

// One block per (row, head): the live splits' partials in ascending order,
// the output in Out (q's dtype).
template <int D, typename Out>
__global__ void __launch_bounds__(kThreads) combine_kernel(const DecodeArgs a) {
  __shared__ float s_part[kCombineChunk * (D + 2)];
  __shared__ float s_red[kWarps];
  const int64_t bh = blockIdx.x;
  const int b = static_cast<int>(bh / a.H);
  const int tid = threadIdx.x;
  const int n_live = (live_tiles(a, row_len(a, b)) + a.split_tiles - 1) / a.split_tiles;
  const float* part = a.partial + bh * a.n_splits * (D + 2);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split grid is done

  float mx = dftt::kNegInf;
  for (int i = tid; i < n_live; i += kThreads) mx = fmaxf(mx, part[i * (D + 2)]);
  mx = dftt::warp_max(mx);
  if ((tid & 31) == 0) s_red[tid >> 5] = mx;
  __syncthreads();
  float top = s_red[0];  // M
#pragma unroll
  for (int w = 1; w < kWarps; ++w) top = fmaxf(top, s_red[w]);

  float acc = 0.f;
  float l = 0.f;
  for (int c0 = 0; c0 < n_live; c0 += kCombineChunk) {
    const int n = min(kCombineChunk, n_live - c0);
    __syncthreads();  // the previous chunk has been read
    for (int e = tid; e < n * (D + 2); e += kThreads) s_part[e] = part[c0 * (D + 2) + e];
    __syncthreads();
    if (tid < D) {
      for (int i = 0; i < n; ++i) {
        const float* r = s_part + i * (D + 2);
        const float w = expf(r[0] - top);
        acc = __fadd_rn(acc, __fmul_rn(r[2 + tid], w));
        l = __fadd_rn(l, __fmul_rn(r[1], w));
      }
    }
  }
  // a NaN l stays NaN (fmaxf would drop it), as in the plain version
  if (tid < D) store_out(static_cast<Out*>(a.out) + bh * D + tid, acc * (1.f / (l < 1e-30f ? 1e-30f : l)));
}

template <int D, Cache C>
int launch(DecodeArgs a, int B, cudaStream_t st) {
  using L = Layout<D, C>;
  using Out = typename std::conditional<C == Cache::kF32, float, __nv_bfloat16>::type;
  if (a.T <= 0 || a.T > kMaxTile || a.split_tiles <= 0 || a.n_tiles <= 0 ||
      a.n_splits != (a.n_tiles + a.split_tiles - 1) / a.split_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int stage = L::stage_bytes(a.T, a.H);
  int ns = a.split_tiles < kMaxStages ? a.split_tiles : kMaxStages;
  while (ns > 2 && ns * stage > kSmemLimit) --ns;
  if (ns * stage > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  a.n_stages = ns;
  const int smem = ns * stage;
  static bool opted_in = false;  // past 48 KB of shared memory (static + dynamic)
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<D, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  split_kernel<D, C><<<dim3(a.n_splits, a.H, B), kThreads, smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a programmatic dependent launch: the combine's launch overlaps the
  // split grid's tail (griddepcontrol above)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.H);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, combine_kernel<D, Out>, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Head dim 32 on a bf16 cache: one cluster launch a call (see the head of
// this file). A position's head slice is 64 bytes, so a split is little
// data (32 KB of K and V at 256 positions) and the two-kernel layout above
// spent most of its time around it: a partial in device memory, a second
// launch waiting for the whole split grid, a block barrier a tile.
namespace d32 {

constexpr int D = 32;
constexpr int kWarps = 4;                      // warps a CTA; a warp runs one split at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 2;                      // lanes a position
constexpr int kDims = D / kLanes;              // head dims a lane: 16 (two 16-byte chunks)
constexpr int kChunks = kDims / 8;             // 16-byte chunks a lane and position
constexpr int kPass = 32 / kLanes;             // positions a pass of the warp
constexpr int kItemBytes = kPass * D * 2;      // one pass's K (or V) head slices: 1 KB
constexpr int kGroup = 4;                      // passes a copy group: one wait, then side by side
constexpr int kGroupBytes = kGroup * kItemBytes;
constexpr int kStages = 4;                     // copy groups in a warp's ring (16 KB)
constexpr int kMaxPasses = (kMaxTile + kPass - 1) / kPass;
constexpr int kMaxCluster = 16;                // CTAs a cluster (16: non-portable)
constexpr int kSlotFloats = 36;                // a split's (m, l, acc[32]), 16-byte aligned
constexpr int kRingBytes = kWarps * kStages * kGroupBytes;
constexpr int kStaged = kRingBytes / (kSlotFloats * 4);  // partials staged at once
static_assert(kDims % 8 == 0 && 32 % kLanes == 0, "a lane holds whole 16-byte chunks");
static_assert(kMaxPasses % kGroup == 0, "a tile's passes are whole copy groups");

__host__ __device__ __forceinline__ int n_slots(int n_splits, int cluster) {
  return (n_splits + cluster - 1) / cluster;
}

__host__ __device__ __forceinline__ int smem_bytes(int n_splits, int cluster) {
  return n_slots(n_splits, cluster) * kSlotFloats * 4 + kRingBytes;
}

// The pool or slab index of tile t's first position in row b; sentinel
// table entries clamp to the last page.
__device__ __forceinline__ int64_t first_position(const DecodeArgs& a, int b, int t) {
  if (a.table == nullptr) return static_cast<int64_t>(b) * a.S + static_cast<int64_t>(t) * a.T;
  int pg = a.table[static_cast<int64_t>(b) * a.n_tiles + t];
  pg = pg < a.n_pages - 1 ? pg : a.n_pages - 1;
  pg = pg > 0 ? pg : 0;
  return static_cast<int64_t>(pg) * a.T;
}

// The copy groups of one split, in the order the warp uses them: for each
// of its tiles, the K head slices of the tile's passes, kGroup passes a
// group, then their V slices. Each lane copies the 16-byte chunks it reads
// back itself (the same offset in the item), so cp.async.wait_group alone
// orders a copy before its read.
struct Groups {
  const DecodeArgs& a;
  int b, h, t0, n_local, valid;
  int tile = 0, kind = 0, g = 0, ng = 0;  // the next group to copy
  int64_t base = 0, next_base = 0;        // the tile's first position (pool or slab)

  // first: the split's first tile's base, read ahead by the caller
  __device__ __forceinline__ Groups(const DecodeArgs& a_, int b_, int h_, int t0_, int n_local_,
                                    int valid_, int64_t first)
      : a(a_), b(b_), h(h_), t0(t0_), n_local(n_local_), valid(valid_), next_base(first) {
    start_tile();
  }

  __device__ __forceinline__ int live(int i) const { return min(valid - (t0 + i) * a.T, a.T); }

  __device__ __forceinline__ int64_t tile_base(int i) const {
    return i < n_local ? first_position(a, b, t0 + i) : 0;
  }

  __device__ __forceinline__ void start_tile() {
    base = next_base;
    next_base = tile_base(tile + 1);  // read ahead: its latency hides under this tile's copies
    ng = tile < n_local ? (live(tile) + kGroup * kPass - 1) / (kGroup * kPass) : 0;
  }

  // Copies the next group into ring stage `stage % kStages` and commits it
  // (an empty group past the split's end).
  __device__ __forceinline__ void issue(unsigned char* ring, int stage, int lane) {
    if (tile < n_local) {
      const int64_t row = static_cast<int64_t>(a.H) * D * 2;
      const auto* src = static_cast<const unsigned char*>(kind ? a.v : a.k) + base * row +
                        h * D * 2 + (lane % kLanes) * kDims * 2;
      unsigned char* dst = ring + (stage % kStages) * kGroupBytes + lane * kDims * 2;
      const int live_t = live(tile);
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) {
        const int p = (g * kGroup + rr) * kPass + lane / kLanes;
        if (p < live_t) {
#pragma unroll
          for (int c = 0; c < kChunks; ++c)
            cp_async16(dst + rr * kItemBytes + 16 * c, src + p * row + 16 * c);
        }
      }
      if (++g == ng) {
        g = 0;
        kind ^= 1;
        if (kind == 0) {
          ++tile;
          start_tile();
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
};

// Waits for copy group `stage` (kStages - 2 later ones may still be in
// flight), then refills the stage its predecessor used; returns this
// lane's bytes of the group.
__device__ __forceinline__ const unsigned char* next_group(Groups& groups, unsigned char* ring,
                                                           int stage, int lane) {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
  groups.issue(ring, stage + kStages - 1, lane);
  return ring + (stage % kStages) * kGroupBytes + lane * kDims * 2;
}

// Sum (or max) over the warp's position groups: lanes kLanes apart.
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// One split, by one warp alone: the online-softmax recurrence over its
// tiles from a fresh (m, l, acc), the bf16 contract and the tile max of
// split_kernel, into `slot`. The partial depends on the split's positions
// alone, so every cluster size, rank and warp gives the same bits. The
// warp's copy groups are numbered on across its splits: this split's first
// is `stage`; returns the next split's first. `first`: the split's first
// tile's first_position.
__device__ __forceinline__ int run_split(const DecodeArgs& a, unsigned char* ring, float* slot,
                                         const float* qv, int b, int h, int split, int tiles,
                                         int valid, int lane, int stage, int64_t first) {
  const int t0 = split * a.split_tiles;
  const int n_local = min(a.split_tiles, tiles - t0);
  const int grp = lane / kLanes;
  Groups groups(a, b, h, t0, n_local, valid, first);
  for (int i = 0; i < kStages - 1; ++i) groups.issue(ring, stage + i, lane);

  float acc[kDims];
#pragma unroll
  for (int e = 0; e < kDims; ++e) acc[e] = 0.f;
  float m = dftt::kNegInf;
  float l = 0.f;  // this position group's share of the sum
  for (int i = 0; i < n_local; ++i) {
    const int live = groups.live(i);
    const int ng = (live + kGroup * kPass - 1) / (kGroup * kPass);
    // scores of this group's positions, reduced over its kLanes lanes
    float sc[kMaxPasses];
    float mx = dftt::kNegInf;
#pragma unroll
    for (int gk = 0; gk < kMaxPasses / kGroup; ++gk) {
      if (gk >= ng) break;
      const unsigned char* src = next_group(groups, ring, stage++, lane);
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) {
        const int r = gk * kGroup + rr;
        float kv[kDims];
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          dftt::load8(reinterpret_cast<const __nv_bfloat16*>(src + rr * kItemBytes + 16 * c), kv + 8 * c);
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kDims; ++e) part = fmaf(qv[e], kv[e], part);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        // positions past the tile's live ones (never copied) score -1e30
        sc[r] = r * kPass + grp < live ? part * a.scale : dftt::kNegInf;
        mx = fmaxf(mx, sc[r]);
      }
    }
    const float m_new = fmaxf(m, group_max(mx));
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[e] *= corr;
#pragma unroll
    for (int gk = 0; gk < kMaxPasses / kGroup; ++gk) {
      if (gk >= ng) break;
      const unsigned char* src = next_group(groups, ring, stage++, lane);
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) {
        const int r = gk * kGroup + rr;
        if (r * kPass + grp < live) {
          float vv[kDims];
#pragma unroll
          for (int c = 0; c < kChunks; ++c)
            dftt::load8(reinterpret_cast<const __nv_bfloat16*>(src + rr * kItemBytes + 16 * c), vv + 8 * c);
          const float pv = expf(sc[r] - m_new);
          l += pv;
          // p enters the PV product as bf16, like the TPU kernel's pw.astype
          const float pw = __bfloat162float(__float2bfloat16(pv));
#pragma unroll
          for (int e = 0; e < kDims; ++e) acc[e] = fmaf(pw, vv[e], acc[e]);
        }
      }
    }
    m = m_new;
  }
  l = group_sum(l);
#pragma unroll
  for (int e = 0; e < kDims; ++e) acc[e] = group_sum(acc[e]);
  if (grp == 0) {
#pragma unroll
    for (int e = 0; e < kDims; ++e) slot[2 + (lane % kLanes) * kDims + e] = acc[e];
    if (lane == 0) {
      slot[0] = m;
      slot[1] = l;
    }
  }
  return stage + kStages - 1;  // past the empty groups issued beyond the split's end
}

// The largest x over the CTA's threads (every thread calls it once).
__device__ __forceinline__ float block_max(float x) {
  __shared__ float s_red[kWarps];
  x = dftt::warp_max(x);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = fmaxf(x, s_red[w]);
  return x;
}

// Rank 0, every thread: the live splits' partials (split i in rank i % C,
// slot i / C) read through distributed shared memory, 16 bytes a load and
// kStaged slots at a time, into `stage` (the ring, free now), and combined
// as combine_kernel does:
// M = max m_i, each split's weight exp(m_i - M) and its products with l_i
// and acc_i taken side by side, then warp 0 adds them in ascending order
// (each product and sum rounded on its own); lane d writes output element d.
__device__ __forceinline__ void combine(const DecodeArgs& a, const float* slots, float* stage,
                                        int cluster, int n_live, int64_t bh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int shift = __ffs(cluster) - 1;  // the cluster is a power of two
  auto at = [&](int i, int off) {  // floats off .. off + 3 of split i's slot
    return dftt::hopper::ld_cluster_f32x4(slots + (i >> shift) * kSlotFloats + off, i & (cluster - 1));
  };
  constexpr int kQuads = kSlotFloats / 4;
  const bool one_chunk = n_live <= kStaged;
  float top = dftt::kNegInf;  // M
  if (!one_chunk) {
    for (int i = tid; i < n_live; i += kThreads) top = fmaxf(top, at(i, 0).x);
    top = block_max(top);
  }
  float acc = 0.f;
  float l = 0.f;
  for (int c0 = 0; c0 < n_live; c0 += kStaged) {
    const int n = min(kStaged, n_live - c0);
    __syncthreads();  // the previous chunk has been read
#pragma unroll 4
    for (int e = tid; e < n * kQuads; e += kThreads)
      reinterpret_cast<float4*>(stage)[e] = at(c0 + e / kQuads, 4 * (e % kQuads));
    __syncthreads();
    if (one_chunk) {
      for (int i = tid; i < n; i += kThreads) top = fmaxf(top, stage[i * kSlotFloats]);
      top = block_max(top);
    }
    for (int i = tid; i < n; i += kThreads)
      stage[i * kSlotFloats] = expf(stage[i * kSlotFloats] - top);  // the weight in m's place
    __syncthreads();
    for (int e = tid; e < n * kSlotFloats; e += kThreads) {
      const int off = e % kSlotFloats;
      if (off != 0 && off < D + 2) stage[e] = __fmul_rn(stage[e], stage[e - off]);
    }
    __syncthreads();
    if (tid < 32) {
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        acc = __fadd_rn(acc, stage[i * kSlotFloats + 2 + lane]);
        l = __fadd_rn(l, stage[i * kSlotFloats + 1]);
      }
    }
  }
  // a NaN l stays NaN (fmaxf would drop it), as in the plain version
  if (tid < 32)
    static_cast<__nv_bfloat16*>(a.out)[bh * D + lane] =
        __float2bfloat16(acc * (1.f / (l < 1e-30f ? 1e-30f : l)));
}

// Grid (C, H, B) in clusters of C: the cluster of (row b, head h). CTA
// rank r runs splits r, r + C, r + 2C, ... of the row's live ones, warp w
// of them the w-th, (w + kWarps)-th, ..., each into slot j (split r + C j)
// of its shared memory; after a cluster barrier rank 0 combines, and a
// second barrier keeps every CTA (dead ones too) resident while it reads.
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cluster = gridDim.x;
  const int rank = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* slots = reinterpret_cast<float*>(smem);
  unsigned char* rings = smem + n_slots(a.n_splits, cluster) * kSlotFloats * 4;
  unsigned char* ring = rings + warp * kStages * kGroupBytes;

  // this warp's first split's first page, read beside the row's length
  // (the table's width bounds it; whether the split is live, the length
  // decides)
  const int t_first = (rank + cluster * warp) * a.split_tiles;
  const int64_t first = t_first < a.n_tiles ? first_position(a, b, t_first) : 0;
  const int len = row_len(a, b);
  const int tiles = live_tiles(a, len);
  const int n_live = (tiles + a.split_tiles - 1) / a.split_tiles;
  // positions of the row that may be read: the valid length, cut to the slab
  const int valid = a.table != nullptr ? len : min(len, a.S);

  float qv[kDims];
  const auto* q = static_cast<const __nv_bfloat16*>(a.q) + bh * D + (lane % kLanes) * kDims;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) dftt::load8(q + 8 * c, qv + 8 * c);
  int stage = 0;
  for (int j = warp; rank + cluster * j < n_live; j += kWarps)
    stage = run_split(a, ring, slots + j * kSlotFloats, qv, b, h, rank + cluster * j, tiles, valid,
                      lane, stage,
                      j == warp ? first : first_position(a, b, (rank + cluster * j) * a.split_tiles));

  __syncwarp();
  dftt::hopper::cluster_sync();  // every partial is in its slot
  if (rank == 0) combine(a, slots, reinterpret_cast<float*>(rings), cluster, n_live, bh);
  __syncwarp();
  dftt::hopper::cluster_sync();  // rank 0 has read every slot
}

// Past 48 KB of shared memory, and clusters of 16: set once.
inline cudaError_t opt_in() {
  static const cudaError_t err = [] {
    cudaError_t e =
        cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

// The launch of grid (cluster, H, B) in clusters of `cluster` CTAs.
struct Config {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  Config(int cluster, int H, int B, int n_splits, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster, H, B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_bytes(n_splits, cluster);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  Config(const Config&) = delete;
};

bool takes(int n_splits, int cluster) {
  return cluster >= 1 && cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0 &&
         smem_bytes(n_splits, cluster) <= kSmemLimit;
}

int launch(DecodeArgs a, int B, int cluster, cudaStream_t st) {
  if (a.T <= 0 || a.T > kMaxTile || a.split_tiles <= 0 || a.n_tiles <= 0 ||
      a.n_splits != (a.n_tiles + a.split_tiles - 1) / a.split_tiles || !takes(a.n_splits, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Config c(cluster, a.H, B, a.n_splits, st);
  err = cudaLaunchKernelEx(&c.cfg, decode_kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace d32

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// table == nullptr selects the slab layout: row b's tile t covers slab
// positions [t*T, t*T + T) of a [B, S, H*D] cache. lens == nullptr gives
// every row len_all valid positions. partial is the f32
// [B, H, n_splits, D + 2] scratch. q, k, v and out are bf16. Built for D =
// 64 (the flagship's head dim); head dim 32 is dftt_flash_decode_d32's, and
// any other D returns cudaErrorInvalidValue.
extern "C" int dftt_flash_decode_bf16(
    const void* q, const void* k, const void* v, const void* table, const void* lens,
    void* partial, void* out, int B, int H, int D, int T, int n_tiles, int S, int n_pages,
    int split_tiles, int n_splits, int len_all, float scale, void* stream) {
  const DecodeArgs a{q, k, v, nullptr, nullptr,
                     static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens),
                     static_cast<float*>(partial), out,
                     H, T, n_tiles, S, n_pages, split_tiles, n_splits, len_all, 0, scale};
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch<64, Cache::kBf16>(a, B, static_cast<cudaStream_t>(stream));
}

// Head dim 32 on a bf16 cache (the speculative draft's and the JAX LM
// CLI's): d32::decode_kernel, one launch in clusters of `cluster` CTAs (a
// power of two up to 16, ops/flash_decode.py::d32_cluster), no scratch.
// The other arguments are dftt_flash_decode_bf16's.
extern "C" int dftt_flash_decode_d32(
    const void* q, const void* k, const void* v, const void* table, const void* lens, void* out,
    int B, int H, int T, int n_tiles, int S, int n_pages, int split_tiles, int n_splits,
    int cluster, int len_all, float scale, void* stream) {
  const DecodeArgs a{q, k, v, nullptr, nullptr,
                     static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens),
                     nullptr, out,
                     H, T, n_tiles, S, n_pages, split_tiles, n_splits, len_all, 0, scale};
  return d32::launch(a, B, cluster, static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` CTAs of d32::decode_kernel the card holds
// at once at n_splits splits a row (cudaOccupancyMaxActiveClusters), or a
// negative CUDA error code.
extern "C" int dftt_flash_decode_d32_clusters(int n_splits, int cluster) {
  if (n_splits < 1 || !d32::takes(n_splits, cluster)) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = d32::opt_in();
  const d32::Config c(cluster, 1, 1, n_splits, nullptr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, d32::decode_kernel, &c.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The f32 kernel, arguments as dftt_flash_decode_bf16's: q, k, v and out
// are f32 (q, K and V rounded to bf16 for the products, the output f32).
// Built for D = 64 and D = 32.
extern "C" int dftt_flash_decode_f32(
    const void* q, const void* k, const void* v, const void* table, const void* lens,
    void* partial, void* out, int B, int H, int D, int T, int n_tiles, int S, int n_pages,
    int split_tiles, int n_splits, int len_all, float scale, void* stream) {
  const DecodeArgs a{q, k, v, nullptr, nullptr,
                     static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens),
                     static_cast<float*>(partial), out,
                     H, T, n_tiles, S, n_pages, split_tiles, n_splits, len_all, 0, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64, Cache::kF32>(a, B, st);
  if (D == 32) return launch<32, Cache::kF32>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 kernel (layouts as above); k_scale/v_scale are f32 [n_pages, T, H]
// pools (paged) or [B, S, H] slabs; q and out are bf16. Every K/V pointer
// and the H*D row stride must be 16-byte aligned. Built for D = 64 only.
extern "C" int dftt_flash_decode_int8(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* table, const void* lens, void* partial, void* out, int B, int H, int D, int T,
    int n_tiles, int S, int n_pages, int split_tiles, int n_splits, int len_all, float scale,
    void* stream) {
  const DecodeArgs a{q, k, v,
                     static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                     static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens),
                     static_cast<float*>(partial), out,
                     H, T, n_tiles, S, n_pages, split_tiles, n_splits, len_all, 0, scale};
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch<64, Cache::kInt8>(a, B, static_cast<cudaStream_t>(stream));
}
