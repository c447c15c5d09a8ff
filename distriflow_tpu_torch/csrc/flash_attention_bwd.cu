// Attention backward (bf16) for Hopper: the fused kernel, the two-kernel
// layout, and the pass that sums the fused kernel's dQ partials.
//
// Replaces the Pallas TPU kernels of the JAX package
//   distriflow_tpu/ops/flash_attention.py::_dkvq_kernel  (fused: dK, dV, dQ partials)
//   distriflow_tpu/ops/flash_attention.py::_dq_kernel    (two-kernel: dQ)
//   distriflow_tpu/ops/flash_attention.py::_dkv_kernel   (two-kernel: dK, dV)
// and the sum over the fused kernel's per-KV-tile dQ partials that the JAX
// package leaves to XLA (flash_attention.py:605). The JAX package takes the
// fused kernel while its backward tiles give at most
// _FUSED_BWD_MAX_KV_BLOCKS = 8 KV blocks (the flagship's S = 1024) and the
// two kernels past that (bf16 at D 64: S > 8192, long-context training);
// the wrappers in ops/flash_attention.py take the same decision.
//
// Numeric contract (flash_attention.py:171-336): S = Q.K^T from bf16
// operands with f32 accumulation, scale folded in after the product;
// P = exp(S*scale - lse) with masked pairs at exactly 0; P is rounded to
// bf16 before P^T.dO; dP = dO.V^T in f32; dS = P (dP - delta) is rounded to
// bf16 before dS^T.Q and dS.K; every sum is f32; dK and dQ are scaled once
// at the end and written in bf16 with dV. lse and delta are plain f32
// [B*H, S] rows (delta = rowsum(dO * O), minus any lse cotangent, computed
// by the caller). In the D 64 kernels and the fused one, P is expf of the
// plain version's f32 argument, S*scale - lse (which the compiler may
// contract into one fma; rounding S*scale first was slower and needed no
// less atol): an exp2 with the scale folded into log2(e) needed atol
// 8.1e-4 against the 1e-3 limit. The D 32 pair rounds the argument as the
// plain version does and takes ex2 of it times log2(e) (see there).
//
// Every kernel here has one shape (csrc/hopper.cuh): a producer warp issues
// TMA loads of [rows, D] bf16 tiles (rows past S read as zeros) into a
// ring of shared-memory stages with full and empty mbarriers, and two
// consumer warpgroups of 64 rows each (three in the D 32 pair) run wgmma
// products with S, dP, P and dS in registers. No kernel uses atomics and each adds its terms in one
// fixed order, so every launch gives the same bits.
//
// The fused kernel is a template on the head dim D, built for 64 (the
// flagship's) and 32 (the JAX LM CLI's model, d_model 256 over 8 heads),
// as the forward is (csrc/flash_attention.cu); the two-kernel layout is
// built at D 64 from the same templates (dq_split, dkv_kernel<false>) and
// at D 32 as a pair of its own (namespace d32, below). At D 32 a tile row
// is 64 bytes: the 64-byte swizzle and descriptors of layout type 2. The
// products whose contraction is D (S = Q.K^T, dP = dO.V^T and their
// transposes) take D / 16 = 2 k16 steps; those whose N is D (dQ += dS.K,
// dV += P^T.dO, dK += dS^T.Q) are m64n32k16. The fused kernel's dS tile is
// [64 queries, 64 keys] at every D, so it keeps 128-byte rows.
//
// Bound: per (b, h) and live causal pair the fused backward runs 5 products
// of 2*D FLOPs (S, dP, dV, dK, dQ), the dQ kernel 3 (S, dP, dQ) and the
// dK/dV kernel 4 (S, dP, dV, dK), on about 7*S*D*2 bytes of inputs and
// outputs, and every kernel one exponential a live pair (16 a clock an SM:
// 132 x 16 x 1.83 GHz). At training lengths and beyond the floor is FLOPs
// over 989 TF/s but for the dQ kernel at D 32, where the exponentials
// bound it (2.22 ms at B8 H8 S16384 D32 causal; dK/dV 2.224 by FLOPs).
//
// The fused kernel's dQ partials are the price of a dQ with the same bits
// every launch: one f32 [64, 64] partial per live (KV tile, Q tile) pair,
// written once and read once by the second pass. At B8 H8 S1024 causal (16
// Q tiles x 8 KV tiles, 72 of 128 pairs live) that is 75.5 MB each way,
// about 0.045 ms at 3.35 TB/s against the kernel's 0.0217 ms operation
// bound; at B1 H8 S8192, the longest S of the fused layout (4,160 of 8,192
// pairs), about 0.55 GB each way, 0.33 ms against 0.174 ms. The buffer is
// [ceil(S/128), B*H, S, D] f32 (1.07 GB at B1 H8 S8192) and is never
// zeroed: fully masked pairs are neither written nor read.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace dftt::hopper;

constexpr int kConsumers = 2;                    // warpgroups, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kConsumerBarrier = 1;              // named barrier of the consumer warpgroups

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// ---------------------------------------------------------------------------
// dQ of the two-kernel layout (kernel 7).
//
// One block per (b*h, 128-row Q tile): two consumer warpgroups own 64 query
// rows each and keep their dQ accumulator in f32 registers for the whole
// walk; the producer warp loads the Q and dO tiles once by TMA and then
// streams 64-key K and V tiles, from key 0 up to the causal bound, through
// a ring of kStages stages. Each consumer thread reads its two rows' lse
// and delta once into registers (guarded by S). For each K tile a
// warpgroup runs three wgmma products:
//   S = Q.K^T and dP = dO.V^T (both operands in shared memory, K-major),
//   P = exp(S * scale - lse) and dS = P (dP - delta) in registers, dS
//   rounded to bf16 into the register A operand,
//   dQ += dS.K with K read MN-major (as the forward reads V).
// A warpgroup whose 64 rows all precede a K tile skips it. Masking runs only
// on tiles that cross the warpgroup's diagonal or reach past S (keys past S,
// zero-filled by TMA, are masked too). dQ * scale is written as bf16 from
// registers. blockIdx.x is the head and blockIdx.y counts the Q tiles from
// the last, so the longest causal rows start first.
namespace dq_split {

constexpr int kBQ = 64 * kConsumers;  // query rows per block
constexpr int kBK = 64;               // keys per streamed K/V tile
constexpr int kStages = 4;
using Pipe = Ring<kStages>;

// The shared-memory layout at head dim D: the Q and dO tiles, then
// kStages K and V tiles of D-column rows (2 * D bytes each), then the
// barriers.
template <int D>
struct Shape {
  static_assert(D == 64, "built for head dim 64 (D 32: d32::dq below)");
  static constexpr int kRow = 2 * D;
  static constexpr uint32_t kQBytes = kBQ * kRow;
  static constexpr uint32_t kKVBytes = kBK * kRow;
  static constexpr size_t kSmemBytes =
      kSwizzleBytes + 2 * kQBytes + 2 * kStages * kKVBytes + sizeof(uint64_t) * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int S, float scale, int causal) {
  constexpr int kRow = Shape<D>::kRow;
  constexpr uint32_t kQBytes = Shape<D>::kQBytes, kKVBytes = Shape<D>::kKVBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = aligned_smem(smem_raw);
  unsigned char* do_s = q_s + kQBytes;
  unsigned char* k_s = do_s + kQBytes;
  unsigned char* v_s = k_s + kStages * kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  int n_kb = (S + kBK - 1) / kBK;
  // causal: K tiles wholly past this Q tile's last row are fully masked
  if (causal) n_kb = min(n_kb, (q0 + kBQ) / kBK);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * kQBytes);
      tma_load_rows(q_s, &tm_q, q0, bh, q_full);
      tma_load_rows(do_s, &tm_do, q0, bh, q_full);
      for (int t = 0; t < n_kb; ++t) {
        const int s = Pipe::stage(t);
        mbar_wait(&empty[s], Pipe::empty_parity(t));
        mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_rows(k_s + s * kKVBytes, &tm_k, t * kBK, bh, &full[s]);
        tma_load_rows(v_s + s * kKVBytes, &tm_v, t * kBK, bh, &full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows first_row .. first_row + 63 of the Q tile;
  // this thread holds rows row0 and row0 + 8 and, of each K tile, the keys
  // 8n + col + {0, 1}
  const int wg = warp / 4;
  const int first_row = q0 + 64 * wg;
  const int row0 = first_row + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  float l[2], d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int64_t at = static_cast<int64_t>(bh) * S + row;
    l[i] = row < S ? lse[at] : 0.f;
    d[i] = row < S ? delta[at] : 0.f;
  }
  float acc_dq[D / 2], acc_s[kBK / 2], acc_dp[kBK / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc_dq[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kBK / 2; ++r) acc_s[r] = acc_dp[r] = 0.f;

  mbar_wait(q_full, 0);
  const uint64_t desc_q = desc_kmajor<kRow>(q_s + 64 * wg * kRow);
  const uint64_t desc_do = desc_kmajor<kRow>(do_s + 64 * wg * kRow);

  for (int t = 0; t < n_kb; ++t) {
    const int s = Pipe::stage(t);
    const int k0 = t * kBK;
    mbar_wait(&full[s], Pipe::full_parity(t));
    // causal: every key of this tile follows every row of this warpgroup
    if (causal && k0 > first_row + 63) {
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const unsigned char* k_t = k_s + s * kKVBytes;
    const uint64_t desc_k = desc_kmajor<kRow>(k_t),
                   desc_v = desc_kmajor<kRow>(v_s + s * kKVBytes);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_m64n64k16_ss<0>(acc_s, desc_q + kmajor_step(j), desc_k + kmajor_step(j), j > 0);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_m64n64k16_ss<0>(acc_dp, desc_do + kmajor_step(j), desc_v + kmajor_step(j), j > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    fence_regs(acc_dp);

    // dS (f32) into acc_dp
    const bool masked = k0 + kBK > S || (causal && k0 + kBK - 1 > first_row);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 4 * n + 2 * i + j;
          float p = expf(acc_s[r] * scale - l[i]);
          if (masked) {
            const int kpos = k0 + 8 * n + col + j;
            if (kpos >= S || (causal && kpos > row0 + 8 * i)) p = 0.f;
          }
          acc_dp[r] = p * (acc_dp[r] - d[i]);
        }
    uint32_t ds_a[kBK / 16][4];
    acc_to_a(acc_dp, ds_a);

    // dQ += dS.K: N is D
    const uint64_t desc_k_mn = desc_mnmajor<kRow>(k_t);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c)
      wgmma_m64n64k16_rs<1>(acc_dq, ds_a[c], desc_k_mn + mnmajor_step<kRow>(c), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    fence_regs(ds_a);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with the stage
  }

  // dQ = scale * acc in bf16, straight from registers
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* dst = dq + (static_cast<int64_t>(bh) * S + row) * D + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          acc_dq[4 * n + 2 * i] * scale, acc_dq[4 * n + 2 * i + 1] * scale);
  }
}

}  // namespace dq_split

// ---------------------------------------------------------------------------
// dK/dV (kernel 8) and the fused backward (kernel 6): dkv_kernel<false>
// and dkv_kernel<true>.
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
//   P^T = exp(S^T * scale - lse) in registers (lse indexes the column),
//   dV += P^T.dO with P^T as bf16 in registers (dO read MN-major),
//   dS^T = P^T (dP^T - delta) as bf16 in registers, dK += dS^T.Q.
// S, dP, P and dS never touch shared memory, and one P per tile pair feeds
// every gradient (JAX's fused contract: 5 products a pair, not the
// two-kernel layout's 7). blockIdx.x is the head and blockIdx.y the K tile
// in ascending order, so the heaviest causal tiles start first.
//
// The fused kernel adds each Q tile's dQ partial dS.K over the block's 128
// keys. dS lies in registers transposed (keys x queries), so each
// warpgroup also stores its bf16 dS^T, transposed, into a swizzled [64
// queries, 64 keys] tile (the K-major A operand), while its dV/dK products
// run. The two warpgroups meet at a named barrier; then warpgroup t % 2
// runs dQp = dS.K as SS wgmma over both tiles (K read MN-major), and writes
// the f32 partial once into dqp[kv_tile, b*h, q rows, :] (JAX's
// [n_kv, BH, S, D] layout at the port's 128-key tile). The dS tiles are
// double-buffered by step parity: a buffer is written again only after the
// next step's barrier, which the warpgroup that read it reaches after its
// product is done. dq_sum_kernel then sums the partials.
namespace dkv {

constexpr int kBKV = 64 * kConsumers;    // key rows per block
constexpr int kBQ = 64;                  // query rows per streamed tile
constexpr int kStages = 3;
// a warpgroup's dS tile, [64 queries, 64 keys] bf16: 128-byte rows at every D
constexpr uint32_t kDsBytes = kBQ * kRowBytes;
using Pipe = Ring<kStages>;

template <int D>
struct Shape {
  static_assert(D == 64 || D == 32, "built for head dims 64 and 32");
  static constexpr int kRow = 2 * D;
  static constexpr uint32_t kKVBytes = kBKV * kRow;
  static constexpr uint32_t kQBytes = kBQ * kRow;
};

template <bool kDqPartials>
__host__ __device__ constexpr uint32_t ds_bytes() {
  return kDqPartials ? 2 * kConsumers * kDsBytes : 0;  // two step parities x two warpgroups
}

template <bool kDqPartials, int D>
constexpr size_t smem_bytes() {
  return kSwizzleBytes + 2 * Shape<D>::kKVBytes + ds_bytes<kDqPartials>() +
         2 * kStages * Shape<D>::kQBytes + 2 * kStages * kBQ * sizeof(float) +
         sizeof(uint64_t) * (1 + 2 * kStages);
}

// The KV tiles whose dQ partial the fused kernel writes for the 64-row Q
// tile `q_tile`: tiles 0 .. live_kv_tiles - 1, all of them unless causal,
// else those that start at or before the Q tile's last row. The second
// pass reads exactly these. The last Q tile meets every KV tile, so the
// wrapper sizes dqp at ceil(S / kBKV) tiles.
__host__ __device__ __forceinline__ int live_kv_tiles(int q_tile, int S, int causal) {
  const int n_kv = (S + kBKV - 1) / kBKV;
  const int stop = (q_tile * kBQ + kBQ - 1) / kBKV + 1;
  return causal && stop < n_kv ? stop : n_kv;
}

// This warpgroup's dS^T (f32, the accumulator layout of 64 keys x 64
// queries) as bf16 dS into `tile`, [64 queries, 64 keys] with the 128-byte
// swizzle: 16-byte chunk c of row r lies at chunk c ^ (r % 8). `key` is this
// thread's first key within the warpgroup (the second is key + 8), `col`
// its first query column of each group of 8.
__device__ __forceinline__ void store_ds(const float (&ds_t)[kBQ / 2], unsigned char* tile, int key,
                                         int col) {
#pragma unroll
  for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qr = 8 * n + col + j, kk = key + 8 * i;
        const int off = qr * kRowBytes + ((((kk >> 3) ^ (qr & 7)) << 4) | ((kk & 7) << 1));
        *reinterpret_cast<__nv_bfloat16*>(tile + off) = __float2bfloat16_rn(ds_t[4 * n + 2 * i + j]);
      }
}

template <bool kDqPartials, int D>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ dqp,
    int S, float scale, int causal) {
  constexpr int kRow = Shape<D>::kRow;
  constexpr uint32_t kKVBytes = Shape<D>::kKVBytes, kQBytes = Shape<D>::kQBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = aligned_smem(smem_raw);
  unsigned char* v_s = k_s + kKVBytes;
  unsigned char* ds_s = v_s + kKVBytes;  // [step parity][warpgroup] dS tiles
  unsigned char* q_s = ds_s + ds_bytes<kDqPartials>();
  unsigned char* do_s = q_s + kStages * kQBytes;
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * kQBytes);
  float* delta_s = lse_s + kStages * kBQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + kStages * kBQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBKV;
  // causal: Q tiles wholly before this K tile see none of it (the first Q
  // tile for which this K tile is live, by live_kv_tiles)
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
  float acc_dk[D / 2], acc_dv[D / 2], acc_s[kBQ / 2], acc_dp[kBQ / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc_dk[r] = acc_dv[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kBQ / 2; ++r) acc_s[r] = acc_dp[r] = 0.f;

  mbar_wait(kv_full, 0);
  const uint64_t desc_k = desc_kmajor<kRow>(k_s + 64 * wg * kRow);
  const uint64_t desc_v = desc_kmajor<kRow>(v_s + 64 * wg * kRow);

  for (int t = 0; t < n_steps; ++t) {
    const int s = Pipe::stage(t);
    const int q0 = (qt0 + t) * kBQ;
    unsigned char* ds_t = ds_s + (t % 2) * kConsumers * kDsBytes;
    mbar_wait(&full[s], Pipe::full_parity(t));
    // causal: every query of this tile precedes every key of this
    // warpgroup (never warpgroup 0, whose first key is at or before q0)
    if (!(causal && q0 + kBQ - 1 < first_key)) {
      const unsigned char* q_t = q_s + s * kQBytes;
      const unsigned char* do_t = do_s + s * kQBytes;
      const uint64_t desc_q = desc_kmajor<kRow>(q_t), desc_do = desc_kmajor<kRow>(do_t);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wgmma_m64n64k16_ss<0>(acc_s, desc_k + kmajor_step(j), desc_q + kmajor_step(j), j > 0);
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wgmma_m64n64k16_ss<0>(acc_dp, desc_v + kmajor_step(j), desc_do + kmajor_step(j), j > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);
      fence_regs(acc_dp);

      // P^T (f32) into acc_s and dS^T (f32) into acc_dp. Keys past S
      // (zero-filled) are masked in the fused kernel only, whose dS.K
      // reads them: dK/dV rows past S are never written, and the test
      // slowed the dK/dV kernel at S 16384.
      const bool masked = q0 + kBQ > S || (kDqPartials && first_key + 64 > S) ||
                          (causal && q0 < first_key + 63);
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
              const int key = key0 + 8 * i;
              if (qpos >= S || (kDqPartials && key >= S) || (causal && qpos < key)) p = 0.f;
            }
            acc_s[r] = p;
            acc_dp[r] = p * (acc_dp[r] - (j ? dq.y : dq.x));
          }
      }
      uint32_t p_a[kBQ / 16][4], ds_a[kBQ / 16][4];
      acc_to_a(acc_s, p_a);
      acc_to_a(acc_dp, ds_a);

      // dV += P^T.dO and dK += dS^T.Q: N is D
      const uint64_t desc_do_mn = desc_mnmajor<kRow>(do_t), desc_q_mn = desc_mnmajor<kRow>(q_t);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kBQ / 16; ++c) {
        if constexpr (D == 64)
          wgmma_m64n64k16_rs<1>(acc_dv, p_a[c], desc_do_mn + mnmajor_step<kRow>(c), 1);
        else
          wgmma_m64n32k16_rs<1>(acc_dv, p_a[c], desc_do_mn + mnmajor_step<kRow>(c), 1);
      }
#pragma unroll
      for (int c = 0; c < kBQ / 16; ++c) {
        if constexpr (D == 64)
          wgmma_m64n64k16_rs<1>(acc_dk, ds_a[c], desc_q_mn + mnmajor_step<kRow>(c), 1);
        else
          wgmma_m64n32k16_rs<1>(acc_dk, ds_a[c], desc_q_mn + mnmajor_step<kRow>(c), 1);
      }
      wgmma_commit();
      // while dV and dK run: this warpgroup's dS for the dQ partial
      if constexpr (kDqPartials) store_ds(acc_dp, ds_t + wg * kDsBytes, key0 - first_key, col);
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(p_a);
      fence_regs(ds_a);
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with the stage

    if constexpr (kDqPartials) {
      fence_proxy_async();
      named_barrier_sync(kConsumerBarrier, 128 * kConsumers);
      if (wg == t % 2) {
        // dQp = dS.K over the block's keys; warpgroup 1's tile holds no dS
        // when it skipped this Q tile
        const bool both = !(causal && q0 + kBQ - 1 < k0 + 64);
        const uint64_t desc_k0 = desc_mnmajor<kRow>(k_s),
                       desc_k1 = desc_mnmajor<kRow>(k_s + 64 * kRow);
        const uint64_t desc_ds0 = desc_kmajor(ds_t), desc_ds1 = desc_kmajor(ds_t + kDsBytes);
        float acc_dq[D / 2];  // live only here, so as not to hold D / 2 more registers in the walk
#pragma unroll
        for (int r = 0; r < D / 2; ++r) acc_dq[r] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (D == 64)
            wgmma_m64n64k16_ss<1>(acc_dq, desc_ds0 + kmajor_step(c),
                                  desc_k0 + mnmajor_step<kRow>(c), c > 0);
          else
            wgmma_m64n32k16_ss<1>(acc_dq, desc_ds0 + kmajor_step(c),
                                  desc_k0 + mnmajor_step<kRow>(c), c > 0);
        }
        if (both) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if constexpr (D == 64)
              wgmma_m64n64k16_ss<1>(acc_dq, desc_ds1 + kmajor_step(c),
                                    desc_k1 + mnmajor_step<kRow>(c), 1);
            else
              wgmma_m64n32k16_ss<1>(acc_dq, desc_ds1 + kmajor_step(c),
                                    desc_k1 + mnmajor_step<kRow>(c), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_dq);
        // rows q0 + 16 (warp % 4) + lane / 4 + {0, 8}, written once
        const int row0 = q0 + 16 * (warp % 4) + lane / 4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + 8 * i;
          if (row >= S) continue;
          float* dst =
              dqp + ((static_cast<int64_t>(blockIdx.y) * gridDim.x + bh) * S + row) * D + col;
#pragma unroll
          for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<float2*>(dst + 8 * n) =
                make_float2(acc_dq[4 * n + 2 * i], acc_dq[4 * n + 2 * i + 1]);
        }
      }
    }
  }

  // dK = scale * acc and dV = acc in bf16, straight from registers
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= S) continue;
    const int64_t off = (static_cast<int64_t>(bh) * S + key) * D + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) = __floats2bfloat162_rn(
          acc_dk[4 * n + 2 * i] * scale, acc_dk[4 * n + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(acc_dv[4 * n + 2 * i], acc_dv[4 * n + 2 * i + 1]);
    }
  }
}

// The fused backward's second pass: dq = bf16(scale * sum of dqp[j]) over
// the live KV tiles j of each row's Q tile, in ascending j. One thread per
// four columns of a row (n = B*H * S * D / 4 of them): each partial is read
// as one 16-byte load, a KV tile's slab (n float4) apart. The head dim is
// an argument: the pass is bound by bytes, and one build serves both.
__global__ void __launch_bounds__(256) dq_sum_kernel(const float* __restrict__ dqp,
                                                     __nv_bfloat16* __restrict__ dq, int64_t n,
                                                     int S, int D, float scale, int causal) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = static_cast<int>((i / (D / 4)) % S);
  const int stop = live_kv_tiles(row / kBQ, S, causal);
  const float4* src = reinterpret_cast<const float4*>(dqp) + i;
  float4 acc = src[0];
  for (int j = 1; j < stop; ++j) {
    const float4 x = src[j * n];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(dq) + 2 * i;
  dst[0] = __floats2bfloat162_rn(acc.x * scale, acc.y * scale);
  dst[1] = __floats2bfloat162_rn(acc.z * scale, acc.w * scale);
}

}  // namespace dkv

// ---------------------------------------------------------------------------
// The two-kernel layout at head dim 32 (kernels 7 and 8 at D 32): the JAX
// LM CLI's --seq 16384 --remat (B8 H8 S16384 D32, causal).
//
// At D 32 the products halve (two k16 steps for S and dP, m64n32k16 for
// the products whose N is D) but the elementwise work of a (query, key)
// pair does not. Per SM the special-function units give 16 exponentials a
// clock (measured on the H100) against the tensor cores' 4096 bf16 FLOPs,
// so one exponential costs what 256 FLOPs do: the dQ kernel's 3 products
// (192 FLOPs a pair) take less time than its exponentials, the dK/dV
// kernel's 4 (256) as long. The design follows from that:
//
// - P = ex2((S * scale - lse) * log2(e)): the argument rounded as the
//   plain version rounds it (S * scale, then minus lse, each its own f32
//   rounding), then one multiply and one ex2: four instructions, against
//   expf's eight (expf of the contracted argument, the D 64 kernels' form,
//   made these kernels 1.4x and 1.3x slower). P then differs from the
//   plain version's by a few ulps, and a bf16 rounding of dS flips where
//   it did not. Over four draws at the path's shape (tools/d32_bwd_probe.py)
//   dQ needs atol 3.4e-4 to 2.0e-3 above its rtol, past the 1e-3 limit on
//   one draw, where expf of the contracted argument needs 1.13e-3; folding
//   log2(e) into scale and lse (one FMA, 4% faster) is past it on two.
// - The elementwise work runs in three passes over the thread's 32 pairs
//   (P; the mask, on diagonal and edge tiles only; dS), the first and last
//   without a branch, so the compiler interleaves all 32 exponentials of a
//   thread. With the mask inside one loop it branched every four pairs,
//   and a warp's exponentials ran at a third of the units' rate.
// - Three consumer warpgroups a block (416 threads, one block an SM):
//   while one warpgroup waits for its products, the others take their
//   exponentials. Each warpgroup waits for the next tile's stage while
//   this tile's S and dP run (8% off the dK/dV kernel). Two warpgroups,
//   two blocks an SM (registers spill), warpgroups issuing in turns on
//   named barriers, tiles split in halves of 32 keys, the next tile's S
//   and dP issued before this tile's exponentials (registers spill, the
//   products serialize), dV issued before dS is computed, and deeper
//   rings were each no faster on the card.
//
// The numeric contract is the file's: bf16 operands, f32 sums, P and dS
// rounded to bf16 before the products they feed, write-once outputs, no
// atomics, one fixed order of terms, so every launch gives the same bits.
namespace d32 {

constexpr int D = 32;
constexpr int kRow = 2 * D;  // 64-byte rows: the 64-byte swizzle
constexpr int kWarpgroups = 3;  // consumer warpgroups a block, 64 rows each
constexpr int kBlockThreads = 128 * kWarpgroups + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// P of one pair from its raw score s: exp(s * scale - lse), see above.
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  float p;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(p)
      : "f"(__fmul_rn(__fadd_rn(__fmul_rn(s, scale), -lse), kLog2e)));
  return p;
}

// acc = A.B^T over the D = 32 contraction (two k16 steps), A and B K-major
// in shared memory: S = Q.K^T and dP = dO.V^T, or their transposes.
__device__ __forceinline__ void product_d(float (&acc)[32], uint64_t desc_a, uint64_t desc_b) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wgmma_m64n64k16_ss<0>(acc, desc_a + kmajor_step(j), desc_b + kmajor_step(j), j > 0);
}

// acc += A.B over 64 rows of B, A the bf16 register operand and B MN-major
// in shared memory with D = 32 columns: dQ += dS.K, dV += P^T.dO,
// dK += dS^T.Q.
__device__ __forceinline__ void product_n(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                          uint64_t desc_b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) wgmma_m64n32k16_rs<1>(acc, a[c], desc_b + mnmajor_step<kRow>(c), 1);
}

// dQ (kernel 7 at D 32). One block per (b*h, 192-row Q tile), three
// consumer warpgroups of 64 rows, dQ in f32 registers; the producer warp
// loads Q and dO once and streams 64-key K and V tiles from key 0 to the
// causal bound through kStages stages. blockIdx.y counts the Q tiles from
// the last, so the longest causal rows start first.
namespace dq {

constexpr int kBQ = 64 * kWarpgroups;
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr uint32_t kQBytes = kBQ * kRow;
constexpr uint32_t kKVBytes = kBK * kRow;
constexpr size_t kSmemBytes =
    kSwizzleBytes + 2 * kQBytes + 2 * kStages * kKVBytes + sizeof(uint64_t) * (1 + 2 * kStages);
using Pipe = Ring<kStages>;

__global__ void __launch_bounds__(kBlockThreads, 1) dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int S, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = aligned_smem(smem_raw);
  unsigned char* do_s = q_s + kQBytes;
  unsigned char* k_s = do_s + kQBytes;
  unsigned char* v_s = k_s + kStages * kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  int n_kb = (S + kBK - 1) / kBK;
  // causal: K tiles wholly past this Q tile's last row are fully masked
  if (causal) n_kb = min(n_kb, (q0 + kBQ) / kBK);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarpgroups);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kWarpgroups) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * kQBytes);
      tma_load_rows(q_s, &tm_q, q0, bh, q_full);
      tma_load_rows(do_s, &tm_do, q0, bh, q_full);
      for (int t = 0; t < n_kb; ++t) {
        const int s = Pipe::stage(t);
        mbar_wait(&empty[s], Pipe::empty_parity(t));
        mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_rows(k_s + s * kKVBytes, &tm_k, t * kBK, bh, &full[s]);
        tma_load_rows(v_s + s * kKVBytes, &tm_v, t * kBK, bh, &full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows first_row .. first_row + 63; this thread
  // holds rows row0 and row0 + 8 and, of each K tile, the keys
  // 8n + col + {0, 1} (register 4n + 2i + j: row row0 + 8i, key 8n + col + j).
  // wg is read from lane 0, so the compiler knows it is the same across the
  // warp, and so the loop bounds around the products below
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int first_row = q0 + 64 * wg;
  const int row0 = first_row + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  float l[2], d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int64_t at = static_cast<int64_t>(bh) * S + row;
    l[i] = row < S ? lse[at] : 0.f;
    d[i] = row < S ? delta[at] : 0.f;
  }
  // causal: this warpgroup's K tiles start at or before its last row; the
  // block's later ones are waited for and released unread
  const int n_mine = causal ? min(n_kb, (first_row + 63) / kBK + 1) : n_kb;

  float acc_dq[D / 2], acc_s[kBK / 2], acc_dp[kBK / 2];
  uint32_t ds_a[kBK / 16][4];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc_dq[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kBK / 2; ++r) acc_s[r] = acc_dp[r] = 0.f;

  mbar_wait(q_full, 0);
  const uint64_t desc_q = desc_kmajor<kRow>(q_s + 64 * wg * kRow);
  const uint64_t desc_do = desc_kmajor<kRow>(do_s + 64 * wg * kRow);

  // a stage is waited for ahead: tile 0's here, tile t + 1's while tile
  // t's S and dP run
  if (n_mine > 0) mbar_wait(&full[0], 0);
  for (int t = 0; t < n_mine; ++t) {
    const int s = Pipe::stage(t);
    const int k0 = t * kBK;
    const unsigned char* k_t = k_s + s * kKVBytes;
    wgmma_fence();
    product_d(acc_s, desc_q, desc_kmajor<kRow>(k_t));
    product_d(acc_dp, desc_do, desc_kmajor<kRow>(v_s + s * kKVBytes));
    wgmma_commit();
    if (t + 1 < n_kb) mbar_wait(&full[Pipe::stage(t + 1)], Pipe::full_parity(t + 1));
    wgmma_wait<0>();
    fence_regs(acc_s);
    fence_regs(acc_dp);

    // P into acc_s, masked pairs to 0, then dS = P (dP - delta) into acc_dp
#pragma unroll
    for (int r = 0; r < kBK / 2; ++r) acc_s[r] = prob(acc_s[r], scale, l[(r >> 1) & 1]);
    if (k0 + kBK > S || (causal && k0 + kBK - 1 > first_row)) {
#pragma unroll
      for (int r = 0; r < kBK / 2; ++r) {
        const int kpos = k0 + 8 * (r >> 2) + col + (r & 1);
        if (kpos >= S || (causal && kpos > row0 + 8 * ((r >> 1) & 1))) acc_s[r] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kBK / 2; ++r) acc_dp[r] = acc_s[r] * (acc_dp[r] - d[(r >> 1) & 1]);
    acc_to_a(acc_dp, ds_a);

    wgmma_fence();
    product_n(acc_dq, ds_a, desc_mnmajor<kRow>(k_t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    fence_regs(ds_a);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with the stage
  }
  for (int t = n_mine; t < n_kb; ++t) {
    mbar_wait(&full[Pipe::stage(t)], Pipe::full_parity(t));
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[Pipe::stage(t)]);
  }

  // dQ = scale * acc in bf16, straight from registers
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* dst = dq + (static_cast<int64_t>(bh) * S + row) * D + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          acc_dq[4 * n + 2 * i] * scale, acc_dq[4 * n + 2 * i + 1] * scale);
  }
}

}  // namespace dq

// dK/dV (kernel 8 at D 32). One block per (b*h, 192-key K/V tile), three
// consumer warpgroups of 64 keys, dK and dV in f32 registers; the producer
// warp loads the K/V tile once and streams 64-row Q and dO tiles from the
// causal bound on, with their rows' lse and delta, through kStages stages
// (its 32 lanes each arrive on the stage's full barrier). blockIdx.y is
// the K tile in ascending order, so the heaviest causal tiles start first.
namespace dkv {

constexpr int kBKV = 64 * kWarpgroups;
constexpr int kBQ = 64;
constexpr int kStages = 3;
constexpr uint32_t kKVBytes = kBKV * kRow;
constexpr uint32_t kQBytes = kBQ * kRow;
constexpr size_t kSmemBytes = kSwizzleBytes + 2 * kKVBytes + 2 * kStages * kQBytes +
                              2 * kStages * kBQ * sizeof(float) + sizeof(uint64_t) * (1 + 2 * kStages);
using Pipe = Ring<kStages>;

__global__ void __launch_bounds__(kBlockThreads, 1) dkv_kernel(
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
      mbar_init(&empty[s], kWarpgroups);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kWarpgroups) {  // the producer warp
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

  // a consumer warpgroup: keys first_key .. first_key + 63; this thread
  // holds keys key0 and key0 + 8 and, of each Q tile, the query columns
  // 8n + col + {0, 1} (register 4n + 2i + j: key key0 + 8i, query
  // 8n + col + j); wg from lane 0, as in the dQ kernel
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int first_key = k0 + 64 * wg;
  const int key0 = first_key + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  // causal: the Q tiles before t_first precede every key of this warpgroup
  const int t_first = causal ? min(n_steps, 64 * wg / kBQ) : 0;

  float acc_dk[D / 2], acc_dv[D / 2], acc_s[kBQ / 2], acc_dp[kBQ / 2];
  uint32_t p_a[kBQ / 16][4], ds_a[kBQ / 16][4];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc_dk[r] = acc_dv[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kBQ / 2; ++r) acc_s[r] = acc_dp[r] = 0.f;

  mbar_wait(kv_full, 0);
  const uint64_t desc_k = desc_kmajor<kRow>(k_s + 64 * wg * kRow);
  const uint64_t desc_v = desc_kmajor<kRow>(v_s + 64 * wg * kRow);

  // a stage is waited for ahead, as in the dQ kernel
  mbar_wait(&full[0], 0);
  for (int t = 0; t < n_steps; ++t) {
    const int s = Pipe::stage(t);
    if (t < t_first && t + 1 < n_steps) mbar_wait(&full[Pipe::stage(t + 1)], Pipe::full_parity(t + 1));
    if (t >= t_first) {
      const int q0 = (qt0 + t) * kBQ;
      const unsigned char* q_t = q_s + s * kQBytes;
      const unsigned char* do_t = do_s + s * kQBytes;
      wgmma_fence();
      product_d(acc_s, desc_k, desc_kmajor<kRow>(q_t));
      product_d(acc_dp, desc_v, desc_kmajor<kRow>(do_t));
      wgmma_commit();
      if (t + 1 < n_steps) mbar_wait(&full[Pipe::stage(t + 1)], Pipe::full_parity(t + 1));
      wgmma_wait<0>();
      fence_regs(acc_s);
      fence_regs(acc_dp);

      // P^T into acc_s (lse indexes the column), masked pairs to 0, then
      // dS^T = P^T (dP^T - delta) into acc_dp
      const float* lse_t = lse_s + s * kBQ;
      const float* delta_t = delta_s + s * kBQ;
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n) {
        const float2 lq = *reinterpret_cast<const float2*>(lse_t + 8 * n + col);
#pragma unroll
        for (int r = 4 * n; r < 4 * n + 4; ++r) acc_s[r] = prob(acc_s[r], scale, r & 1 ? lq.y : lq.x);
      }
      if (q0 + kBQ > S || (causal && q0 < first_key + 63)) {
#pragma unroll
        for (int r = 0; r < kBQ / 2; ++r) {
          const int qpos = q0 + 8 * (r >> 2) + col + (r & 1);
          if (qpos >= S || (causal && qpos < key0 + 8 * ((r >> 1) & 1))) acc_s[r] = 0.f;
        }
      }
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_t + 8 * n + col);
#pragma unroll
        for (int r = 4 * n; r < 4 * n + 4; ++r)
          acc_dp[r] = acc_s[r] * (acc_dp[r] - (r & 1 ? dl.y : dl.x));
      }
      acc_to_a(acc_s, p_a);
      acc_to_a(acc_dp, ds_a);

      wgmma_fence();
      product_n(acc_dv, p_a, desc_mnmajor<kRow>(do_t));
      product_n(acc_dk, ds_a, desc_mnmajor<kRow>(q_t));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(p_a);
      fence_regs(ds_a);
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with the stage
  }

  // dK = scale * acc and dV = acc in bf16, straight from registers
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= S) continue;
    const int64_t off = (static_cast<int64_t>(bh) * S + key) * D + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) = __floats2bfloat162_rn(
          acc_dk[4 * n + 2 * i] * scale, acc_dk[4 * n + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(acc_dv[4 * n + 2 * i], acc_dv[4 * n + 2 * i + 1]);
    }
  }
}

}  // namespace dkv
}  // namespace d32

// TMA maps of q and dout with `q_rows`-row boxes, of k and v with `kv_rows`,
// over [BH, S, D] tensors.
struct Maps {
  CUtensorMap q, k, v, dout;
};

int make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout, int BH,
              int S, int D, int q_rows, int kv_rows) {
  int err = make_row_map(&m->q, q, BH, S, q_rows, D);
  if (!err) err = make_row_map(&m->dout, dout, BH, S, q_rows, D);
  if (!err) err = make_row_map(&m->k, k, BH, S, kv_rows, D);
  if (!err) err = make_row_map(&m->v, v, BH, S, kv_rows, D);
  return err;
}

template <bool kDqPartials, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, void* dqp, int BH, int S, int causal,
               float scale, cudaStream_t st) {
  Maps m;
  int err = make_maps(&m, q, k, v, dout, BH, S, D, dkv::kBQ, dkv::kBKV);
  if (err) return err;
  constexpr size_t bytes = dkv::smem_bytes<kDqPartials, D>();
  err = prepare(dkv::dkv_kernel<kDqPartials, D>, bytes);
  if (err) return err;
  dkv::dkv_kernel<kDqPartials, D><<<dim3(BH, (S + dkv::kBKV - 1) / dkv::kBKV), kThreads, bytes, st>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), static_cast<float*>(dqp),
      S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, void* dqp, void* dq, int BH, int S,
               int causal, float scale, cudaStream_t st) {
  const int err = launch_dkv<true, D>(q, k, v, dout, lse, delta, dk, dv, dqp, BH, S, causal, scale, st);
  if (err) return err;
  const int64_t n = static_cast<int64_t>(BH) * S * (D / 4);
  dkv::dq_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dqp), static_cast<__nv_bfloat16*>(dq), n, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int BH, int S, int causal, float scale, cudaStream_t st) {
  using Sh = dq_split::Shape<D>;
  Maps m;
  int err = make_maps(&m, q, k, v, dout, BH, S, D, dq_split::kBQ, dq_split::kBK);
  if (err) return err;
  err = prepare(dq_split::dq_kernel<D>, Sh::kSmemBytes);
  if (err) return err;
  dq_split::dq_kernel<D><<<dim3(BH, (S + dq_split::kBQ - 1) / dq_split::kBQ), kThreads,
                           Sh::kSmemBytes, st>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_d32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* dq, int BH, int S, int causal, float scale,
                  cudaStream_t st) {
  using namespace d32::dq;
  Maps m;
  int err = make_maps(&m, q, k, v, dout, BH, S, d32::D, kBQ, kBK);
  if (err) return err;
  err = prepare(dq_kernel, kSmemBytes);
  if (err) return err;
  dq_kernel<<<dim3(BH, (S + kBQ - 1) / kBQ), d32::kBlockThreads, kSmemBytes, st>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_d32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int BH, int S, int causal, float scale,
                   cudaStream_t st) {
  using namespace d32::dkv;
  Maps m;
  int err = make_maps(&m, q, k, v, dout, BH, S, d32::D, kBQ, kBKV);
  if (err) return err;
  err = prepare(dkv_kernel, kSmemBytes);
  if (err) return err;
  dkv_kernel<<<dim3(BH, (S + kBKV - 1) / kBKV), d32::kBlockThreads, kSmemBytes, st>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry: q, k, v, dout and the bf16 outputs are contiguous [BH, S, D]
// (16-byte aligned), lse and delta the plain f32 [BH, S] rows; D = 64 or
// 32, any other D returns cudaErrorInvalidValue. Each launches on `stream`
// and returns a CUDA error code (0 = launched; a tensor map that cannot be
// encoded returns cudaErrorInvalidValue).

// The fused backward: dk = scale * sum of dS^T.Q, dv = sum of P^T.dO, and
// dq = scale * sum of dS.K through dqp, f32 scratch of
// [ceil(S / 128), BH, S, D] that needs no zeroing (two kernels: the fused
// one writes each live partial once, the second pass sums them).
extern "C" int dftt_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* dqp, void* dq,
    int BH, int S, int D, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_bwd<64>(q, k, v, dout, lse, delta, dk, dv, dqp, dq, BH, S, causal, scale, st);
  if (D == 32) return launch_bwd<32>(q, k, v, dout, lse, delta, dk, dv, dqp, dq, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The two-kernel layout, first half: dq = scale * sum over K tiles of
// dS.K, written once per Q tile.
extern "C" int dftt_flash_attention_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int BH, int S, int D, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, S, causal, scale, st);
  if (D == 32) return launch_dq_d32(q, k, v, dout, lse, delta, dq, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The two-kernel layout, second half: dk = scale * sum over Q tiles of
// dS^T.Q and dv = sum of P^T.dO.
extern "C" int dftt_flash_attention_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int BH, int S, int D, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<false, 64>(q, k, v, dout, lse, delta, dk, dv, nullptr, BH, S, causal, scale, st);
  if (D == 32)
    return launch_dkv_d32(q, k, v, dout, lse, delta, dk, dv, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
