// Prefill attention forward (bf16), writing O and the per-row logsumexp.
//
// Replaces the Pallas TPU kernel of the JAX package
//   distriflow_tpu/ops/flash_attention.py::_fwd_kernel
// (causal or non-causal online-softmax attention with a causal tile skip).
// Two kernels: fwd_kernel<64> at head dim 64 (the flagship's), described
// here, and d32::fwd_kernel at head dim 32 (the JAX LM CLI's model and the
// speculative draft), a design of its own for a kernel that the
// exponentials bound (namespace d32 below). The C entry takes the one of
// q's head dim.
//
// Numeric contract (flash_attention.py:103-159): Q.K^T takes bf16 operands
// with f32 accumulation, the 1/sqrt(D) scale folds in after the product,
// masked scores carry exactly zero mass, p is rounded to bf16 for the PV
// product, the accumulator and m/l stay f32. O is written in bf16; lse =
// m + log(l) is written as a plain f32 [B*H, S] array (the TPU kernel's
// 128-lane replicated copy was a TPU layout artifact). exp is taken as
// exp2 with the scale folded into log2(e) (one f32 rounding apart).
//
// Bound: per (b, h) the work is 4*S^2*D FLOPs (halved when causal) against
// 4*S*D*2 bytes, so from a few hundred positions on the floor is FLOPs over
// the tensor cores' 989 TF/s; the design keeps the tensor cores fed:
//
// - Grid: one block per (b*h, 128-row query tile); blockIdx.x is the head,
//   blockIdx.y counts the query tiles from the last, so the longest causal
//   rows are launched first and the grid does not end in a tail of them.
// - Warp roles: two consumer warpgroups own 64 query rows each; one
//   producer warp issues TMA loads (Q once, then 128-position K and V tiles
//   into a ring of kStages stages with full and empty mbarriers). Rows past
//   S arrive zero-filled from the 3-D tensor map.
// - S = Q.K^T is one wgmma (64 x 128, both operands in shared memory) per
//   K tile into registers. The online softmax runs on the accumulator
//   fragment: row max and sum across the four threads of a row by
//   shuffles, m and l in registers. P is packed to bf16 in registers and is
//   the register A operand of O += P.V (V read MN-major from shared
//   memory); O stays in f32 registers. Nothing goes through shared memory
//   but the TMA tiles.
// - Within a warpgroup, tile t's Q.K^T is issued together with tile t-1's
//   P.V, and tile t's softmax runs while the tensor cores finish that P.V;
//   O is rescaled by tile t's correction once P.V has landed.
// - Masking is applied only to K tiles that cross a warpgroup's diagonal or
//   reach past S; the others run unmasked.
// - Epilogue: O / l is written as bf16 straight from registers, lse = m +
//   log(l) by one thread of each row.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace dftt::hopper;

constexpr int kConsumers = 2;          // warpgroups, 64 query rows each
constexpr int kBQ = 64 * kConsumers;   // query rows per block
constexpr int kBK = 128;               // key positions per K/V tile
constexpr int kStages = 3;
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;
using Pipe = Ring<kStages>;

// The shared-memory layout of head dim D: a Q tile and kStages K and V
// tiles of D-column rows (2 * D bytes each), then the barriers.
template <int D>
struct Shape {
  static_assert(D == 64, "built for head dim 64 (D 32: namespace d32 below)");
  static constexpr int kRow = 2 * D;
  static constexpr uint32_t kQBytes = kBQ * kRow;
  static constexpr uint32_t kKVBytes = kBK * kRow;
  static constexpr size_t kSmemBytes = kSwizzleBytes + kQBytes + 2 * kStages * kKVBytes +
                                       sizeof(uint64_t) * (1 + 3 * kStages);
};

// O (+)= P.V for one k16 step: P in registers, V MN-major in shared memory.
template <int D>
__device__ __forceinline__ void pv_step(float* acc_o, const uint32_t* p_a, uint64_t desc_v) {
  wgmma_m64n64k16_rs<1>(acc_o, p_a, desc_v, 1);
}

// One consumer thread's view of a K tile's scores: rows row0 and row0 + 8
// of its warpgroup's 64 (the first is first_row), columns 8n + col + {0, 1}.
struct Tile {
  int S, causal, first_row, row0, col;
  float scale, scale_log2;

  // The raw scores of the K tile at k0, in acc, become f32 probabilities
  // against the updated running max m (masked ones exactly 0); corr is the
  // factor that rescales the earlier tiles' sums and accumulator, sum this
  // tile's row sums (both across the row's four threads).
  __device__ __forceinline__ void probabilities(float (&acc)[kBK / 2], int k0, float (&m)[2],
                                                float (&corr)[2], float (&sum)[2]) const {
    if (k0 + kBK > S || (causal && k0 + kBK - 1 > first_row)) {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kpos = k0 + 8 * n + col + j;
            if (kpos >= S || (causal && kpos > row0 + 8 * i)) acc[4 * n + 2 * i + j] = -INFINITY;
          }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mx[i] = fmaxf(mx[i], fmaxf(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]));
    float neg_m2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * scale);
      const float safe = m_new <= dftt::kNegInf ? 0.f : m_new;
      corr[i] = m[i] <= dftt::kNegInf ? 0.f : exp2f((m[i] - safe) * kLog2e);
      m[i] = m_new;
      neg_m2[i] = -safe * kLog2e;
      sum[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2f(fmaf(acc[4 * n + 2 * i + j], scale_log2, neg_m2[i]));
          acc[4 * n + 2 * i + j] = p;
          sum[i] += p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, float scale, int causal) {
  using Sh = Shape<D>;
  constexpr int kRow = Sh::kRow;
  constexpr uint32_t kQBytes = Sh::kQBytes, kKVBytes = Sh::kKVBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = aligned_smem(smem_raw);
  unsigned char* k_s = q_s + kQBytes;
  unsigned char* v_s = k_s + kStages * kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  int n_kb = (S + kBK - 1) / kBK;
  // causal: K tiles wholly past this Q tile's last row are fully masked
  if (causal) n_kb = min(n_kb, (q0 + kBQ + kBK - 1) / kBK);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, kQBytes);
      tma_load_rows(q_s, &tm_q, q0, bh, q_full);
      for (int t = 0; t < n_kb; ++t) {
        const int s = Pipe::stage(t);
        mbar_wait(&empty[s], Pipe::empty_parity(t));
        mbar_arrive_expect_tx(&k_full[s], kKVBytes);
        tma_load_rows(k_s + s * kKVBytes, &tm_k, t * kBK, bh, &k_full[s]);
        mbar_arrive_expect_tx(&v_full[s], kKVBytes);
        tma_load_rows(v_s + s * kKVBytes, &tm_v, t * kBK, bh, &v_full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows first_row .. first_row + 63 of the Q tile;
  // this thread holds rows row0 and row0 + 8, columns 8n + col + {0, 1}
  const int wg = warp / 4;
  const int first_row = q0 + 64 * wg;
  const int row0 = first_row + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);

  float acc_o[D / 2], acc_s[kBK / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc_o[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kBK / 2; ++r) acc_s[r] = 0.f;
  float m[2] = {dftt::kNegInf, dftt::kNegInf};
  float l[2] = {0.f, 0.f};
  float corr[2], sum[2];
  uint32_t p_a[kBK / 16][4];
  const Tile tile{S, causal, first_row, row0, col, scale, scale * kLog2e};

  mbar_wait(q_full, 0);
  const uint64_t desc_q = desc_kmajor<kRow>(q_s + 64 * wg * kRow);

  // K tile 0: its scores, then its probabilities
  mbar_wait(&k_full[0], 0);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wgmma_m64n128k16_ss<0>(acc_s, desc_q + kmajor_step(j), desc_kmajor<kRow>(k_s) + kmajor_step(j),
                           j > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc_s);
  tile.probabilities(acc_s, 0, m, corr, sum);
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = sum[i];
  acc_to_a(acc_s, p_a);

  // K tile t's scores run beside tile t-1's P.V; tile t's softmax runs
  // while the tensor cores finish that P.V
  for (int t = 1; t < n_kb; ++t) {
    const int s = Pipe::stage(t), sp = Pipe::stage(t - 1);
    mbar_wait(&k_full[s], Pipe::full_parity(t));
    mbar_wait(&v_full[sp], Pipe::full_parity(t - 1));
    const uint64_t desc_k = desc_kmajor<kRow>(k_s + s * kKVBytes);
    const uint64_t desc_v = desc_mnmajor<kRow>(v_s + sp * kKVBytes);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_m64n128k16_ss<0>(acc_s, desc_q + kmajor_step(j), desc_k + kmajor_step(j), j > 0);
    wgmma_commit();
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) pv_step<D>(acc_o, p_a[c], desc_v + mnmajor_step<kRow>(c));
    wgmma_commit();
    wgmma_wait<1>();  // the scores; P.V may still run
    fence_regs(acc_s);
    tile.probabilities(acc_s, t * kBK, m, corr, sum);
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(p_a);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[sp]);  // this warpgroup is done with tile t-1
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc_o[4 * n + 2 * i] *= corr[i];
        acc_o[4 * n + 2 * i + 1] *= corr[i];
      }
    acc_to_a(acc_s, p_a);
  }

  {  // the last tile's P.V
    const int s = Pipe::stage(n_kb - 1);
    mbar_wait(&v_full[s], Pipe::full_parity(n_kb - 1));
    const uint64_t desc_v = desc_mnmajor<kRow>(v_s + s * kKVBytes);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) pv_step<D>(acc_o, p_a[c], desc_v + mnmajor_step<kRow>(c));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(p_a);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    // a NaN l stays NaN (fmaxf would drop it), as in the plain version
    const float lf = l[i] < 1e-30f ? 1e-30f : l[i];
    __nv_bfloat16* dst = o + (static_cast<int64_t>(bh) * S + row) * D + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(acc_o[4 * n + 2 * i] / lf, acc_o[4 * n + 2 * i + 1] / lf);
    if (lane % 4 == 0)
      lse[static_cast<int64_t>(bh) * S + row] = (m[i] <= dftt::kNegInf ? 0.f : m[i]) + logf(lf);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
           int causal, float scale, cudaStream_t st) {
  constexpr size_t kSmemBytes = Shape<D>::kSmemBytes;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_row_map(&tm_q, q, BH, S, kBQ, D);
  if (!err) err = make_row_map(&tm_k, k, BH, S, kBK, D);
  if (!err) err = make_row_map(&tm_v, v, BH, S, kBK, D);
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes)));
  if (err) return err;
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
  fwd_kernel<D><<<grid, kThreads, kSmemBytes, st>>>(tm_q, tm_k, tm_v,
                                                    static_cast<__nv_bfloat16*>(o),
                                                    static_cast<float*>(lse), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Kernel 1 at head dim 32: the JAX LM CLI's model (d_model 256 over 8
// heads) and the speculative draft. Its path (b), --seq 16384 --remat at
// B 8, runs it 8 times a step at B8 H8 S16384 causal.
//
// At D 32 a (query, key) pair costs 128 tensor-core FLOPs (S and P.V)
// against one exponential, and per SM the special-function units give 16
// exponentials a clock (MUFU.EX2, measured on the H100) against the
// tensor cores' 4096 bf16 FLOPs: the exponentials bound the kernel (2.22
// ms at path (b)'s shape), and the instructions around each one share its
// issue slots. The design follows from that (the D 32 two-kernel
// backward's lessons, namespace d32 of csrc/flash_attention_bwd.cu):
//
// - P = ex2.approx.ftz of the folded argument, one FFMA of s * (scale
//   log2 e) - m log2 e (the form fwd_kernel<64> takes through exp2f,
//   which without fast math is a range-checked sequence around MUFU.EX2:
//   5.5-6.3 SASS instructions a MUFU.EX2 in a run of exponentials against
//   3.4-3.5, and 1.19x the time). A pair costs the FFMA, the MUFU, an FADD
//   (the row sum) and half an F2FP (the bf16 pack of P) in that run, and
//   an FMNMX (the row max) in a pass before it.
// - The elementwise work runs in branch-free passes over the thread's 32
//   pairs of a tile: the mask (only on tiles that cross the warpgroup's
//   diagonal or reach past S; masked scores become -inf, whose ex2 is
//   exactly 0), the row max, then the exponentials with the row sums. The
//   SASS of the exponentials' runs holds no branch.
// - 64-key K/V tiles: S is 32 registers a thread, P 16 and O 16 (90 in
//   all). With 128-key tiles three warpgroups a block (416 threads, which
//   ptxas caps at 128 registers) spilled and took 1.24x the time of the
//   same block with 64-key tiles; two blocks an SM of two warpgroups
//   spilled more (4.4x).
// - Two consumer warpgroups of 64 query rows (128 rows a block, 288
//   threads) and two blocks an SM: four warpgroups an SM take their
//   exponentials while the others wait for their products. Three
//   warpgroups a block (one block an SM) took 1.06x the time, four (one
//   block an SM) 0.99x but 1.3x at B1 H4 S1024, where the grid is a
//   fraction of the card. As in fwd_kernel<64>, tile t's S is issued
//   beside tile t-1's P.V and tile t's softmax runs while that P.V
//   finishes; issuing tile t+1's S before tile t's softmax too (a second S
//   accumulator) spilled and took 5.6x. A ring of 8 stages (4: as fast).
// - A warpgroup walks its K tiles up to its own last row (causal); one
//   whose rows all lie past S walks none. Both wait for each stage they
//   skip before releasing it. blockIdx.y counts the Q tiles from the
//   last, so the longest causal rows start first.
//
// At path (b)'s shape it takes 3.73 ms, 1.68x its bound (the exponentials
// fill 60% of its time), where fwd_kernel<64>'s design built at D 32 took
// 4.92 ms in turns in the same run; at every other D 32 shape of the
// paths it is faster too (tools/d32_fwd_probe.py on the H100 80GB HBM3 at
// 700 W, which builds this source and patched copies, one change each).
//
// The numeric contract is the file's: bf16 operands, f32 sums, the scale
// after Q.K^T, masked pairs exactly 0, P rounded to bf16 only for P.V, l
// summed from the f32 p, a NaN l kept, no atomics.
namespace d32 {

constexpr int D = 32;
constexpr int kRow = 2 * D;                  // 64-byte rows: the 64-byte swizzle
constexpr int kWarpgroups = 2;               // consumer warpgroups, 64 query rows each
constexpr int kBQ = 64 * kWarpgroups;        // query rows a block
constexpr int kBK = 64;                      // key positions a K/V tile
constexpr int kStages = 8;
constexpr int kThreads = 128 * kWarpgroups + 32;  // + the producer warp
// two blocks an SM at two warpgroups (90 registers a thread; at three
// warpgroups one block an SM holds)
constexpr int kMinBlocks = kWarpgroups == 2 ? 2 : 1;
constexpr uint32_t kQBytes = kBQ * kRow;
constexpr uint32_t kKVBytes = kBK * kRow;
constexpr size_t kSmemBytes =
    kSwizzleBytes + kQBytes + 2 * kStages * kKVBytes + sizeof(uint64_t) * (1 + 3 * kStages);
using Pipe = Ring<kStages>;

// 2^x in one MUFU.EX2 (flushing subnormals: p below 2^-126 is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q.K^T for one K tile: two k16 steps, Q and K K-major in shared memory.
__device__ __forceinline__ void scores(float (&acc)[kBK / 2], uint64_t desc_q, uint64_t desc_k) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    if constexpr (kBK == 128)
      wgmma_m64n128k16_ss<0>(acc, desc_q + kmajor_step(j), desc_k + kmajor_step(j), j > 0);
    else
      wgmma_m64n64k16_ss<0>(acc, desc_q + kmajor_step(j), desc_k + kmajor_step(j), j > 0);
  }
}

// O += P.V for one K tile: P the register A operand, V MN-major.
__device__ __forceinline__ void pv(float (&acc_o)[D / 2], const uint32_t (&p_a)[kBK / 16][4],
                                   uint64_t desc_v) {
#pragma unroll
  for (int c = 0; c < kBK / 16; ++c)
    wgmma_m64n32k16_rs<1>(acc_o, p_a[c], desc_v + mnmajor_step<kRow>(c), 1);
}

// One consumer thread's rows row0 and row0 + 8 (register 4n + 2i + j: row
// row0 + 8i, key 8n + col + j of the tile) of its warpgroup's 64, the first
// first_row. The raw scores of the K tile at k0, in acc, become f32
// probabilities against the updated running max m (in scaled units);
// corr rescales the earlier tiles' sums and accumulator, sum is this
// tile's row sums (both across the row's four threads).
struct Tile {
  int S, causal, first_row, row0, col;
  float scale, scale_log2;

  __device__ __forceinline__ void probabilities(float (&acc)[kBK / 2], int k0, float (&m)[2],
                                                float (&corr)[2], float (&sum)[2]) const {
    if (k0 + kBK > S || (causal && k0 + kBK - 1 > first_row)) {
#pragma unroll
      for (int r = 0; r < kBK / 2; ++r) {
        const int kpos = k0 + 8 * (r >> 2) + col + (r & 1);
        if (kpos >= S || (causal && kpos > row0 + 8 * ((r >> 1) & 1))) acc[r] = -INFINITY;
      }
    }
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mx[i][n & 1] = fmaxf(mx[i][n & 1], fmaxf(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]));
    float neg_m2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = fmaxf(mx[i][0], mx[i][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[i], x * scale);
      const float safe = m_new <= dftt::kNegInf ? 0.f : m_new;
      corr[i] = m[i] <= dftt::kNegInf ? 0.f : ex2((m[i] - safe) * kLog2e);
      m[i] = m_new;
      neg_m2[i] = -safe * kLog2e;
    }
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = ex2(fmaf(acc[4 * n + 2 * i + j], scale_log2, neg_m2[i]));
          acc[4 * n + 2 * i + j] = p;
          part[i][n & 1] += p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = part[i][0] + part[i][1];
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks) fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = aligned_smem(smem_raw);
  unsigned char* k_s = q_s + kQBytes;
  unsigned char* v_s = k_s + kStages * kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  int n_kb = (S + kBK - 1) / kBK;
  // causal: K tiles wholly past this Q tile's last row are fully masked
  if (causal) n_kb = min(n_kb, (q0 + kBQ + kBK - 1) / kBK);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kWarpgroups);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kWarpgroups) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, kQBytes);
      tma_load_rows(q_s, &tm_q, q0, bh, q_full);
      for (int t = 0; t < n_kb; ++t) {
        const int s = Pipe::stage(t);
        mbar_wait(&empty[s], Pipe::empty_parity(t));
        mbar_arrive_expect_tx(&k_full[s], kKVBytes);
        tma_load_rows(k_s + s * kKVBytes, &tm_k, t * kBK, bh, &k_full[s]);
        mbar_arrive_expect_tx(&v_full[s], kKVBytes);
        tma_load_rows(v_s + s * kKVBytes, &tm_v, t * kBK, bh, &v_full[s]);
      }
    }
    return;
  }

  // wg is read from lane 0, so the compiler knows it is the same across
  // the warp, and so the loop bounds around the products below
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int first_row = q0 + 64 * wg;
  const int row0 = first_row + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  // this warpgroup's K tiles: up to its last row (causal), none past S
  const int n_mine = first_row >= S ? 0 : causal ? min(n_kb, (first_row + 63) / kBK + 1) : n_kb;

  float acc_o[D / 2], acc_s[kBK / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc_o[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kBK / 2; ++r) acc_s[r] = 0.f;
  float m[2] = {dftt::kNegInf, dftt::kNegInf};
  float l[2] = {0.f, 0.f};
  float corr[2], sum[2];
  uint32_t p_a[kBK / 16][4];
  const Tile tile{S, causal, first_row, row0, col, scale, scale * kLog2e};

  mbar_wait(q_full, 0);
  const uint64_t desc_q = desc_kmajor<kRow>(q_s + 64 * wg * kRow);

  if (n_mine > 0) {
    // K tile 0: its scores, then its probabilities
    mbar_wait(&k_full[0], 0);
    wgmma_fence();
    scores(acc_s, desc_q, desc_kmajor<kRow>(k_s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    tile.probabilities(acc_s, 0, m, corr, sum);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = sum[i];
    acc_to_a(acc_s, p_a);

    // K tile t's scores run beside tile t-1's P.V; tile t's softmax runs
    // while the tensor cores finish that P.V
    for (int t = 1; t < n_mine; ++t) {
      const int s = Pipe::stage(t), sp = Pipe::stage(t - 1);
      mbar_wait(&k_full[s], Pipe::full_parity(t));
      mbar_wait(&v_full[sp], Pipe::full_parity(t - 1));
      wgmma_fence();
      scores(acc_s, desc_q, desc_kmajor<kRow>(k_s + s * kKVBytes));
      wgmma_commit();
      pv(acc_o, p_a, desc_mnmajor<kRow>(v_s + sp * kKVBytes));
      wgmma_commit();
      wgmma_wait<1>();  // the scores; P.V may still run
      fence_regs(acc_s);
      tile.probabilities(acc_s, t * kBK, m, corr, sum);
      wgmma_wait<0>();
      fence_regs(acc_o);
      fence_regs(p_a);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[sp]);  // done with tile t-1
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) acc_o[r] *= corr[(r >> 1) & 1];
      acc_to_a(acc_s, p_a);
    }

    // the last tile's P.V
    const int s = Pipe::stage(n_mine - 1);
    mbar_wait(&v_full[s], Pipe::full_parity(n_mine - 1));
    wgmma_fence();
    pv(acc_o, p_a, desc_mnmajor<kRow>(v_s + s * kKVBytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(p_a);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
  }
  // the block's later tiles: waited for (both loads landed) and released unread
  for (int t = n_mine; t < n_kb; ++t) {
    const int s = Pipe::stage(t);
    mbar_wait(&k_full[s], Pipe::full_parity(t));
    mbar_wait(&v_full[s], Pipe::full_parity(t));
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    // a NaN l stays NaN (fmaxf would drop it), as in the plain version
    const float lf = l[i] < 1e-30f ? 1e-30f : l[i];
    __nv_bfloat16* dst = o + (static_cast<int64_t>(bh) * S + row) * D + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(acc_o[4 * n + 2 * i] / lf, acc_o[4 * n + 2 * i + 1] / lf);
    if (lane % 4 == 0)
      lse[static_cast<int64_t>(bh) * S + row] = (m[i] <= dftt::kNegInf ? 0.f : m[i]) + logf(lf);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
           int causal, float scale, cudaStream_t st) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_row_map(&tm_q, q, BH, S, kBQ, D);
  if (!err) err = make_row_map(&tm_k, k, BH, S, kBK, D);
  if (!err) err = make_row_map(&tm_v, v, BH, S, kBK, D);
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes)));
  if (err) return err;
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
  fwd_kernel<<<grid, kThreads, kSmemBytes, st>>>(tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
                                                 static_cast<float*>(lse), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace d32

}  // namespace

// q, k, v, o: [BH, S, D] bf16 contiguous, 16-byte aligned; lse: [BH, S]
// f32. Launches on `stream`; returns a CUDA error code (0 = launched; a
// tensor map that cannot be encoded returns cudaErrorInvalidValue). Built
// for D = 64 (the flagship's head dim) and D = 32 (the draft's); any other
// D returns cudaErrorInvalidValue.
extern "C" int dftt_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int BH,
    int S, int D, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, o, lse, BH, S, causal, scale, st);
  if (D == 32) return d32::launch(q, k, v, o, lse, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
