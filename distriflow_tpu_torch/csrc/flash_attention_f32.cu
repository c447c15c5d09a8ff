// Attention forward and backward in f32, on the tensor cores in
// split-precision TF32.
//
// Replaces the Pallas TPU kernels of the JAX package on f32 inputs
//   distriflow_tpu/ops/flash_attention.py::_fwd_kernel   (forward: O and lse)
//   distriflow_tpu/ops/flash_attention.py::_dkvq_kernel  (fused: dK, dV, dQ partials)
//   distriflow_tpu/ops/flash_attention.py::_dq_kernel    (two-kernel layout: dQ)
//   distriflow_tpu/ops/flash_attention.py::_dkv_kernel   (two-kernel layout: dK, dV)
// and the sum over the fused kernel's dQ partials that the JAX package
// leaves to XLA (flash_attention.py:605). JAX runs them on f32 inputs for a
// model whose compute dtype is f32 (the LM CLI's --dtype float32: the
// fused layout up to 2048 positions, the two-kernel layout past them, as at
// --seq 16384), with f32 operands and f32 accumulation. Every kernel here
// keeps f32's accuracy. Built for head dims 64 and 32 (template D).
//
// Numeric contract (flash_attention.py:103-159 and 297-336 at f32): the
// scores q.k are summed in f32 and scaled after the sum; masked scores
// carry exactly zero mass; O = sum(p v) / l with the online rescale, lse =
// m + log(l). Backward: P = exp(s * scale - lse), dP = dO.V^T, dS = P (dP -
// delta), dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K, every value f32
// (JAX's casts of P and dS to the input dtype are no-ops at f32).
//
// Split precision (namespace split3). One TF32 pass would keep 10 of f32's
// 23 mantissa bits and fail f32's limits (chip_smoke.py's tf32_plain
// controls). Split precision does not: each operand x is split once per
// tile into big = tf32(x) (cvt.rna) and small = tf32(x - big), where x -
// big is exact in f32, so big + small holds x to about 2^-22 of its
// magnitude; a NaN stays NaN in both parts, so a NaN input reaches the
// outputs as in the plain version. Each product a.b is three tensor-core
// products, a_small.b_big + a_big.b_small + a_big.b_big, summed in f32;
// the dropped a_small.b_small is of the same order. The tensor cores
// truncate each mma's f32 sum (on the H100 an exact sum 1.75 ulp above 1
// comes out 1 ulp above: tools/f32_dq_limit_probe.py), so no sum runs long
// in one accumulator: the forward's S and the fused backward's five
// products take a fresh accumulator for each 8-wide k-step (3 mma), added
// in f32 on the CUDA cores (the fused kernel's S and dP with one
// accumulator of 24 mma at D 64 put dQ 9.9e-6 from its f64 recipe, with a
// fresh one a k-step 1.9e-6: tools/f32_fused_bwd_probe.py); the two-kernel
// layout's S and dP take one accumulator (at most 24 mma), its dK and dV
// and the forward's O a fresh one for each streamed tile, rescaled and
// added to the running sum in f32. The two-kernel dQ kernel runs dQ += dS K
// so and keeps S and dP as FFMA sums over d in order, as the plain
// version's f32 products take them: its limit (atol 1e-6 against the plain
// version) tracks the cancellation in dP - delta to within the plain
// version's own rounding of dP, and at B8 H8 S16384 D32 a recipe with dP
// split falls outside it, and so does the exact (f64) recipe
// (tools/f32_dq_limit_probe.py). So dQ, of the fused kernel as of the dQ
// kernel, is held against the f64 recipe, which shares no f32 rounding with
// either, at atol 7e-6 (chip_smoke.py's flash_attention_dq_f32_exact); the
// fused kernel's dK and dV against the plain version at atol 8e-6, its S
// and dP split as well (chip_smoke.py's TOL notes). Everything else stays
// f32 on the CUDA cores: the scale after the sum, expf, the masks (masked
// scores carry exactly zero mass), the online softmax, P (dP - delta).
// The forward's limit (atol 1e-6 + rtol 1e-5 of the plain version) holds
// with both its products split: at the JAX LM CLI's path (d) shape, B8 H8
// S16384 D32 causal, the recipe with S and P V split needs atol 5.1e-7
// for O, at B8 H8 S512 D64 7.4e-7, where one TF32 pass needs 1.2e-3 to
// 1.8e-3 (tools/f32_fwd_limit_probe.py on the H100; the recipe sums each
// product in f32 without the tensor cores' truncation).
//
// Route: mma.sync.m16n8k8 tf32, fragments read from padded shared memory.
// wgmma takes tf32 operands only K-major, and three of the products (dS K,
// P^T dO, dS^T Q) read their B operand MN-major; mma.sync reads any
// layout, and its accumulator layout is the A layout of the next product
// once the k index is permuted (key 2t in A column t, key 2t + 1 in column
// t + 4, with B's rows to match), so the forward takes P and the dK/dV
// products P^T and dS^T from accumulators to A fragments in registers; the
// dQ products read dS from shared memory (the dQ kernel a warp-private
// tile, the fused kernel one tile a block). A block of 8 warps (the fused
// kernel's: 4) owns 16 resident rows a warp (forward: the queries, Q split
// once into A fragments in registers; dQ: the queries, with Q and dO; dK/dV
// and fused: the keys, with K and V, split into big and small in shared
// memory once); the streamed tiles (the forward's K and V, 64 rows; the dQ
// kernel's K and V, 64 rows at D 32 and 32 at D 64; the dK/dV kernel's Q,
// dO, lse and delta, 32 rows; the fused kernel's, 32 rows at D 32 and 16
// at D 64, so that two of its blocks share an SM) come through a ring of
// two stages by cp.async (16-byte copies, rows past S zero-filled), each
// split once it has landed. Rows are padded to D + 4 floats, so every
// fragment load hits distinct banks. O and lse, dQ, dK and dV are written
// once at the end, the fused kernel's dQ partials once per (key block, Q
// tile) into dqp and summed by a second kernel in ascending key block: no
// atomics, so every launch gives the same bits.
//
// Bound: per (b, h) the forward does 4 S^2 D FLOPs, the fused backward 10
// S^2 D, the dQ kernel 6 S^2 D and the dK/dV kernel 8 S^2 D (halved when
// causal) against 4 S D, 7 S D, 5 S D and 6 S D f32 values moved, so from
// a few dozen positions on the floor is operations. Split precision runs
// three TF32 products for each f32 one at 495 TFLOP/s: 165 TFLOP/s of
// f32-accurate products, the rate that bounds every function here. At B8
// H8 S16384 D32 causal the forward's bound is 6.66 ms, the dK/dV bound
// 13.33 ms and the dQ bound 9.99 ms (16.41, 32.82 and 24.62 at the FFMA
// peak of 67 TFLOP/s); the fused backward's at B8 H8 S512 D32 causal
// 0.0163 ms (0.0401 at the FFMA peak). The dQ kernel runs two of its three
// products (S, dP) as FFMA, so the work as it runs it takes at least 19.74
// ms; it keeps them there for its limit, as above. Their times stand
// beside their bounds in PERF.md.

#include <cstdint>

#include "common.cuh"

namespace {

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// The two-kernel backward in split-precision TF32 (see the note at the top).
namespace split3 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kM = 16 * kWarps;  // a block's resident rows, 16 a warp

// The streamed tile's rows of the dQ kernel (keys) and of the dK/dV
// kernel (queries), and the padded row of every tile in shared memory (D +
// 4 words: fragment loads hit distinct banks, rows stay 16-byte aligned for
// cp.async). At D 32 the dK/dV kernel's 32-row tiles let two blocks share
// an SM (110 KB each, 128 registers), which ran faster on the H100 at B8
// H8 S16384; the dQ kernel gained nothing from two.
template <int D>
constexpr int kDqTileRows = D == 32 ? 64 : 32;
constexpr int kDkvTileRows = 32;
template <int D>
constexpr int kDkvBlocks = D == 32 ? 2 : 1;
template <int D>
constexpr int kPitch = D + 4;
// The forward's streamed tile of keys (with their values), and its blocks
// an SM: at D 32 two (128 registers, 90 KB each, under 100 bytes of spill)
// ran 1.4x faster than one on the H100 at B8 H8 S16384.
constexpr int kFwdKeys = 64;
template <int D>
constexpr int kFwdBlocks = D == 32 ? 2 : 1;

// The forward's shared memory: Q's [kM] rows, then two stages of four
// [kFwdKeys] tiles (K big and small, V big and small).
template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(uint32_t) * kPitch<D> * (kM + 2 * 4 * kFwdKeys);
}

// Shared memory of either kernel: four resident [kM] tiles and two stages
// of four streamed [kN] tiles (big and small of two tensors), plus two
// stages of kN lse and kN delta values (the dK/dV kernel's).
template <int D, int kN>
constexpr size_t smem_bytes() {
  return sizeof(uint32_t) * (kPitch<D> * (4 * kM + 2 * 4 * kN) + 2 * 2 * kN);
}

// x rounded to TF32 (to nearest, ties away from zero); a NaN stays a NaN.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to about 2^-22 |x|; x - big is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(__fsub_rn(x, __uint_as_float(big)));
}

// d += a.b on the tensor cores: a [16 x 8] row-major, b [8 x 8] column-major.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B fragment: tile[off] and tile[off + step], step 4 (k along a row) or
// a row's pitch (k down the rows).
struct FragB {
  uint32_t x[2];
};
__device__ __forceinline__ FragB frag_b(const uint32_t* tile, int off, int step) {
  return {{tile[off], tile[off + step]}};
}

__device__ __forceinline__ void zero(float (&d)[4]) { d[0] = d[1] = d[2] = d[3] = 0.f; }

// d += a.b for one 8-wide k-step in split precision, on the tensor cores:
// the small cross terms first, then big.big.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], FragB bb, FragB bs) {
  mma(d, as, bb.x[0], bb.x[1]);
  mma(d, ab, bs.x[0], bs.x[1]);
  mma(d, ab, bb.x[0], bb.x[1]);
}

// acc += a.b for one k-step as mma3 does, in a fresh accumulator added to
// acc in f32 on the CUDA cores: the tensor cores sum 24 products at most.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], FragB bb, FragB bs) {
  float d[4];
  zero(d);
  mma3(d, ab, as, bb, bs);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// A fragment of rows row, row + 8 and columns col, col + 4 of a padded tile.
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint32_t* tile, int row, int col) {
  a[0] = tile[row * P + col];
  a[1] = tile[(row + 8) * P + col];
  a[2] = tile[row * P + col + 4];
  a[3] = tile[(row + 8) * P + col + 4];
}

// An accumulator [16 rows x 8 columns] as the split A fragment of the next
// product, its columns in the permuted k order (2t in column t, 2t + 1 in
// column t + 4).
__device__ __forceinline__ void acc_to_a(const float (&c)[4], uint32_t (&ab)[4],
                                         uint32_t (&as)[4]) {
  split(c[0], ab[0], as[0]);
  split(c[2], ab[1], as[1]);
  split(c[1], ab[2], as[2]);
  split(c[3], ab[3], as[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(__cvta_generic_to_global(src)), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(__cvta_generic_to_global(src)), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [r0, r0 + Rows) of a [S, D] f32 slice into a padded tile by
// cp.async, by a block of Threads threads; rows past S are zero-filled.
template <int D, int Rows, int Threads = kThreads>
__device__ __forceinline__ void stage(uint32_t* dst, const float* __restrict__ src, int r0, int S) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < Rows * kChunks; e += Threads) {
    const int r = e / kChunks, c = 4 * (e % kChunks);
    const bool in = r0 + r < S;
    cp_async16(dst + r * kPitch<D> + c, src + (in ? static_cast<int64_t>(r0 + r) * D + c : 0), in);
  }
}

// A landed tile split into big and small (src may be big: in place).
template <int D, int Rows, int Threads = kThreads>
__device__ __forceinline__ void split_tile(const uint32_t* src, uint32_t* big, uint32_t* small) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < Rows * kChunks; e += Threads) {
    const int off = (e / kChunks) * kPitch<D> + 4 * (e % kChunks);
    const uint4 x = *reinterpret_cast<const uint4*>(src + off);
    uint4 b, s;
    split(__uint_as_float(x.x), b.x, s.x);
    split(__uint_as_float(x.y), b.y, s.y);
    split(__uint_as_float(x.z), b.z, s.z);
    split(__uint_as_float(x.w), b.w, s.w);
    *reinterpret_cast<uint4*>(big + off) = b;
    *reinterpret_cast<uint4*>(small + off) = s;
  }
}

// The tiles of both kernels' shared memory: four resident [kM] tiles, four
// [kN] tiles a stage, then each stage's lse and delta (the dK/dV kernel's).
template <int D, int kN>
struct Smem {
  static constexpr int kP = kPitch<D>;
  uint32_t* base;
  __device__ uint32_t* resident(int i) const { return base + i * kM * kP; }
  __device__ uint32_t* streamed(int st, int i) const {
    return base + 4 * kM * kP + (st * 4 + i) * kN * kP;
  }
  __device__ float* rowvec(int st, int i) const {
    return reinterpret_cast<float*>(base + 4 * kM * kP + 8 * kN * kP) + (st * 2 + i) * kN;
  }
};

// dQ: one block per (b*h, 128-row Q tile); blockIdx.y counts the Q tiles
// from the last, so the longest causal rows start first. Warp w owns rows
// 16 w .. 16 w + 15 of the tile. S and dP are FFMA sums over d in order,
// as the plain version's f32 products take them: a lane holds the rows
// rg + 4 i and the keys kg + 8 i' of its warp's tile (rg = lane / 8, kg =
// lane % 8), so a 16-byte shared-memory load of a Q or dO row serves a
// quarter-warp, and the eight keys a quarter-warp loads hit distinct
// banks. dS goes through the warp's own [16 x (kN + 8)] tile into mma A
// fragments; in dQ's accumulators a lane holds rows g and g + 8 (g =
// lane / 4) and columns 2t and 2t + 1 (t = lane % 4) of every 8 columns.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int S, float scale, int causal) {
  constexpr int kP = kPitch<D>, kN = kDqTileRows<D>;
  constexpr int kT = kN / 8;    // a lane's keys in the FFMA layout; k-steps of dS.K
  constexpr int kD = D / 8;     // n-tiles of dS.K
  constexpr int kSP = kN + 8;   // a row of a warp's dS tile (LDS.64 of a fragment pair: no conflicts)
  static_assert(kWarps * 16 * kSP <= 2 * kM * kP, "dS tiles overflow their slot");
  extern __shared__ __align__(16) uint32_t split_smem[];
  const Smem<D, kN> sm{split_smem};
  // resident: Q and dO rows (f32), then the warps' dS tiles; each stage:
  // K (f32, big, small) and V (f32)
  const float* qr = reinterpret_cast<const float*>(sm.resident(0));
  const float* orow = reinterpret_cast<const float*>(sm.resident(1));

  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, kg = lane % 8, g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;
  float* ds_w = reinterpret_cast<float*>(sm.resident(2)) + warp * 16 * kSP;
  int n_kt = (S + kN - 1) / kN;
  // causal: key tiles wholly past this Q tile's last row are fully masked
  if (causal) n_kt = min(n_kt, (r0 + kM + kN - 1) / kN);

  stage<D, kM>(sm.resident(0), q + base, r0, S);
  stage<D, kM>(sm.resident(1), dout + base, r0, S);
  stage<D, kN>(sm.streamed(0, 0), k + base, 0, S);
  stage<D, kN>(sm.streamed(0, 3), v + base, 0, S);
  cp_commit();
  int row[4];
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = r0 + wr + rg + 4 * i;
    lse_r[i] = row[i] < S ? lse[static_cast<int64_t>(bh) * S + row[i]] : 0.f;
    delta_r[i] = row[i] < S ? delta[static_cast<int64_t>(bh) * S + row[i]] : 0.f;
  }
  float acc[kD][4];
#pragma unroll
  for (int n = 0; n < kD; ++n) zero(acc[n]);

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1, c0 = it * kN;
    if (it + 1 < n_kt) {
      stage<D, kN>(sm.streamed(st ^ 1, 0), k + base, c0 + kN, S);
      stage<D, kN>(sm.streamed(st ^ 1, 3), v + base, c0 + kN, S);
    }
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    const float* kr = reinterpret_cast<const float*>(sm.streamed(st, 0));
    const float* vr = reinterpret_cast<const float*>(sm.streamed(st, 3));
    const uint32_t *kb = sm.streamed(st, 1), *ks = sm.streamed(st, 2);
    split_tile<D, kN>(sm.streamed(st, 0), sm.streamed(st, 1), sm.streamed(st, 2));

    // S = Q K^T and dP = dO V^T, each element an FFMA chain over d = 0 .. D - 1
    float s[4][kT], dp[4][kT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {  // four d a 16-byte load, each chain in order
      float4 qd[4], od[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qd[i] = *reinterpret_cast<const float4*>(qr + (wr + rg + 4 * i) * kP + d);
        od[i] = *reinterpret_cast<const float4*>(orow + (wr + rg + 4 * i) * kP + d);
      }
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const float4 kd = *reinterpret_cast<const float4*>(kr + (kg + 8 * j) * kP + d);
        const float4 vd = *reinterpret_cast<const float4*>(vr + (kg + 8 * j) * kP + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qd[i].x, kd.x, s[i][j]);
          s[i][j] = fmaf(qd[i].y, kd.y, s[i][j]);
          s[i][j] = fmaf(qd[i].z, kd.z, s[i][j]);
          s[i][j] = fmaf(qd[i].w, kd.w, s[i][j]);
          dp[i][j] = fmaf(od[i].x, vd.x, dp[i][j]);
          dp[i][j] = fmaf(od[i].y, vd.y, dp[i][j]);
          dp[i][j] = fmaf(od[i].z, vd.z, dp[i][j]);
          dp[i][j] = fmaf(od[i].w, vd.w, dp[i][j]);
        }
      }
    }
    // dS = P (dP - delta), P = exp(s * scale - lse) rounded as the plain
    // version rounds it, masked pairs 0, into the warp's dS tile
    const bool edge = c0 + kN > S || r0 + wr + 16 > S || (causal && c0 + kN - 1 > r0 + wr);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const int key = c0 + kg + 8 * j;
        float p = expf(__fsub_rn(__fmul_rn(s[i][j], scale), lse_r[i]));
        if (edge && (row[i] >= S || key >= S || (causal && key > row[i]))) p = 0.f;
        ds_w[(rg + 4 * i) * kSP + kg + 8 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();  // the warps' dS tiles, and every lane's split of K
    // dQ += dS K over the tile's keys on the tensor cores, the k index
    // permuted (key 2t in A column t, 2t + 1 in column t + 4)
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const float2 lo = *reinterpret_cast<const float2*>(ds_w + g * kSP + 8 * j + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(ds_w + (g + 8) * kSP + 8 * j + 2 * t);
      const float c[4] = {lo.x, lo.y, hi.x, hi.y};
      uint32_t ab[4], as[4];
      acc_to_a(c, ab, as);
#pragma unroll
      for (int n = 0; n < kD; ++n) {
        const int off = (8 * j + 2 * t) * kP + 8 * n + g;
        mma3_add(acc[n], ab, as, frag_b(kb, off, kP), frag_b(ks, off, kP));
      }
    }
    __syncthreads();  // every warp is done with this stage and its dS tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int out = r0 + wr + g + 8 * i;
    if (out >= S) continue;
    float* dst = dq + base + static_cast<int64_t>(out) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kD; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// dK and dV: one block per (b*h, 128-key K/V tile), in ascending order (the
// longest causal walks first). Warp w owns keys 16 w .. 16 w + 15; the
// streamed tiles are the queries, with their dO, lse and delta.
template <int D>
__global__ void __launch_bounds__(kThreads, kDkvBlocks<D>) dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
    float scale, int causal) {
  constexpr int kP = kPitch<D>, kN = kDkvTileRows;
  constexpr int kT = kN / 8;  // n-tiles of S^T and dP^T; k-steps of P^T dO and dS^T Q
  constexpr int kD = D / 8;   // k-steps of S^T and dP^T; n-tiles of P^T dO and dS^T Q
  extern __shared__ __align__(16) uint32_t split_smem[];
  const Smem<D, kN> sm{split_smem};
  uint32_t *kb = sm.resident(0), *ks = sm.resident(1), *vb = sm.resident(2), *vs = sm.resident(3);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kM;
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const float* lse_bh = lse + static_cast<int64_t>(bh) * S;
  const float* delta_bh = delta + static_cast<int64_t>(bh) * S;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int wr = 16 * warp;
  // causal: Q tiles wholly before this K tile see none of it
  const int qt0 = causal ? k0 / kN : 0;
  const int n_qt = (S + kN - 1) / kN;

  auto stage_q = [&](int st, int q0) {
    stage<D, kN>(sm.streamed(st, 0), q + base, q0, S);
    stage<D, kN>(sm.streamed(st, 2), dout + base, q0, S);
    for (int e = threadIdx.x; e < 2 * kN; e += kThreads) {
      const int r = e % kN;
      const bool in = q0 + r < S;
      cp_async4(sm.rowvec(st, e / kN) + r, (e < kN ? lse_bh : delta_bh) + (in ? q0 + r : 0), in);
    }
  };
  stage<D, kM>(kb, k + base, k0, S);
  stage<D, kM>(vb, v + base, k0, S);
  stage_q(0, qt0 * kN);
  cp_commit();
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + wr + g + 8 * i;
  float acc_dk[kD][4], acc_dv[kD][4];
#pragma unroll
  for (int n = 0; n < kD; ++n) {
    zero(acc_dk[n]);
    zero(acc_dv[n]);
  }

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1, q0 = qt * kN;
    if (qt + 1 < n_qt) stage_q(st ^ 1, q0 + kN);
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    if (qt == qt0) {
      split_tile<D, kM>(kb, kb, ks);
      split_tile<D, kM>(vb, vb, vs);
    }
    const uint32_t *qtb = sm.streamed(st, 0), *qts = sm.streamed(st, 1);
    const uint32_t *otb = sm.streamed(st, 2), *ots = sm.streamed(st, 3);
    const float *lse_s = sm.rowvec(st, 0), *delta_s = sm.rowvec(st, 1);
    split_tile<D, kN>(sm.streamed(st, 0), sm.streamed(st, 0), sm.streamed(st, 1));
    split_tile<D, kN>(sm.streamed(st, 2), sm.streamed(st, 2), sm.streamed(st, 3));
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys and the tile's queries
    float s[kT][4], dp[kT][4];
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      zero(s[j]);
      zero(dp[j]);
    }
#pragma unroll
    for (int kk = 0; kk < kD; ++kk) {
      uint32_t kab[4], kas[4], vab[4], vas[4];
      load_a<kP>(kab, kb, wr + g, 8 * kk + t);
      load_a<kP>(kas, ks, wr + g, 8 * kk + t);
      load_a<kP>(vab, vb, wr + g, 8 * kk + t);
      load_a<kP>(vas, vs, wr + g, 8 * kk + t);
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const int off = (8 * j + g) * kP + 8 * kk + t;
        mma3(s[j], kab, kas, frag_b(qtb, off, 4), frag_b(qts, off, 4));
        mma3(dp[j], vab, vas, frag_b(otb, off, 4), frag_b(ots, off, 4));
      }
    }
    // P^T into s and dS^T = P^T (dP^T - delta) into dp, masked pairs 0
    const bool edge = q0 + kN > S || k0 + wr + 16 > S || (causal && q0 < k0 + wr + 15);
#pragma unroll
    for (int j = 0; j < kT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qi = 8 * j + 2 * t + (e & 1), query = q0 + qi;
        float p = expf(__fsub_rn(__fmul_rn(s[j][e], scale), lse_s[qi]));
        if (edge && (query >= S || key[i] >= S || (causal && query < key[i]))) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_s[qi]);
      }
    }
    // dV += P^T dO and dK += dS^T Q over the tile's queries, each in a fresh
    // accumulator added to the running sum in f32
    float pv[kD][4], pk[kD][4];
#pragma unroll
    for (int n = 0; n < kD; ++n) {
      zero(pv[n]);
      zero(pk[n]);
    }
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      uint32_t pab[4], pas[4], dab[4], das[4];
      acc_to_a(s[j], pab, pas);
      acc_to_a(dp[j], dab, das);
#pragma unroll
      for (int n = 0; n < kD; ++n) {
        const int off = (8 * j + 2 * t) * kP + 8 * n + g;
        mma3(pv[n], pab, pas, frag_b(otb, off, kP), frag_b(ots, off, kP));
        mma3(pk[n], dab, das, frag_b(qtb, off, kP), frag_b(qts, off, kP));
      }
    }
#pragma unroll
    for (int n = 0; n < kD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_dv[n][e] += pv[n][e];
        acc_dk[n][e] += pk[n][e];
      }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
    const int64_t off = base + static_cast<int64_t>(key[i]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kD; ++n) {
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(acc_dk[n][2 * i] * scale, acc_dk[n][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(acc_dv[n][2 * i], acc_dv[n][2 * i + 1]);
    }
  }
}

// The fused backward's block by head dim: kWarps warps own 16 keys each
// (the block's resident keys, with their values), and the queries come in
// streamed tiles of kRows. At B8 H8 S512 causal on the H100
// (tools/f32_fused_bwd_probe.py), 64 keys (two blocks an SM, 207 and 227
// registers) took 0.1034 ms at D 32 and 0.1910 at D 64, against 0.1210
// and 0.2235 for 128 keys (8 warps, one block an SM) and 0.1313 and
// 0.2390 for 32; 16-query tiles at D 32 took 0.1185 (at D 64 32 rows
// would leave one block an SM).
template <int D>
struct FusedShape;
template <>
struct FusedShape<32> {
  static constexpr int kWarps = 4, kRows = 32;
};
template <>
struct FusedShape<64> {
  static constexpr int kWarps = 4, kRows = 16;
};

// The fused backward's shared memory, in words: K and V (big and small)
// for the block's keys, two stages of the streamed Q and dO (big and
// small) and their lse and delta, and the tile's dS (big and small), one
// row a query padded to keys + 8 words (8-byte fragment loads hit
// distinct banks).
template <int D, int kW, int kN>
constexpr size_t fused_smem_bytes() {
  return sizeof(uint32_t) *
         (kPitch<D> * (4 * 16 * kW + 2 * 4 * kN) + 2 * 2 * kN + 2 * kN * (16 * kW + 8));
}

// Blocks an SM for the shared memory (228 KB an SM, 1 KB of it a block's).
template <int D, int kW, int kN>
constexpr int kFusedBlocks = 2 * (fused_smem_bytes<D, kW, kN>() + 1024) <= 233472 ? 2 : 1;

// The fused backward: dK, dV and the dQ partials, one block per (b*h,
// block of 16 kW keys), in ascending order (the longest causal walks
// first). Warp w owns keys 16 w .. 16 w + 15; the Q tiles stream as in
// dkv_kernel and each runs S^T and dP^T, then dV += P^T dO and dK +=
// dS^T Q from the accumulators, as there. Each warp also writes its keys'
// dS^T, split, into the block's [kN queries x keys] dS tile; after one
// barrier the warps share the tile's dQ partial dS K over the block's keys
// (m16 x n8 output tiles, kPer a warp, each 8-key k-step in a fresh
// accumulator added in f32), written once into dqp[block, bh, q, :].
template <int D, int kW, int kN>
__global__ void __launch_bounds__(32 * kW, (kFusedBlocks<D, kW, kN>)) bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dqp, int S, float scale, int causal) {
  constexpr int kT = 32 * kW;      // threads
  constexpr int kKeys = 16 * kW;   // the block's keys
  constexpr int kP = kPitch<D>;
  constexpr int kSP = kKeys + 8;   // a row of the dS tile
  constexpr int kTn = kN / 8;      // n-tiles of S^T and dP^T; k-steps of P^T dO and dS^T Q
  constexpr int kD = D / 8;        // k-steps of S^T and dP^T; n-tiles of the other products
  constexpr int kPer = (kN / 16) * kD / kW;  // the warp's m16 x n8 tiles of the dQ partial
  static_assert(kPer >= 1 && (kN / 16) * kD % kW == 0 && kD % kPer == 0,
                "the dQ partial's tiles must share out evenly, a warp's in one row of tiles");
  extern __shared__ __align__(16) uint32_t split_smem[];
  uint32_t* const kb = split_smem;
  uint32_t* const ks = kb + kKeys * kP;
  uint32_t* const vb = ks + kKeys * kP;
  uint32_t* const vs = vb + kKeys * kP;
  // each stage: Q (f32, then big), Q small, dO (f32, then big), dO small
  auto streamed = [&](int st, int i) { return split_smem + 4 * kKeys * kP + (st * 4 + i) * kN * kP; };
  float* const rowvec = reinterpret_cast<float*>(split_smem + 4 * kKeys * kP + 8 * kN * kP);
  uint32_t* const dsb = split_smem + 4 * kKeys * kP + 8 * kN * kP + 4 * kN;
  uint32_t* const dss = dsb + kN * kSP;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const float* lse_bh = lse + static_cast<int64_t>(bh) * S;
  const float* delta_bh = delta + static_cast<int64_t>(bh) * S;
  float* const dqp_blk = dqp + (static_cast<int64_t>(blockIdx.y) * gridDim.x + bh) * S * D;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int wr = 16 * warp;
  // the warp's dQ tiles: rows 16 pm .., columns 8 (pn + i) ..
  const int pm = warp * kPer / kD, pn = warp * kPer % kD;
  // causal: Q tiles wholly before this block's keys see none of them
  const int qt0 = causal ? k0 / kN : 0;
  const int n_qt = (S + kN - 1) / kN;

  auto stage_q = [&](int st, int q0) {
    stage<D, kN, kT>(streamed(st, 0), q + base, q0, S);
    stage<D, kN, kT>(streamed(st, 2), dout + base, q0, S);
    for (int e = threadIdx.x; e < 2 * kN; e += kT) {
      const int r = e % kN;
      const bool in = q0 + r < S;
      cp_async4(rowvec + (st * 2 + e / kN) * kN + r, (e < kN ? lse_bh : delta_bh) + (in ? q0 + r : 0),
                in);
    }
  };
  stage<D, kKeys, kT>(kb, k + base, k0, S);
  stage<D, kKeys, kT>(vb, v + base, k0, S);
  stage_q(0, qt0 * kN);
  cp_commit();
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + wr + g + 8 * i;
  float acc_dk[kD][4], acc_dv[kD][4];
#pragma unroll
  for (int n = 0; n < kD; ++n) {
    zero(acc_dk[n]);
    zero(acc_dv[n]);
  }

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1, q0 = qt * kN;
    if (qt + 1 < n_qt) stage_q(st ^ 1, q0 + kN);
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    if (qt == qt0) {
      split_tile<D, kKeys, kT>(kb, kb, ks);
      split_tile<D, kKeys, kT>(vb, vb, vs);
    }
    const uint32_t *qtb = streamed(st, 0), *qts = streamed(st, 1);
    const uint32_t *otb = streamed(st, 2), *ots = streamed(st, 3);
    const float *lse_s = rowvec + st * 2 * kN, *delta_s = lse_s + kN;
    split_tile<D, kN, kT>(streamed(st, 0), streamed(st, 0), streamed(st, 1));
    split_tile<D, kN, kT>(streamed(st, 2), streamed(st, 2), streamed(st, 3));
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys and the tile's
    // queries, each k-step in a fresh accumulator added in f32 (with one
    // accumulator of all D / 8 k-steps, dQ at D 64 needed 9.9e-6 against
    // its f64 recipe on the H100, the recipe without the tensor cores'
    // truncation 3.0e-6)
    float s[kTn][4], dp[kTn][4];
#pragma unroll
    for (int j = 0; j < kTn; ++j) {
      zero(s[j]);
      zero(dp[j]);
    }
#pragma unroll
    for (int kk = 0; kk < kD; ++kk) {
      uint32_t kab[4], kas[4], vab[4], vas[4];
      load_a<kP>(kab, kb, wr + g, 8 * kk + t);
      load_a<kP>(kas, ks, wr + g, 8 * kk + t);
      load_a<kP>(vab, vb, wr + g, 8 * kk + t);
      load_a<kP>(vas, vs, wr + g, 8 * kk + t);
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const int off = (8 * j + g) * kP + 8 * kk + t;
        mma3_add(s[j], kab, kas, frag_b(qtb, off, 4), frag_b(qts, off, 4));
        mma3_add(dp[j], vab, vas, frag_b(otb, off, 4), frag_b(ots, off, 4));
      }
    }
    // P^T into s and dS^T = P^T (dP^T - delta) into dp, masked pairs 0
    const bool edge = q0 + kN > S || k0 + wr + 16 > S || (causal && q0 < k0 + wr + 15);
#pragma unroll
    for (int j = 0; j < kTn; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qi = 8 * j + 2 * t + (e & 1), query = q0 + qi;
        float p = expf(__fsub_rn(__fmul_rn(s[j][e], scale), lse_s[qi]));
        if (edge && (query >= S || key[i] >= S || (causal && query < key[i]))) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_s[qi]);
      }
    }
    // dV += P^T dO and dK += dS^T Q over the tile's queries, each in a fresh
    // accumulator added to the running sum in f32; the split dS^T also goes
    // into the dS tile, query by query: element (key, query) of the
    // accumulator at [query][key]
    float pv[kD][4], pk[kD][4];
#pragma unroll
    for (int n = 0; n < kD; ++n) {
      zero(pv[n]);
      zero(pk[n]);
    }
#pragma unroll
    for (int j = 0; j < kTn; ++j) {
      uint32_t pab[4], pas[4], dab[4], das[4];
      acc_to_a(s[j], pab, pas);
      acc_to_a(dp[j], dab, das);
      // acc_to_a's order: (key g, query 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (8 * j + 2 * t + (e >> 1)) * kSP + wr + g + 8 * (e & 1);
        dsb[at] = dab[e];
        dss[at] = das[e];
      }
#pragma unroll
      for (int n = 0; n < kD; ++n) {
        const int off = (8 * j + 2 * t) * kP + 8 * n + g;
        mma3(pv[n], pab, pas, frag_b(otb, off, kP), frag_b(ots, off, kP));
        mma3(pk[n], dab, das, frag_b(qtb, off, kP), frag_b(qts, off, kP));
      }
    }
#pragma unroll
    for (int n = 0; n < kD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_dv[n][e] += pv[n][e];
        acc_dk[n][e] += pk[n][e];
      }
    __syncthreads();  // the dS tile is whole, and every warp is done with this stage

    // the tile's dQ partial dS K over the block's keys, the k index permuted
    // (key 2t in A column t, 2t + 1 in column t + 4; K's rows read in that
    // order), each k-step in a fresh accumulator: the tensor cores sum 24
    // products at most
    float dq[kPer][4];
#pragma unroll
    for (int i = 0; i < kPer; ++i) zero(dq[i]);
#pragma unroll 4
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      const int a_off = (16 * pm + g) * kSP + 8 * kk + 2 * t;
      const uint2 lb = *reinterpret_cast<const uint2*>(dsb + a_off);
      const uint2 hb = *reinterpret_cast<const uint2*>(dsb + a_off + 8 * kSP);
      const uint2 ls = *reinterpret_cast<const uint2*>(dss + a_off);
      const uint2 hs = *reinterpret_cast<const uint2*>(dss + a_off + 8 * kSP);
      const uint32_t ab[4] = {lb.x, hb.x, lb.y, hb.y}, as[4] = {ls.x, hs.x, ls.y, hs.y};
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int off = (8 * kk + 2 * t) * kP + 8 * (pn + i) + g;
        mma3_add(dq[i], ab, as, frag_b(kb, off, kP), frag_b(ks, off, kP));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * pm + g + 8 * r;
      if (row >= S) continue;
      float* dst = dqp_blk + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        *reinterpret_cast<float2*>(dst + 8 * (pn + i)) = make_float2(dq[i][2 * r], dq[i][2 * r + 1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
    const int64_t off = base + static_cast<int64_t>(key[i]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kD; ++n) {
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(acc_dk[n][2 * i] * scale, acc_dk[n][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(acc_dv[n][2 * i], acc_dv[n][2 * i + 1]);
    }
  }
}

// The KV blocks whose dQ partial the fused kernel writes for query row
// `row`: all of them unless causal, else those that start at or before it.
// The second pass reads exactly these.
__device__ __forceinline__ int live_kv_blocks(int row, int S, int keys, int causal) {
  const int n_kv = (S + keys - 1) / keys;
  return causal && row / keys + 1 < n_kv ? row / keys + 1 : n_kv;
}

// The fused backward's second pass: dq = scale * sum of dqp[j] over the
// live KV blocks j of each row, in ascending j; one thread an element (n =
// B*H * S * D).
__global__ void __launch_bounds__(256) dq_sum_kernel(const float* __restrict__ dqp,
                                                     float* __restrict__ dq, int64_t n, int S,
                                                     int D, int keys, float scale, int causal) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int stop = live_kv_blocks(static_cast<int>((i / D) % S), S, keys, causal);
  float acc = dqp[i];
  for (int j = 1; j < stop; ++j) acc += dqp[i + j * n];
  dq[i] = acc * scale;
}

// The forward: one block per (b*h, 128-row Q tile); blockIdx.y counts the
// Q tiles from the last, so the longest causal rows start first. Warp w
// owns query rows 16 w .. 16 w + 15: its Q, split once into big and small,
// stays in registers as A fragments. The 64-key K and V tiles come through
// the ring, each split once in shared memory after it lands, while the
// next tile's copy is in flight. S = Q K^T takes a fresh accumulator for
// each 8-wide k-step (3 mma), added to the score in f32: with one
// accumulator of all D / 8 k-steps (24 mma at D 64) the tensor cores'
// truncation left elements of O outside the forward's limit (atol 1.2e-6
// needed over 12 draws of B8 H8 S512 D64 on the H100, 6.7e-7 so). In S a
// lane holds rows g and g + 8 (g = lane / 4) and keys 2t and 2t + 1 (t =
// lane % 4), so each row's max and sum combine over the lane's quad by
// shuffles, and m and l stay in registers. P goes from the S accumulators
// to split A fragments of P V (acc_to_a: key 2t in column t, 2t + 1 in
// column t + 4, V's rows read in that order), never through shared
// memory; each tile's P V takes fresh accumulators (24 mma each), rescaled
// and added to O in f32.
template <int D>
__global__ void __launch_bounds__(kThreads, kFwdBlocks<D>) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int S, float scale, int causal) {
  constexpr int kP = kPitch<D>, kN = kFwdKeys;
  constexpr int kT = kN / 8;  // n-tiles of S; k-steps of P V
  constexpr int kD = D / 8;   // k-steps of S; n-tiles of P V
  extern __shared__ __align__(16) uint32_t split_smem[];
  // Q's rows (f32), then each stage: K (f32, then big), K small, V (f32,
  // then big), V small
  uint32_t* const q_s = split_smem;
  auto tile = [&](int st, int i) { return split_smem + (kM + (st * 4 + i) * kN) * kP; };

  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int wr = r0 + 16 * warp;  // the warp's first row
  int n_kt = (S + kN - 1) / kN;
  // causal: key tiles wholly past this Q tile's last row are fully masked
  if (causal) n_kt = min(n_kt, (r0 + kM + kN - 1) / kN);

  stage<D, kM>(q_s, q + base, r0, S);
  stage<D, kN>(tile(0, 0), k + base, 0, S);
  stage<D, kN>(tile(0, 2), v + base, 0, S);
  cp_commit();
  const int row[2] = {wr + g, wr + g + 8};
  uint32_t qb[kD][4], qs[kD][4];
  float acc[kD][4], m[2] = {dftt::kNegInf, dftt::kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kD; ++n) zero(acc[n]);

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1, k0 = it * kN;
    if (it + 1 < n_kt) {
      stage<D, kN>(tile(st ^ 1, 0), k + base, k0 + kN, S);
      stage<D, kN>(tile(st ^ 1, 2), v + base, k0 + kN, S);
    }
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kD; ++kk) {
        uint32_t a[4];
        load_a<kP>(a, q_s, wr - r0 + g, 8 * kk + t);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(a[e]), qb[kk][e], qs[kk][e]);
      }
    }
    split_tile<D, kN>(tile(st, 0), tile(st, 0), tile(st, 1));
    split_tile<D, kN>(tile(st, 2), tile(st, 2), tile(st, 3));
    __syncthreads();
    // causal: a tile wholly past the warp's last row adds nothing to it
    if (!causal || k0 <= wr + 15) {
      const uint32_t *kb = tile(st, 0), *ks = tile(st, 1), *vb = tile(st, 2), *vs = tile(st, 3);
      float s[kT][4];
#pragma unroll
      for (int j = 0; j < kT; ++j) zero(s[j]);
#pragma unroll
      for (int j = 0; j < kT; ++j)
#pragma unroll
        for (int kk = 0; kk < kD; ++kk) {
          const int off = (8 * j + g) * kP + 8 * kk + t;
          mma3_add(s[j], qb[kk], qs[kk], frag_b(kb, off, 4), frag_b(ks, off, 4));
        }
      // the scale after the sum; masked scores at -1e30, with no mass
      const bool edge = k0 + kN > S || (causal && k0 + kN - 1 > wr);
      float mx[2] = {dftt::kNegInf, dftt::kNegInf};
#pragma unroll
      for (int j = 0; j < kT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, key = k0 + 8 * j + 2 * t + (e & 1);
          float x = __fmul_rn(s[j][e], scale);
          if (edge && (key >= S || (causal && key > row[i]))) x = dftt::kNegInf;
          s[j][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      float safe[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        safe[i] = m_new <= dftt::kNegInf ? 0.f : m_new;
        corr[i] = m[i] <= dftt::kNegInf ? 0.f : expf(__fsub_rn(m[i], safe[i]));
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = s[j][e] <= dftt::kNegInf ? 0.f : expf(__fsub_rn(s[j][e], safe[i]));
          s[j][e] = p;
          sum[i] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * corr[i] + sum[i];
      }
      // O = O corr + P V, this tile's P V in fresh accumulators
      float pv[kD][4];
#pragma unroll
      for (int n = 0; n < kD; ++n) zero(pv[n]);
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        uint32_t pab[4], pas[4];
        acc_to_a(s[j], pab, pas);
#pragma unroll
        for (int n = 0; n < kD; ++n) {
          const int off = (8 * j + 2 * t) * kP + 8 * n + g;
          mma3(pv[n], pab, pas, frag_b(vb, off, kP), frag_b(vs, off, kP));
        }
      }
#pragma unroll
      for (int n = 0; n < kD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] * corr[e >> 1] + pv[n][e];
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // O = acc / max(l, 1e-30), lse = safe m + log of it, written once; a
  // NaN l stays NaN (fmaxf would drop it), as in the plain version
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    const float lf = l[i] < 1e-30f ? 1e-30f : l[i];
    float* dst = o + base + static_cast<int64_t>(row[i]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kD; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * i] / lf, acc[n][2 * i + 1] / lf);
    if (t == 0)
      lse[static_cast<int64_t>(bh) * S + row[i]] = (m[i] <= dftt::kNegInf ? 0.f : m[i]) + logf(lf);
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
               int causal, float scale, cudaStream_t st) {
  constexpr size_t bytes = fwd_smem_bytes<D>();
  const int err = prepare(fwd_kernel<D>, bytes);
  if (err) return err;
  fwd_kernel<D><<<dim3(BH, (S + kM - 1) / kM), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int BH, int S, int causal, float scale,
              cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D, kDqTileRows<D>>();
  const int err = prepare(dq_kernel<D>, bytes);
  if (err) return err;
  dq_kernel<D><<<dim3(BH, (S + kM - 1) / kM), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int S, int causal, float scale,
               cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D, kDkvTileRows>();
  const int err = prepare(dkv_kernel<D>, bytes);
  if (err) return err;
  dkv_kernel<D><<<dim3(BH, (S + kM - 1) / kM), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), S,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, void* dqp, void* dq, int BH, int S,
               int causal, float scale, cudaStream_t st) {
  constexpr int kW = FusedShape<D>::kWarps, kN = FusedShape<D>::kRows, kKeys = 16 * kW;
  constexpr size_t bytes = fused_smem_bytes<D, kW, kN>();
  int err = prepare(bwd_kernel<D, kW, kN>, bytes);
  if (err) return err;
  bwd_kernel<D, kW, kN><<<dim3(BH, (S + kKeys - 1) / kKeys), 32 * kW, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dqp), S, scale, causal);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t n = static_cast<int64_t>(BH) * S * D;
  dq_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dqp), static_cast<float*>(dq), n, S, D, kKeys, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split3

}  // namespace

// Every tensor is contiguous f32: q, k, v, o, dout and the gradients
// [BH, S, D], lse and delta [BH, S], dqp [ceil(S / keys), BH, S, D] with
// keys = 16 x FusedShape<D>::kWarps (never zeroed); the kernels' inputs
// start on a 16-byte boundary. D = 64 or 32; any other D returns
// cudaErrorInvalidValue. Each launches on `stream` and returns a CUDA
// error code (0 = launched). Signatures as the bf16 entry points'
// (flash_attention.cu, flash_attention_bwd.cu).

extern "C" int dftt_flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                            void* lse, int BH, int S, int D, int causal,
                                            float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return split3::launch_fwd<64>(q, k, v, o, lse, BH, S, causal, scale, st);
  if (D == 32) return split3::launch_fwd<32>(q, k, v, o, lse, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused backward: dk = scale * sum of dS^T Q, dv = sum of P^T dO, and
// dq = scale * sum of dS K through the dqp partials (two kernels).
extern "C" int dftt_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, void* dqp, void* dq, int BH, int S, int D, int causal,
    float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return split3::launch_bwd<64>(q, k, v, dout, lse, delta, dk, dv, dqp, dq, BH, S, causal, scale, st);
  if (D == 32) return split3::launch_bwd<32>(q, k, v, dout, lse, delta, dk, dv, dqp, dq, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The two-kernel layout's dQ: dq = scale * sum of dS K, one kernel.
extern "C" int dftt_flash_attention_dq_f32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dq, int BH, int S, int D, int causal, float scale,
                                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return split3::launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, S, causal, scale, st);
  if (D == 32) return split3::launch_dq<32>(q, k, v, dout, lse, delta, dq, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The two-kernel layout's dK and dV: dk = scale * sum of dS^T Q, dv = sum of
// P^T dO, one kernel.
extern "C" int dftt_flash_attention_dkv_f32(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dk, void* dv, int BH, int S, int D, int causal,
                                            float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return split3::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, S, causal, scale, st);
  if (D == 32) return split3::launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
