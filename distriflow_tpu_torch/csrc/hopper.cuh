// Hopper building blocks shared by the attention, decode and depthwise
// kernels: TMA tensor maps and loads, mbarriers, cluster barriers and
// distributed shared memory, and warpgroup matrix products (wgmma).
//
// Every attention tile is a bf16 [rows, D] slice of a contiguous
// [B*H, S, D] tensor. At D 64 one row is 128 bytes, exactly one 128-byte
// swizzle atom wide; at D 32 (every attention kernel's second build) a
// row is 64 bytes and takes the 64-byte swizzle. TMA
// copies a tile into shared memory with the swizzle of its row width, and
// wgmma reads it back through a descriptor of the same swizzle, either
// K-major (the D columns are the contraction, as Q and K are in Q.K^T) or
// MN-major (the rows are the contraction, as V is in P.V). The tensor map
// is 3-D, {D, S, B*H}, so that a box reaching past row S is zero-filled by
// the hardware instead of reading the next head's rows. The depthwise
// kernels stage unswizzled boxes of a 4-D map over an NHWC activation
// (make_nhwc_map), and the f32 forward stores such a box of y back
// (tma_store_nhwc).
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dftt {
namespace hopper {

// Every tile base in shared memory is aligned to the 1024-byte swizzle
// pattern (8 rows of 128 bytes; the 64-byte swizzle repeats every 512).
constexpr int kSwizzleBytes = 1024;
constexpr int kRowBytes = 128;  // 64 bf16 columns: the default row of every helper below

// ---------------------------------------------------------------- host side

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), found through the runtime
// so that the library links against nothing but the CUDA runtime.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A tensor map over a contiguous bf16 [BH, S, D] tensor (D 64 or 32)
// whose box is [1, rows, D], swizzled by the row's width (128 or 64
// bytes); rows past S read as zeros. Returns a CUDA error code (0 =
// encoded).
inline int make_row_map(CUtensorMap* map, const void* base, int BH, int S, int rows, int D = 64) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  if (D != 64 && D != 32) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {row, static_cast<cuuint64_t>(S) * row};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A tensor map over a contiguous NHWC tensor [B, H, W, C] (C a multiple
// of 8) of bf16 (itemsize 2) or f32 (itemsize 4) elements, whose box is
// {c_box channels, w_box columns, h_box rows, b_box images}, unswizzled:
// the box lands in shared memory as a dense [b_box][h_box][w_box][c_box]
// tile, and every element outside the tensor (a negative start included)
// reads as zero. Returns a CUDA error code.
inline int make_nhwc_map(CUtensorMap* map, const void* base, int B, int H, int W, int C,
                         int c_box, int w_box, int h_box, int b_box, int itemsize) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  if (itemsize != 2 && itemsize != 4) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(C) * itemsize;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(c_box), static_cast<cuuint32_t>(w_box),
                             static_cast<cuuint32_t>(h_box), static_cast<cuuint32_t>(b_box)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map,
                              itemsize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              4, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte-aligned address at or after the dynamic shared
// memory's start (launches ask for kSwizzleBytes more than they use).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + ((kSwizzleBytes - (a & (kSwizzleBytes - 1))) & (kSwizzleBytes - 1));
}

// mbarriers: a phase completes when its arrivals are in and, for a TMA
// barrier, when the bytes announced by arrive_expect_tx have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Barrier `id` (1-15; 0 is __syncthreads) across `count` threads, a
// multiple of 32: lets the consumer warpgroups meet without the producer.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Orders this thread's plain shared-memory stores before later reads by
// the async proxy (wgmma operands, TMA): called by each storing thread
// before the barrier that hands the tile to a wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A ring of `kStages` shared-memory stages: a consumer waits for stage
// t % kStages to be full, the producer for it to be empty again.
template <int kStages>
struct Ring {
  __device__ static int stage(int t) { return t % kStages; }
  // parity of the full barrier's phase that brings step t's data
  __device__ static uint32_t full_parity(int t) { return (t / kStages) & 1; }
  // parity of the empty barrier's phase that frees the stage for step t
  // (the first round passes at once: the stage starts empty)
  __device__ static uint32_t empty_parity(int t) { return ((t / kStages) & 1) ^ 1; }
};

// TMA: box {64, rows, 1} at (column 0, row `row`, head `bh`) of `map` into
// `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, int row, int bh,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// TMA: the box of an NHWC map (make_nhwc_map) at channel c, column x, row
// y (either may be negative) of image b into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_nhwc(void* dst, const CUtensorMap* map, int c, int x,
                                              int y, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c), "r"(x), "r"(y), "r"(b)
      : "memory");
}

// TMA: `src` (shared memory, a dense box of an NHWC map) to the box at
// channel c, column x, row y of image b of `map`; elements outside the
// tensor are not written. The storing threads fence (fence_proxy_async)
// and meet before one thread calls this; it returns once the copy has read
// `src`, which may then be reused or the CTA end.
__device__ __forceinline__ void tma_store_nhwc(const CUtensorMap* map, const void* src, int c,
                                               int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c), "r"(x), "r"(y), "r"(b)
      : "memory");
}

// Thread-block clusters: this CTA's rank, a barrier of every thread of
// every CTA of the cluster (release/acquire: shared-memory writes before
// it are seen by reads after it anywhere in the cluster), and a load from
// the shared memory of the CTA of rank `rank` at the address `p` has in
// this CTA.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ double ld_cluster_f64(const double* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];\n" : "=d"(v) : "r"(remote) : "memory");
  return v;
}

// Four floats (16-byte aligned) from the shared memory of the CTA of rank
// `rank`. No "memory" clobber, so that a thread's loads issue back to back
// (a clobber would hold each behind the store of the one before); being
// volatile, they stay after the cluster barrier that published the data.
__device__ __forceinline__ float4 ld_cluster_f32x4(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}

// wgmma shared-memory descriptors for a swizzled tile of kRow-byte rows
// (128: the 128-byte swizzle, layout type 1; 64: the 64-byte swizzle,
// layout type 2) whose base is aligned to its swizzle pattern (bits 0-13
// address >> 4, 16-29 the leading and 32-45 the stride byte offset >> 4,
// 62-63 the layout type). Eight rows make one swizzle atom of 8 * kRow
// bytes.
template <int kRow>
struct Swizzle {
  static_assert(kRow == 128 || kRow == 64, "rows of 64 or 32 bf16 columns");
  static constexpr uint64_t kLayout = kRow == 128 ? 1 : 2;
  static constexpr uint64_t kAtom16 = (8 * kRow) >> 4;  // one atom, in 16-byte units
};

// K-major: the rows are M (or N) and the kRow / 2 columns the contraction.
// The stride byte offset steps one 8-row atom; the leading offset is
// unused for a swizzled K-major tile. Step k16 of the contraction starts
// 32 bytes further along the row (four steps at 128-byte rows, two at 64).
template <int kRow = kRowBytes>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (Swizzle<kRow>::kAtom16 << 32) | (Swizzle<kRow>::kLayout << 62);
}
__device__ __forceinline__ uint64_t kmajor_step(int k16) { return static_cast<uint64_t>(2 * k16); }

// MN-major: the rows are the contraction and the kRow / 2 columns N, one
// atom wide; the stride byte offset steps 8 rows of the contraction, the
// leading offset (between atoms along N) is unused at N = kRow / 2. Step
// k16 of the contraction starts 16 rows (16 * kRow bytes) further.
template <int kRow = kRowBytes>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (Swizzle<kRow>::kAtom16 << 16) | (Swizzle<kRow>::kAtom16 << 32) |
         (Swizzle<kRow>::kLayout << 62);
}
template <int kRow = kRowBytes>
__device__ __forceinline__ uint64_t mnmajor_step(int k16) {
  return static_cast<uint64_t>(k16 * (16 * kRow >> 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Ties registers to this point of the program: the compiler may not move
// their reads or writes across it. Called on every accumulator and register
// operand around an asynchronous product, since wgmma reads and writes them
// after its own instruction has issued.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Two f32 as one register of two bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of an m64nN product (N / 2 registers a thread), for
// thread t of the warpgroup: register 4n + 2i + j holds row
// 16 * (t / 32) + (t % 32) / 4 + 8i and column 8n + 2 * (t % 4) + j. Read as
// bf16 pairs, columns 16c..16c+15 (registers 8c..8c+7) are exactly the
// register A operand of one k16 step: a[c][r] = pack(d[8c + 2r], d[8c + 2r + 1]).
template <int kRegs>
__device__ __forceinline__ void acc_to_a(const float (&d)[kRegs], uint32_t (&a)[kRegs / 8][4]) {
#pragma unroll
  for (int c = 0; c < kRegs / 8; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[c][r] = pack_bf16(d[8 * c + 2 * r], d[8 * c + 2 * r + 1]);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A in registers (a[0..3], the
// accumulator layout of the product that made it), B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32], A and B in shared memory: the
// fused backward's dQ partial dS.K at head dim 32.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32], A in registers, B in shared
// memory: P.V at head dim 32 (and the backward's products whose N is D).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float* d, const uint32_t* a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

}  // namespace hopper
}  // namespace dftt
