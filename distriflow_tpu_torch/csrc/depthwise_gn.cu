// Fused depthwise 3x3 (SAME) + GroupNorm(8) + affine + ReLU6, forward and
// backward, over bf16 or f32 NHWC activations, as thread-block-cluster
// kernels that read the activation once through TMA. The bf16 forward and
// backward (dwgn_fwd_kernel, dwgn_bwd_kernel) keep one group of 8 channels
// a thread; the f32 forward and backward are kernels of their own
// (namespaces f32bwd and f32fwd, at the end): one channel a thread.
//
// Replaces the Pallas TPU kernels of the JAX package
//   distriflow_tpu/ops/depthwise_gn.py::_fwd_kernel  (kernel 11)
//   distriflow_tpu/ops/depthwise_gn.py::_bwd_kernel  (kernel 12, the jax.vjp
//                                                     of the same tile)
//
// Arithmetic (depthwise_gn.py:141-177): the conv adds the nine products
// x * w[ky, kx] in (ky, kx) order, each product and each sum rounded to
// the activation dtype. In bf16 this runs on bf16 pairs with
// mul.rn/add.rn.bf16x2, the exact result rounded once: the same bits as the
// f32 operation rounded to bf16, since the f32 product of two bf16 values
// is exact and the f32 sum of two rounds to the same bf16; dx's nine taps
// likewise. In f32 each product and each sum is its own __fmul_rn/__fadd_rn,
// so that nvcc cannot contract a product and a sum into one FMA (the tile
// and the plain versions round both). Statistics per (batch, group
// of 8 channels) over all output positions: mean and E[x^2], each the f32
// of an f64 sum, inv = rsqrt(max(E[x^2] - mean^2, 0) + eps); y = the
// activation dtype of ((x - mean) * inv * scale + bias), then min(max(y,
// 0), 6). The backward is the exact derivative jax.vjp takes of that tile:
// at y == 0 and y == 6 half the gradient passes, as does the variance clamp
// at 0; the conv-output cotangent (dacc) is rounded to the activation dtype
// and the nine dx contributions are added in that dtype from tap (2, 2)
// down to (0, 0). dw, dscale and dbias leave the kernel as per-batch f32
// partials (in bf16 dw rounded to bf16 per batch, as the tile's dw is),
// summed over the batch outside in a fixed order. Every sum over positions
// of the statistics, their gradients, dscale and dbias is accumulated in
// f64 and rounded to f32 once: the f32 of the exact sum, so the order in
// which threads, CTAs and tiles add does not show, and the plain versions
// (ops/depthwise_gn.py) give the same bits. In f32 dw is such a sum too.
// In bf16 dw's rounded products are added in f32 by each thread, then over
// a warp's lanes in f32 and over the warps in f64: its one sum whose last
// bits depend on the order (fixed, so every launch gives the same bits).
//
// Bound: a few f32 operations per element against 2 (4) bytes read and 2
// (4) written, so bytes bound both kernels (forward: x read, y written;
// backward: x and g read, dx written).
//
// Plan (ops/depthwise_gn.py::dwgn_plan, passed in as ints; the layout below
// refuses a launch whose shared-memory count differs from the plan's). One
// cluster of `cluster` CTAs (at most 8, the portable size) owns one (batch
// element, chunk of cc channels): grid (cluster, C / cc, ceil(B / nb)). The
// output is cut into tiles of rows x cols positions, and rank r takes tiles
// r, r + cluster, ... Each CTA loads a tile's input box with one 4-D TMA
// copy ({C, W, H, B} map, box {cc, cols_in, rows_in, nb}) whose start may
// be negative: the hardware fills everything outside the tensor with zeros,
// and that is the SAME padding, with no branch in the tap loop. The
// backward's g box comes on a second mbarrier, so pass 1 starts on x alone.
// A bf16 thread keeps one group of 8 channels (cc / 8 is a power of two
// that divides 32), and neighbouring threads read neighbouring groups: one
// 16-byte vector each (the f32 kernels: one channel a thread, below).
// Small images (3x3, 6x6, 12x12 at stride 2) put nb of them side by side in
// one CTA, kThreads / nb threads (whole warps) each, so that a CTA's fixed
// costs (the copy, the barriers, the reductions) serve more work.
//   - Resident plans (one tile a CTA; every shape of MobileNetV2 at 96 and
//     at 224 px, but the f32 backward's 112 px stage at C 32)
//     load x (and in the backward g) once and run every pass from shared
//     memory: HBM traffic is x once plus the halo rows, which the cluster's
//     neighbours fetch at the same time through L2, and y (dx) once.
//   - Shapes too wide or too large for eight resident tiles (the JAX gate
//     admits, e.g., 341 x 341 at C 8) stream: each pass loads each of the
//     CTA's tiles again (two passes over x in the forward, three over x and
//     g in the backward).
//
// Cluster exchanges (no atomics). Each CTA reduces its per-thread f64 sums
// with a warp butterfly and then across its 8 warps in order, stores them in
// its shared memory, and meets the cluster at barrier.cluster
// (release/acquire). Every CTA then reads every rank's slots through
// distributed shared memory (mapa + ld.shared::cluster) in rank order 0..n-1,
// so all of them hold the same statistics; rank 0 alone writes the batch
// element's dscale/dbias and dw partials. Each exchange has slots of its own,
// and the kernel ends at a cluster barrier, so that no CTA leaves while
// another still reads its shared memory. A cluster of one (most shapes)
// meets at __syncthreads instead. The butterflies shuffle all of a thread's
// values at each step together, so that their latencies overlap.
//   forward:  pass 1 statistics -> exchange -> pass 2 y.
//   backward: pass 1 statistics -> exchange; pass 2 dscale, dbias and the
//             statistics' gradients -> exchange; pass 3 (per tile) dacc over
//             the tile and the ring of outputs around it, computed again
//             from the box (which covers one more output on every side) and
//             stored in place of g, then dw tap by tap over the tile, then dx
//             for the input rows and columns the tile owns (those from its
//             first output's stride multiple to the next tile's) -> exchange
//             of dw. Recomputing the ring's cotangent instead of reading it
//             from the neighbour keeps pass 3 free of cluster barriers and
//             the same for resident and streamed plans: no dacc scratch in
//             HBM and no second launch.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"


namespace {

using dftt::hopper::cluster_rank;
using dftt::hopper::cluster_sync;
using dftt::hopper::fence_barrier_init;
using dftt::hopper::fence_proxy_async;
using dftt::hopper::ld_cluster_f64;
using dftt::hopper::mbar_arrive_expect_tx;
using dftt::hopper::mbar_init;
using dftt::hopper::mbar_wait;
using dftt::hopper::smem_addr;
using dftt::hopper::tma_load_nhwc;
using dftt::hopper::tma_store_nhwc;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;
constexpr int kMaxChunk = 128;
constexpr int kMaxCluster = 8;
constexpr int kMaxBox = 256;
constexpr int kSmemLimit = 232448;
// the f32 backward's f64 sums a thread in one slice sum (pass 2's dscale,
// dbias and the statistics' two gradient terms); its dw's nine take the x
// boxes' place
constexpr int kSliceValues = 4;

constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// bf16 pair arithmetic, each result the exact one rounded once to bf16: the
// same bits as the f32 operation rounded to bf16 (the f32 product of two
// bf16 is exact, and the f32 sum of two rounds to the same bf16).
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The element types. A bf16 thread's eight channels (a V8) are four bf16
// pairs (the lower channel in the low half: one 16-byte vector); mul and
// add round each result to bf16, pack8 rounds eight f32 values to it, relu6
// is min(max(v, 0), 6) in bf16. kFwdBlocks and kBwdBlocks are the CTAs an
// SM its kernels keep (__launch_bounds__: 80 and 128 registers). F32 names
// the f32 kernels' element (f32bwd::kBlocks and f32fwd::kBlocks are their
// CTAs an SM).
struct Bf16 {
  using Elem = __nv_bfloat16;
  static constexpr int kItemsize = 2, kFwdBlocks = 3, kBwdBlocks = 2;
  struct V8 {
    uint32_t h[4];
  };
  static __device__ __forceinline__ V8 ld8(const Elem* p) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    return {{r.x, r.y, r.z, r.w}};
  }
  static __device__ __forceinline__ void st8(Elem* p, const V8& v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v.h[0], v.h[1], v.h[2], v.h[3]);
  }
  static __device__ __forceinline__ V8 zero() { return {{0u, 0u, 0u, 0u}}; }
  static __device__ __forceinline__ void unpack8(const V8& v, float* f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf_lo(v.h[i]);
      f[2 * i + 1] = bf_hi(v.h[i]);
    }
  }
  static __device__ __forceinline__ V8 pack8(const float* f) {
    V8 v;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      v.h[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
    return v;
  }
  static __device__ __forceinline__ V8 mul(const V8& a, const V8& b) {
    V8 d;
#pragma unroll
    for (int i = 0; i < 4; ++i) d.h[i] = mul2(a.h[i], b.h[i]);
    return d;
  }
  static __device__ __forceinline__ V8 add(const V8& a, const V8& b) {
    V8 d;
#pragma unroll
    for (int i = 0; i < 4; ++i) d.h[i] = add2(a.h[i], b.h[i]);
    return d;
  }
  static __device__ __forceinline__ V8 relu6(V8 v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      asm("max.bf16x2 %0, %1, %2;" : "=r"(v.h[i]) : "r"(v.h[i]), "r"(0u));
      asm("min.bf16x2 %0, %1, %2;" : "=r"(v.h[i]) : "r"(v.h[i]), "r"(0x40c040c0u));
    }
    return v;
  }
};

struct F32 {
  using Elem = float;
  static constexpr int kItemsize = 4;
};

// One launch's geometry and plan, and the shared-memory layout they imply.
struct Plan {
  int B, H, W, C, s, OH, OW, pt, pl;  // activation, stride, output, SAME pads
  int cc, gc;                         // channels and groups a cluster owns
  int rows, cols, n_rt, n_ct;         // output tile; tiles down and across
  int cluster, tiles, nb;             // CTAs a cluster, tiles a CTA, images a CTA
  int halo;                           // 1 (backward): the box covers the tile's ring
  int xr, xc, gr, gw;                 // x box and g box (rows, cols) of one image
  int strip, keep;                    // f32 forward: a column's rows a unit; conv output kept
  int off_g, off_red, off_dwr, off_xch, off_st, off_bar, smem;
};

// strip and keep are the f32 forward's (f32fwd) and 0 for every other
// kernel.
bool make_plan(Plan& p, int B, int H, int W, int C, int s, int item, int cc, int rows, int cols,
               int cluster, int tiles, int nb, int backward, int strip = 0, int keep = 0) {
  const bool f32fwd = !backward && item == 4;
  if (B < 1 || H < 1 || W < 1 || C < kGroup || C % kGroup || (s != 1 && s != 2) ||
      (item != 2 && item != 4) || cc < kGroup || cc > kMaxChunk || cc % kGroup || C % cc ||
      32 % (cc / kGroup) || C / cc > 65535 || rows < 1 || cols < 1 || tiles < 1 ||
      cluster < 1 || cluster > kMaxCluster || (nb != 1 && nb != 2 && nb != 4 && nb != 8) ||
      nb * cc > kThreads || (B + nb - 1) / nb > 65535 ||
      (f32fwd ? strip < 1 || strip > rows || (keep != 0 && keep != 1) || (keep && tiles != 1)
              : strip != 0 || keep != 0))
    return false;
  p.strip = strip;
  p.keep = keep;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.s = s;
  const int th = ((H + s - 1) / s - 1) * s + 3 - H, tw = ((W + s - 1) / s - 1) * s + 3 - W;
  p.pt = (th > 0 ? th : 0) / 2;
  p.pl = (tw > 0 ? tw : 0) / 2;
  p.OH = (H + (th > 0 ? th : 0) - 3) / s + 1;
  p.OW = (W + (tw > 0 ? tw : 0) - 3) / s + 1;
  p.cc = cc;
  p.gc = cc / kGroup;
  p.rows = rows;
  p.cols = cols;
  p.n_rt = (p.OH + rows - 1) / rows;
  p.n_ct = (p.OW + cols - 1) / cols;
  p.cluster = cluster;
  p.tiles = tiles;
  p.nb = nb;
  p.halo = backward ? 1 : 0;
  p.xr = (rows + 2 * p.halo - 1) * s + 3;
  p.xc = (cols + 2 * p.halo - 1) * s + 3;
  p.gr = rows + 2;
  p.gw = cols + 2;
  const int n_tiles = p.n_rt * p.n_ct;
  if (cluster > n_tiles || cluster * tiles < n_tiles || p.xr > kMaxBox || p.xc > kMaxBox ||
      p.gw > kMaxBox || p.gr > kMaxBox)
    return false;
  // x boxes; g boxes (backward); two f64 reduction buffers of kWarps x cc;
  // the bf16 backward's f32 warp sums of dw, [9][kWarps][cc]; exchange
  // slots; 8 floats of statistics a group; the two mbarriers (x, g). The
  // f32 backward (f32bwd) keeps x boxes at least as large as its nine dw
  // sums a thread in f64 (they take the boxes' place at the end), and one
  // f64 buffer of kSliceValues sums a thread. The f32 forward (f32fwd)
  // keeps, on a plan that keeps its conv output, the output tile
  // [nb][rows][cols][cc] f32 in the g boxes' place, and one f64 buffer of
  // 2 sums a thread.
  const int xch = nb * (backward ? 11 * cc + 4 * p.gc : 2 * p.gc);
  const int xbox = nb * p.xr * p.xc * cc * item;
  if (backward && item == 4) {
    p.off_g = align128(xbox > 9 * kThreads * 8 ? xbox : 9 * kThreads * 8);
    p.off_red = p.off_g + align128(nb * p.gr * p.gw * cc * item);
    p.off_dwr = p.off_xch = p.off_red + align128(kSliceValues * kThreads * 8);
  } else if (f32fwd) {
    p.off_g = align128(xbox);
    p.off_red = p.off_g + align128(keep ? nb * rows * cols * cc * item : 0);
    p.off_dwr = p.off_xch = p.off_red + align128(2 * kThreads * 8);
  } else {
    p.off_g = align128(xbox);
    p.off_red = p.off_g + align128(backward ? nb * p.gr * p.gw * cc * item : 0);
    p.off_dwr = p.off_red + align128(2 * kWarps * cc * 8);
    p.off_xch = p.off_dwr + align128(backward ? 9 * kWarps * cc * 4 : 0);
  }
  p.off_st = p.off_xch + align128(xch * 8);
  p.off_bar = p.off_st + align128(nb * p.gc * 32);
  p.smem = 128 + p.off_bar + 16;  // 128: to align the base
  return p.smem <= kSmemLimit;
}

template <typename T>
struct Smem {
  typename T::Elem* x;  // [nb][xr][xc][cc]
  typename T::Elem* g;  // [nb][gr][gw][cc]: g, then the cotangent in its place (f32fwd:
                        // the kept conv output [nb][rows][cols][cc])
  double* red;          // [2][8][kWarps][gc]
  float* dwr;           // bf16 backward: [9][kWarps][8][gc]
  double* xch;          // stats [nb][2][gc]; ds, db [nb][8][gc]; dstats [nb][2][gc]; dw [9][nb][8][gc]
  float* st;            // [nb][gc][8]: mean, var, inv, -, dvar / n, dmean / n
  uint64_t* bar;        // [2]: the x boxes' and the g boxes' copies
};

template <typename T>
__device__ __forceinline__ Smem<T> carve(const Plan& p) {
  extern __shared__ __align__(128) unsigned char raw[];
  unsigned char* base = raw + ((128 - (smem_addr(raw) & 127)) & 127);
  Smem<T> sm;
  sm.x = reinterpret_cast<typename T::Elem*>(base);
  sm.g = reinterpret_cast<typename T::Elem*>(base + p.off_g);
  sm.red = reinterpret_cast<double*>(base + p.off_red);
  sm.dwr = reinterpret_cast<float*>(base + p.off_dwr);
  sm.xch = reinterpret_cast<double*>(base + p.off_xch);
  sm.st = reinterpret_cast<float*>(base + p.off_st);
  sm.bar = reinterpret_cast<uint64_t*>(base + p.off_bar);
  return sm;
}

// A thread's place: image `img` of the CTA's nb (batch element b, real if
// live), group g of the chunk (channels ch0..ch0+7), and its first position
// slot and slot stride over the image's kThreads / nb threads (whole warps).
template <typename T>
struct Lane {
  int img, b, g, ch0, slot, step;
  bool live;
  typename T::Elem* xs;  // this image's x box
  typename T::Elem* gs;  // this image's g box
};

template <typename T>
__device__ __forceinline__ Lane<T> lane_of(const Plan& p, const Smem<T>& sm, int chunk) {
  const int tpi = kThreads / p.nb, lt = threadIdx.x % tpi;
  Lane<T> l;
  l.img = threadIdx.x / tpi;
  l.b = blockIdx.z * p.nb + l.img;
  l.live = l.b < p.B;
  l.g = lt % p.gc;
  l.ch0 = chunk * p.cc + l.g * kGroup;
  l.slot = lt / p.gc;
  l.step = tpi / p.gc;
  l.xs = sm.x + l.img * p.xr * p.xc * p.cc;
  l.gs = sm.g + l.img * p.gr * p.gw * p.cc;
  return l;
}

// A thread's nine weight vectors (its group's channels), its scale and
// bias, read while the first copy flies; then the barrier that lets every
// thread wait on the mbarrier thread 0 set up.
template <typename T>
__device__ __forceinline__ void prologue(const Plan& p, const typename T::Elem* __restrict__ w,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias, int ch0,
                                         typename T::V8 (&wr)[9], float (&sc)[kGroup],
                                         float (&bi)[kGroup]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) wr[k] = T::ld8(w + k * p.C + ch0);
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    sc[c] = scale[ch0 + c];
    bi[c] = bias[ch0 + c];
  }
  __syncthreads();
}

struct Tile {
  int r0, c0, rr, cw;  // first output row and column; rows and columns present
};

// Tile i of rank `rank` (false past the last tile).
__device__ __forceinline__ bool tile_of(const Plan& p, int rank, int i, Tile& t) {
  const int idx = rank + i * p.cluster;
  if (idx >= p.n_rt * p.n_ct) return false;
  t.r0 = (idx / p.n_ct) * p.rows;
  t.c0 = (idx % p.n_ct) * p.cols;
  t.rr = min(p.rows, p.OH - t.r0);
  t.cw = min(p.cols, p.OW - t.c0);
  return true;
}

// Thread 0: the copies of tile t's boxes of the CTA's nb images, x on
// bar[0] and, in the backward, g on bar[1] (pass 1 needs only x).
template <typename T>
__device__ __forceinline__ void copy_tile(const Plan& p, const CUtensorMap* tm_x,
                                          const CUtensorMap* tm_g, const Smem<T>& sm,
                                          const Tile& t, int chunk) {
  const int b0 = blockIdx.z * p.nb;
  mbar_arrive_expect_tx(sm.bar, p.xr * p.xc * p.cc * T::kItemsize * p.nb);
  tma_load_nhwc(sm.x, tm_x, chunk * p.cc, (t.c0 - p.halo) * p.s - p.pl,
                (t.r0 - p.halo) * p.s - p.pt, b0, sm.bar);
  if (p.halo) {
    mbar_arrive_expect_tx(sm.bar + 1, p.gr * p.gw * p.cc * T::kItemsize * p.nb);
    tma_load_nhwc(sm.g, tm_g, chunk * p.cc, t.c0 - 1, t.r0 - 1, b0, sm.bar + 1);
  }
}

// Sets up the mbarrier and starts the copy of tile 0 where it stays (a
// resident plan) before the weights load; returns whether the tile stays.
template <typename T>
__device__ __forceinline__ bool start(const Plan& p, const CUtensorMap* tm_x,
                                      const CUtensorMap* tm_g, const Smem<T>& sm, int rank,
                                      int chunk) {
  Tile t;
  const bool resident = p.tiles == 1 && tile_of(p, rank, 0, t);
  if (threadIdx.x == 0) {
    mbar_init(sm.bar, 1);
    mbar_init(sm.bar + 1, 1);
    fence_barrier_init();
    if (resident) copy_tile(p, tm_x, tm_g, sm, t, chunk);
  }
  return resident;
}

// A streamed plan's load of tile t; every thread calls it and returns when
// the boxes have landed. The barrier first lets every thread finish with
// the boxes it overwrites (and, with the proxy fence, orders the threads'
// own stores before the copy's).
template <typename T>
__device__ __forceinline__ void fetch(const Plan& p, const CUtensorMap* tm_x,
                                      const CUtensorMap* tm_g, const Smem<T>& sm, const Tile& t,
                                      int chunk, uint32_t& phase) {
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) copy_tile(p, tm_x, tm_g, sm, t, chunk);
  mbar_wait(sm.bar, phase);
  if (p.halo) mbar_wait(sm.bar + 1, phase);
  phase ^= 1;
}

// The conv at box-local output (ly, lx) for group g: nine rounded products
// added in (ky, kx) order with a rounding after each add.
template <typename T>
__device__ __forceinline__ typename T::V8 conv8(const Plan& p, const typename T::Elem* xs,
                                                const typename T::V8 (&wr)[9], int ly, int lx,
                                                int g) {
  const typename T::Elem* base = xs + ((ly * p.s) * p.xc + lx * p.s) * p.cc + g * kGroup;
  typename T::V8 acc;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const typename T::V8 t = T::mul(T::ld8(base + ((k / 3) * p.xc + k % 3) * p.cc), wr[k]);
    acc = k == 0 ? t : T::add(acc, t);
  }
  return acc;
}

// Sums each thread's N values over the threads of its image and group:
// thread (img * N + j) * gc + g (< nb * N * gc) receives value j of group g
// of image img, added in a fixed order (a butterfly in each warp, then the
// image's warps in order). red: N x kWarps x gc doubles.
template <int N>
__device__ __forceinline__ double block_sum(const Plan& p, const double (&v)[N], double* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, gc = p.gc;
  double a[N];
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = v[j];
  for (int off = 16; off >= gc; off >>= 1) {  // the N values' shuffles in flight together
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] = __dadd_rn(a[j], __shfl_xor_sync(0xffffffffu, a[j], off));
  }
  if (lane < gc) {
#pragma unroll
    for (int j = 0; j < N; ++j) red[(j * kWarps + warp) * gc + lane] = a[j];
  }
  __syncthreads();
  double s = 0.0;
  const int t = threadIdx.x;
  if (t < p.nb * N * gc) {
    const int img = t / (N * gc), j = (t / gc) % N, g = t % gc, wpi = kWarps / p.nb;
    for (int w = img * wpi; w < (img + 1) * wpi; ++w) s = __dadd_rn(s, red[(j * kWarps + w) * gc + g]);
  }
  __syncthreads();
  return s;
}

// The barrier of an exchange: the cluster's, or the CTA's in a cluster of
// one (no distributed shared memory to order).
__device__ __forceinline__ void exchange_sync(const Plan& p) {
  if (p.cluster > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

// The sum of slot `p` over the cluster's CTAs, in rank order (the loads
// started together, then added).
__device__ __forceinline__ double cluster_sum(const double* p, int n) {
  double v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) v[r] = r < n ? ld_cluster_f64(p, r) : 0.0;
  double s = 0.0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < n) s = __dadd_rn(s, v[r]);
  return s;
}

// Pass 1 over one tile: each element's value and square into the f64 sums.
template <typename T>
__device__ __forceinline__ void stat_sums(const Plan& p, const Lane<T>& l,
                                          const typename T::V8 (&wr)[9], const Tile& t,
                                          double (&sums)[2]) {
  for (int q = l.slot; q < t.rr * t.cw; q += l.step) {
    float a[kGroup];
    T::unpack8(conv8<T>(p, l.xs, wr, p.halo + q / t.cw, p.halo + q % t.cw, l.g), a);
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      sums[0] = __dadd_rn(sums[0], a[c]);
      sums[1] = __dadd_rn(sums[1], __fmul_rn(a[c], a[c]));
    }
  }
}

// After pass 1's exchange: each (image, group)'s mean, E[x^2] - mean^2 and
// inv from the CTAs' (sum, sum of squares) in the slots sm.xch [nb][2][gc],
// the same in every CTA of the cluster.
template <typename T>
__device__ __forceinline__ void stats_from_slots(const Plan& p, const Smem<T>& sm, float eps) {
  const int t = threadIdx.x;
  if (t < p.nb * p.gc) {
    const double* slots = sm.xch + (t / p.gc) * 2 * p.gc + t % p.gc;
    const double n = static_cast<double>(p.OH) * p.OW * kGroup;
    const double s = cluster_sum(slots, p.cluster), ss = cluster_sum(slots + p.gc, p.cluster);
    const float m = __double2float_rn(__ddiv_rn(s, n)), m2 = __double2float_rn(__ddiv_rn(ss, n));
    const float var = __fsub_rn(m2, __fmul_rn(m, m));
    float* st = sm.st + t * 8;
    st[0] = m;
    st[1] = var;
    st[2] = rsqrtf(__fadd_rn(fmaxf(var, 0.f), eps));
  }
  __syncthreads();
}

// Pass 1's exchange: the CTA's (sum, sum of squares) into the slots, then
// the statistics.
template <typename T>
__device__ __forceinline__ void exchange_stats(const Plan& p, const Smem<T>& sm,
                                               const double (&v)[2], float eps) {
  const double tot = block_sum<2>(p, v, sm.red);
  if (threadIdx.x < p.nb * 2 * p.gc) sm.xch[threadIdx.x] = tot;
  exchange_sync(p);
  stats_from_slots(p, sm, eps);
}

// The bf16 forward (T = Bf16; f32fwd::fwd_kernel is the f32 one).
template <typename T>
__global__ void __launch_bounds__(kThreads, T::kFwdBlocks) dwgn_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_x, const typename T::Elem* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    typename T::Elem* __restrict__ out, const Plan p, float eps, int relu6) {
  using V8 = typename T::V8;
  const Smem<T> sm = carve<T>(p);
  const int rank = static_cast<int>(cluster_rank()), chunk = blockIdx.y;
  const Lane<T> l = lane_of(p, sm, chunk);
  const bool resident = start(p, &tm_x, &tm_x, sm, rank, chunk);
  V8 wr[9];
  float sc[kGroup], bi[kGroup];
  prologue<T>(p, w, scale, bias, l.ch0, wr, sc, bi);
  uint32_t phase = 0;
  Tile t;
  if (resident) {
    mbar_wait(sm.bar, 0);
    phase = 1;
  }

  double sums[2] = {0.0, 0.0};
  for (int i = 0; i < p.tiles && tile_of(p, rank, i, t); ++i) {
    if (!resident) fetch(p, &tm_x, &tm_x, sm, t, chunk, phase);
    stat_sums(p, l, wr, t, sums);
  }
  exchange_stats(p, sm, sums, eps);
  const float* st = sm.st + (l.img * p.gc + l.g) * 8;
  const float m = st[0], inv = st[2];
  for (int i = 0; i < p.tiles && tile_of(p, rank, i, t); ++i) {
    if (!resident) fetch(p, &tm_x, &tm_x, sm, t, chunk, phase);
    for (int q = l.slot; l.live && q < t.rr * t.cw; q += l.step) {
      const int ly = q / t.cw, lx = q % t.cw;
      float a[kGroup];
      T::unpack8(conv8<T>(p, l.xs, wr, ly, lx, l.g), a);
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        a[c] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(a[c], m), inv), sc[c]), bi[c]);
      V8 y = T::pack8(a);
      if (relu6) y = T::relu6(y);
      T::st8(out + ((static_cast<int64_t>(l.b) * p.OH + t.r0 + ly) * p.OW + t.c0 + lx) * p.C +
                 l.ch0,
             y);
    }
  }
  if (p.cluster > 1) cluster_sync();  // no CTA leaves while another may still read its slots
}

// d(min(max(y, 0), 6))/dy as jax.vjp takes it: 1 inside, 0.5 on a bound.
__device__ __forceinline__ float relu6_grad(float y) {
  const float lo = y > 0.f ? 1.f : (y == 0.f ? 0.5f : 0.f);
  const float hi = y < 6.f ? 1.f : (y == 6.f ? 0.5f : 0.f);
  return lo * hi;
}

// The per-element terms of one position's 8 channels from the conv output
// `a` and the upstream gradient: xc = x - mean, yn, dz (the gradient past
// ReLU6) and dyn = dz * scale.
struct Elems {
  float xc[kGroup], yn[kGroup], dz[kGroup], dyn[kGroup];
};

template <typename T>
__device__ __forceinline__ void elems(const float* a, const typename T::V8& g8, float m, float inv,
                                      const float* sc, const float* bi, int relu6, Elems& e) {
  float y[kGroup], gv[kGroup];
  T::unpack8(g8, gv);
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    e.xc[c] = __fsub_rn(a[c], m);
    e.yn[c] = __fmul_rn(e.xc[c], inv);
    y[c] = __fadd_rn(__fmul_rn(e.yn[c], sc[c]), bi[c]);
  }
  T::unpack8(T::pack8(y), y);  // y as the forward rounds it
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    e.dz[c] = relu6 ? __fmul_rn(gv[c], relu6_grad(y[c])) : gv[c];
    e.dyn[c] = __fmul_rn(e.dz[c], sc[c]);
  }
}

// After pass 2's exchange: each (image, group)'s dvar / n and dmean / n
// (st[4], st[5]) from the CTAs' sum(dyn * inv) and sum(dyn * xc) in the
// slots xch_d [nb][2][gc]; the variance clamp's tie passes half.
__device__ __forceinline__ void stat_grads_from_slots(const Plan& p, float* st,
                                                      const double* xch_d, float eps) {
  const int t = threadIdx.x;
  if (t < p.nb * p.gc) {
    float* gst = st + t * 8;
    const double* slots = xch_d + (t / p.gc) * 2 * p.gc + t % p.gc;
    const float gm = gst[0], gvar = gst[1], ginv = gst[2];
    const float n = static_cast<float>(p.OH * p.OW * kGroup);
    const float sxc = __double2float_rn(cluster_sum(slots, p.cluster));
    const float dinv = __double2float_rn(cluster_sum(slots + p.gc, p.cluster));
    float dvar =
        __fmul_rn(dinv, __fmul_rn(-0.5f, __fdiv_rn(ginv, __fadd_rn(fmaxf(gvar, 0.f), eps))));
    dvar = __fmul_rn(dvar, gvar > 0.f ? 1.f : (gvar == 0.f ? 0.5f : 0.f));
    const float dm = __fsub_rn(-sxc, __fmul_rn(__fmul_rn(2.f, dvar), gm));
    gst[4] = __fdiv_rn(dvar, n);
    gst[5] = __fdiv_rn(dm, n);
  }
}

// The bf16 backward (T = Bf16; f32bwd::bwd_kernel is the f32 one).
template <typename T>
__global__ void __launch_bounds__(kThreads, T::kBwdBlocks) dwgn_bwd_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_g,
    const typename T::Elem* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, typename T::Elem* __restrict__ dx,
    float* __restrict__ dw_part, float* __restrict__ ds_part, float* __restrict__ db_part,
    const Plan p, float eps, int relu6) {
  using V8 = typename T::V8;
  const Smem<T> sm = carve<T>(p);
  const int rank = static_cast<int>(cluster_rank()), chunk = blockIdx.y;
  const Lane<T> l = lane_of(p, sm, chunk);
  // thread t < nb * cc holds the sums of image t / cc, channel
  // ((t % cc) % gc) * 8 + (t % cc) / gc of the chunk (block_sum's order)
  const int t_id = threadIdx.x, ncc = p.nb * p.cc;
  const int my_b = blockIdx.z * p.nb + t_id / p.cc;
  const int my_ch = chunk * p.cc + (t_id % p.cc % p.gc) * kGroup + t_id % p.cc / p.gc;
  const bool mine = t_id < ncc && my_b < p.B;
  double* xch_ds = sm.xch + p.nb * 2 * p.gc;
  double* xch_db = xch_ds + ncc;
  double* xch_d = xch_db + ncc;
  double* xch_dw = xch_d + p.nb * 2 * p.gc;
  const bool resident = start(p, &tm_x, &tm_g, sm, rank, chunk);
  V8 wr[9];
  float sc[kGroup], bi[kGroup];
  prologue<T>(p, w, scale, bias, l.ch0, wr, sc, bi);
  uint32_t phase = 0;
  Tile t;
  if (resident) {
    mbar_wait(sm.bar, 0);
    phase = 1;
  }

  // pass 1: the statistics (box-local outputs start one ring in)
  {
    double sums[2] = {0.0, 0.0};
    for (int i = 0; i < p.tiles && tile_of(p, rank, i, t); ++i) {
      if (!resident) fetch(p, &tm_x, &tm_g, sm, t, chunk, phase);
      stat_sums(p, l, wr, t, sums);
    }
    exchange_stats(p, sm, sums, eps);
  }
  float* st = sm.st + (l.img * p.gc + l.g) * 8;
  const float m = st[0], inv = st[2];

  if (resident) mbar_wait(sm.bar + 1, 0);  // the g box

  // pass 2: dscale, dbias per channel; sum(dyn * inv) and sum(dyn * xc) per group
  {
    double ds[kGroup] = {}, db[kGroup] = {}, dst[2] = {0.0, 0.0};
    for (int i = 0; i < p.tiles && tile_of(p, rank, i, t); ++i) {
      if (!resident) fetch(p, &tm_x, &tm_g, sm, t, chunk, phase);
      for (int q = l.slot; q < t.rr * t.cw; q += l.step) {
        const int ly = 1 + q / t.cw, lx = 1 + q % t.cw;
        float a[kGroup];
        T::unpack8(conv8<T>(p, l.xs, wr, ly, lx, l.g), a);
        Elems e;
        elems<T>(a, T::ld8(l.gs + (ly * p.gw + lx) * p.cc + l.g * kGroup), m, inv, sc, bi, relu6,
                 e);
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          ds[c] = __dadd_rn(ds[c], __fmul_rn(e.dz[c], e.yn[c]));
          db[c] = __dadd_rn(db[c], e.dz[c]);
          dst[0] = __dadd_rn(dst[0], __fmul_rn(e.dyn[c], inv));
          dst[1] = __dadd_rn(dst[1], __fmul_rn(e.dyn[c], e.xc[c]));
        }
      }
    }
    const double dsum = block_sum<kGroup>(p, ds, sm.red);
    const double bsum = block_sum<kGroup>(p, db, sm.red);
    const double gsum = block_sum<2>(p, dst, sm.red);
    if (t_id < ncc) {
      xch_ds[t_id] = dsum;
      xch_db[t_id] = bsum;
      for (int k = 0; k < 9; ++k) xch_dw[k * ncc + t_id] = 0.0;
    }
    if (t_id < p.nb * 2 * p.gc) xch_d[t_id] = gsum;
    exchange_sync(p);
    stat_grads_from_slots(p, sm.st, xch_d, eps);
    if (rank == 0 && mine) {
      ds_part[static_cast<int64_t>(my_b) * p.C + my_ch] =
          __double2float_rn(cluster_sum(xch_ds + t_id, p.cluster));
      db_part[static_cast<int64_t>(my_b) * p.C + my_ch] =
          __double2float_rn(cluster_sum(xch_db + t_id, p.cluster));
    }
    __syncthreads();
  }
  const float kv = st[4], km = st[5];

  // pass 3, tile by tile: the cotangent over the tile and its ring (in
  // place of g), dw over the tile's outputs, dx over the inputs it owns
  for (int i = 0; i < p.tiles && tile_of(p, rank, i, t); ++i) {
    if (!resident) fetch(p, &tm_x, &tm_g, sm, t, chunk, phase);
    const int ew = t.cw + 2;
    for (int q = l.slot; q < (t.rr + 2) * ew; q += l.step) {
      const int ly = q / ew, lx = q % ew, oy = t.r0 - 1 + ly, ox = t.c0 - 1 + lx;
      typename T::Elem* cell = l.gs + (ly * p.gw + lx) * p.cc + l.g * kGroup;
      V8 da = T::zero();
      if (oy >= 0 && oy < p.OH && ox >= 0 && ox < p.OW) {
        float a[kGroup], d[kGroup];
        T::unpack8(conv8<T>(p, l.xs, wr, ly, lx, l.g), a);
        Elems e;
        elems<T>(a, T::ld8(cell), m, inv, sc, bi, relu6, e);
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
          d[c] = __fadd_rn(__fadd_rn(__fmul_rn(e.dyn[c], inv), __fmul_rn(__fmul_rn(2.f, a[c]), kv)),
                           km);
        da = T::pack8(d);
      }
      T::st8(cell, da);
    }
    __syncthreads();
    // dw, one tap at a time over the tile's outputs
#pragma unroll 1
    for (int k = 0; k < 9; ++k) {
      const int ky = k / 3, kx = k % 3;
      int qy = l.slot / t.cw, qx = l.slot % t.cw;
      // each thread adds its rounded products in f32, a butterfly adds the
      // warp's lanes of a group in f32, and after the nine taps thread t <
      // nb * cc adds its image's warps in f64
      const int lane = t_id % 32, warp = t_id / 32;
      float a[kGroup] = {};
      while (qy < t.rr) {
        const int ly = 1 + qy, lx = 1 + qx;
        const V8 d = T::ld8(l.gs + (ly * p.gw + lx) * p.cc + l.g * kGroup);
        const V8 v =
            T::ld8(l.xs + ((ly * p.s + ky) * p.xc + lx * p.s + kx) * p.cc + l.g * kGroup);
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          const uint32_t pr = mul2(d.h[i2], v.h[i2]);
          a[2 * i2] = __fadd_rn(a[2 * i2], bf_lo(pr));
          a[2 * i2 + 1] = __fadd_rn(a[2 * i2 + 1], bf_hi(pr));
        }
        for (qx += l.step; qx >= t.cw; qx -= t.cw) ++qy;
      }
      for (int off = 16; off >= p.gc; off >>= 1) {
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
          a[c] = __fadd_rn(a[c], __shfl_xor_sync(0xffffffffu, a[c], off));
      }
      if (lane < p.gc) {
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
          sm.dwr[((k * kWarps + warp) * kGroup + c) * p.gc + lane] = a[c];
      }
    }
    __syncthreads();
    if (t_id < ncc) {
      const int j = t_id % p.cc / p.gc, g = t_id % p.gc, wpi = kWarps / p.nb;
      const int w0 = t_id / p.cc * wpi;
      for (int k = 0; k < 9; ++k) {
        double sk = 0.0;
        for (int w = w0; w < w0 + wpi; ++w)
          sk = __dadd_rn(sk, sm.dwr[((k * kWarps + w) * kGroup + j) * p.gc + g]);
        xch_dw[k * ncc + t_id] = __dadd_rn(xch_dw[k * ncc + t_id], sk);
      }
    }
    // dx at the inputs this tile owns: rows [r0 * s, (r0 + rows) * s) and
    // columns likewise, clipped to the image; the nine taps in the
    // activation dtype from (2, 2) down to (0, 0)
    const int iy0 = t.r0 * p.s, ix0 = t.c0 * p.s;
    const int ih = min((t.r0 + p.rows) * p.s, p.H) - iy0, iw = min((t.c0 + p.cols) * p.s, p.W) - ix0;
    const int sh = p.s - 1;  // stride 1 or 2: divide by a shift
    for (int qy = l.slot / iw, qx = l.slot % iw; l.live && qy < ih;) {
      const int iy = iy0 + qy, ix = ix0 + qx;
      for (qx += l.step; qx >= iw; qx -= iw) ++qy;
      V8 acc = T::zero();
#pragma unroll
      for (int ky = 2; ky >= 0; --ky) {
        const int ty = iy + p.pt - ky;
        if (ty < 0 || (ty & sh)) continue;
        const int ly = (ty >> sh) - (t.r0 - 1);
#pragma unroll
        for (int kx = 2; kx >= 0; --kx) {
          const int tx = ix + p.pl - kx;
          if (tx < 0 || (tx & sh)) continue;
          const int lx = (tx >> sh) - (t.c0 - 1);
          const V8 d = T::ld8(l.gs + (ly * p.gw + lx) * p.cc + l.g * kGroup);
          acc = T::add(acc, T::mul(d, wr[ky * 3 + kx]));
        }
      }
      T::st8(dx + ((static_cast<int64_t>(l.b) * p.H + iy) * p.W + ix) * p.C + l.ch0, acc);
    }
  }
  exchange_sync(p);
  if (rank == 0) {
    for (int v = t_id; v < 9 * ncc; v += kThreads) {
      const int k = v / ncc, u = v % ncc, b = blockIdx.z * p.nb + u / p.cc;
      if (b >= p.B) continue;
      const int ch = chunk * p.cc + (u % p.cc % p.gc) * kGroup + u % p.cc / p.gc;
      const float sum = __double2float_rn(cluster_sum(xch_dw + v, p.cluster));
      dw_part[(static_cast<int64_t>(b) * 9 + k) * p.C + ch] =
          __bfloat162float(__float2bfloat16_rn(sum));
    }
  }
  if (p.cluster > 1) cluster_sync();  // no CTA leaves while rank 0 may still read its slots
}

// Kernel 12 in f32: the backward on f32 activations, one channel a thread.
//
// The same cut as the bf16 backward (dwgn_plan: a cluster a (batch element,
// chunk of cc channels), tiles of rows x cols outputs, nb small images side
// by side, resident or streamed) and the same passes and exchanges, but a
// thread owns ONE channel of its image (c = its index mod cc) and a slice of
// the positions (slice = its index / cc over nsl = kThreads / (nb * cc)
// slices, positions slice, slice + nsl, ...). Neighbouring threads read
// neighbouring channels of one position: a warp's 4-byte loads of the boxes
// are 128 contiguous bytes, free of bank conflicts from cc 32 up. The
// kernel is built for each chunk width (bwd_kernel<CC>), so that the taps'
// offsets are immediates. The nine weights, the scale and the bias are 11
// registers; every per-channel sum (dscale, dbias, dw) stays in the thread
// until one slice sum of the CTA, and every per-group sum (the statistics
// and their gradients) is first a 3-step butterfly over the group's 8
// neighbouring lanes (the same bits in all 8: each step adds the same two
// values). So:
//   - 80 registers fit kBlocks CTAs an SM, and three where the plan's shared
//     memory allows (SMEM_TARGET[(True, 4)] fits two), where the bf16
//     template's f32 instance held 223 registers and one CTA: one CTA's
//     TMA wait, barriers and reductions overlap another's passes;
//   - pass 1 ends in one slice sum of 2 values, pass 2 in one of 4 (the
//     template: block sums of 2, 8 + 8 + 2), and dw, which the template
//     summed tap by tap in nine block sums reading each cotangent nine
//     times, takes its products in pass 3 as each cotangent is computed,
//     from the conv's nine inputs already in registers, keeps its nine f64
//     sums a thread over the tiles, then one slice sum of 9 values in the x
//     boxes' place;
//   - dx reads each tap's cell at a fixed offset: at stride 2 by parity
//     class (4, 2, 2 and 1 taps), at stride 1 all nine (the ring's zero
//     cells where a tap leaves the image).
// A slice sum adds blocks of slices in order, then the blocks over a
// butterfly of neighbouring lanes (one slice: no barrier); the cluster's
// ranks follow in order through the exchange slots: the statistics, their
// gradients, dscale, dbias and dw are the f32 of f64 sums of the same f32
// terms as the plain versions', and every launch gives the same bits. The
// conv is recomputed in each pass from the x box (9 loads, 9 products, 8
// sums a value), as in the template.
namespace f32bwd {

// CTAs an SM __launch_bounds__ asks for (ops/depthwise_gn.py F32_BWD_BLOCKS,
// whose SMEM_TARGET fits them)
constexpr int kBlocks = 2;

// A thread's place: image img (batch element b, real if live), channel c
// of the chunk (ch in the tensor, u = img * cc + c in the CTA), position
// slice `slice` of nsl; xs and gs point at channel c of its image's boxes.
struct Lane {
  int img, b, c, ch, u, slice, nsl;
  bool live;
  const float* xs;
  float* gs;
};

template <int CC>
__device__ __forceinline__ Lane lane_of(const Plan& p, const Smem<F32>& sm, int chunk) {
  const int tpi = kThreads / p.nb, lt = threadIdx.x % tpi;
  Lane l;
  l.img = threadIdx.x / tpi;
  l.b = blockIdx.z * p.nb + l.img;
  l.live = l.b < p.B;
  l.c = lt % CC;
  l.ch = chunk * CC + l.c;
  l.u = l.img * CC + l.c;
  l.slice = lt / CC;
  l.nsl = tpi / CC;
  l.xs = sm.x + l.img * p.xr * p.xc * CC + l.c;
  l.gs = sm.g + l.img * p.gr * p.gw * CC + l.c;
  return l;
}

// The conv at box-local output (ly, lx): nine rounded products added in
// (ky, kx) order with a rounding after each add; xv, if given, receives the
// nine inputs.
template <int CC>
__device__ __forceinline__ float conv(const Plan& p, const float* xs, const float (&w)[9], int ly,
                                      int lx, float* xv = nullptr) {
  const float* base = xs + ((ly * p.s) * p.xc + lx * p.s) * CC;
  const int row = p.xc * CC;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float x = base[(k / 3) * row + (k % 3) * CC], t = __fmul_rn(x, w[k]);
    acc = k == 0 ? t : __fadd_rn(acc, t);
    if (xv) xv[k] = x;
  }
  return acc;
}

// Steps (qy, qx) by `step` positions along rows of `cols`.
__device__ __forceinline__ void advance(int& qy, int& qx, int step, int cols) {
  for (qx += step; qx >= cols; qx -= cols) ++qy;
}

// f(qy, qx) at positions first, first + step, ... of a rows x cols grid,
// row-major, in that order.
template <typename F>
__device__ __forceinline__ void for_positions(int first, int step, int rows, int cols, F f) {
  for (int qy = first / cols, qx = first % cols; qy < rows; advance(qy, qx, step, cols)) f(qy, qx);
}

// A group's sum over its 8 channels (8 neighbouring lanes), the same bits
// in each lane.
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Lanes that share one slice sum (slice_sum): the most, a power of two up
// to 32 and to nsl, with which the N * ncc sums still fit the CTA's threads
// (ops/depthwise_gn.py::slice_lanes is its twin).
__device__ __forceinline__ int slice_lanes(int n_sums, int nsl) {
  int lanes = 1;
  while (lanes < 32 && lanes < nsl && n_sums * lanes * 2 <= kThreads) lanes *= 2;
  return lanes;
}

// The sum of each thread's N values over the nsl slices of its (image,
// channel): out(j, u, sum) once for each value j and each u < nb * cc.
// Each sum is taken by `lanes` neighbouring lanes (slice_lanes), lane i
// adding slices [i nsl / lanes, (i + 1) nsl / lanes) in order, then a
// butterfly over the lanes: a fixed order, and the short serial chains keep
// the barrier's wait short. red holds N doubles a thread. With one slice a
// thread's values are the sums (no barrier); the caller's exchange then
// orders out's stores before their readers.
template <int CC, int N, typename Out>
__device__ __forceinline__ void slice_sum(const Plan& p, const Lane& l, const double (&v)[N],
                                          double* red, Out out) {
  const int ncc = p.nb * CC, nsl = l.nsl;
  if (nsl == 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) out(j, l.u, v[j]);
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) red[(j * nsl + l.slice) * ncc + l.u] = v[j];
  __syncthreads();
  const int lanes = slice_lanes(N * ncc, nsl), per = nsl / lanes;
  for (int o0 = 0; o0 < N * ncc * lanes; o0 += kThreads) {  // the same trip count in every thread
    const int o = o0 + threadIdx.x, id = o / lanes, part = o % lanes;
    double s = 0.0;
    if (id < N * ncc) {
      const double* r = red + (id / ncc * nsl + part * per) * ncc + id % ncc;
      for (int q = 0; q < per; ++q) s = __dadd_rn(s, r[q * ncc]);
    }
    for (int off = 1; off < lanes; off <<= 1) s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (id < N * ncc && part == 0) out(id / ncc, id % ncc, s);
  }
}

// A slot's sum over the cluster's ranks in rank order (its own value in a
// cluster of one).
__device__ __forceinline__ double rank_sum(const double* slot, int n) {
  return n == 1 ? *slot : cluster_sum(slot, n);
}

// dx at the input whose dacc cell (output (ty, tx) at stride 1, (ty / 2,
// tx / 2) at stride 2, with ty = iy + pt, tx = ix + pl) is `cell`: the taps
// that reach it from (2, 2) down to (0, 0), each rounded product added to
// an f32 sum from 0. At stride 2 the parities (PY, PX) of (ty, tx) pick the
// taps (even: 2 then 0, one cell up or left, then the cell; odd: 1). At
// stride 1 the taps that fall outside the image read the ring's zero cells:
// a zero product added to the sum from 0 leaves it as it was.
template <int S, int PY, int PX>
__device__ __forceinline__ float dx_taps(const float* cell, int row, int col,
                                         const float (&w)[9]) {
  float acc = 0.f;
#pragma unroll
  for (int ky = 2; ky >= 0; --ky) {
    if (S == 2 && (ky & 1) != PY) continue;
    const int dy = S == 1 ? -ky : (ky == 2 ? -1 : 0);
#pragma unroll
    for (int kx = 2; kx >= 0; --kx) {
      if (S == 2 && (kx & 1) != PX) continue;
      const int dx = S == 1 ? -kx : (kx == 2 ? -1 : 0);
      acc = __fadd_rn(acc, __fmul_rn(cell[dy * row + dx * col], w[ky * 3 + kx]));
    }
  }
  return acc;
}

// dx at the tile's inputs of one parity class (stride 2; stride 1 has one
// class): rows iy0 + oy, iy0 + oy + S, ... below iy0 + ih, columns
// likewise, each thread every nsl-th of them from its slice.
template <int CC, int S, int PY, int PX>
__device__ __forceinline__ void dx_class(const Plan& p, const Lane& l, const Tile& t, int iy0,
                                         int ix0, int ih, int iw, const float (&w)[9],
                                         float* __restrict__ dx) {
  const int oy = (PY - iy0 - p.pt) & (S - 1), ox = (PX - ix0 - p.pl) & (S - 1);
  const int ny = (ih - oy + S - 1) / S, nx = (iw - ox + S - 1) / S;
  const int row = p.gw * CC;
  if (!l.live || nx == 0) return;  // nx 0: a single column of the other parity
  for_positions(l.slice, l.nsl, ny, nx, [&](int qy, int qx) {
    const int iy = iy0 + oy + qy * S, ix = ix0 + ox + qx * S;
    const int cy = (iy + p.pt) / S - (t.r0 - 1), cx = (ix + p.pl) / S - (t.c0 - 1);
    dx[((static_cast<int64_t>(l.b) * p.H + iy) * p.W + ix) * p.C + l.ch] =
        dx_taps<S, PY, PX>(l.gs + cy * row + cx * CC, row, CC, w);
  });
}

// One element's terms from its conv output a and upstream gradient g:
// xc = a - mean, yn, dz (the gradient past ReLU6) and dyn = dz * scale.
struct Terms {
  float xc, yn, dz, dyn;
};

__device__ __forceinline__ Terms terms(float a, float g, float m, float inv, float sc, float bi,
                                       int relu6) {
  Terms e;
  e.xc = __fsub_rn(a, m);
  e.yn = __fmul_rn(e.xc, inv);
  const float y = __fadd_rn(__fmul_rn(e.yn, sc), bi);
  e.dz = relu6 ? __fmul_rn(g, relu6_grad(y)) : g;
  e.dyn = __fmul_rn(e.dz, sc);
  return e;
}

template <int CC>
__global__ void __launch_bounds__(kThreads, kBlocks) bwd_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_g,
    const float* __restrict__ w, const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ dx, float* __restrict__ dw_part, float* __restrict__ ds_part,
    float* __restrict__ db_part, const Plan p, float eps, int relu6) {
  const Smem<F32> sm = carve<F32>(p);
  const int rank = static_cast<int>(cluster_rank()), chunk = blockIdx.y;
  const Lane l = lane_of<CC>(p, sm, chunk);
  constexpr int kGc = CC / kGroup;
  const int ncc = p.nb * CC;
  double* xch_ds = sm.xch + p.nb * 2 * kGc;  // [nb * cc]
  double* xch_db = xch_ds + ncc;             // [nb * cc]
  double* xch_d = xch_db + ncc;              // [nb][2][gc]
  double* xch_dw = xch_d + p.nb * 2 * kGc;   // [9][nb * cc]
  const int grp = (l.img * kGc + l.c / kGroup) * 8;  // the thread's statistics in sm.st
  // the slot of value j of a group sum at u
  auto group_slot = [&](int j, int u) { return ((u / CC) * 2 + j) * kGc + u % CC / kGroup; };
  const bool resident = start(p, &tm_x, &tm_g, sm, rank, chunk);
  float wr[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wr[k] = w[k * p.C + l.ch];
  const float sc = scale[l.ch], bi = bias[l.ch];
  __syncthreads();  // the mbarriers thread 0 set up
  uint32_t phase = 0;
  Tile t;
  if (resident) {
    mbar_wait(sm.bar, 0);
    phase = 1;
  }

  // pass 1: the statistics (box-local outputs start one ring in)
  {
    double v[2] = {0.0, 0.0};
    for (int i = 0; i < p.tiles && tile_of(p, rank, i, t); ++i) {
      if (!resident) fetch(p, &tm_x, &tm_g, sm, t, chunk, phase);
      for_positions(l.slice, l.nsl, t.rr, t.cw, [&](int qy, int qx) {
        const float a = conv<CC>(p, l.xs, wr, 1 + qy, 1 + qx);
        v[0] = __dadd_rn(v[0], a);
        v[1] = __dadd_rn(v[1], __fmul_rn(a, a));
      });
    }
    v[0] = group_sum(v[0]);
    v[1] = group_sum(v[1]);
    slice_sum<CC>(p, l, v, sm.red, [&](int j, int u, double s) {
      if (u % kGroup == 0) sm.xch[group_slot(j, u)] = s;
    });
    exchange_sync(p);
    stats_from_slots(p, sm, eps);
  }
  const float m = sm.st[grp], inv = sm.st[grp + 2];

  if (resident) mbar_wait(sm.bar + 1, 0);  // the g box

  // pass 2: dscale, dbias per channel; sum(dyn * inv) and sum(dyn * xc) per group
  {
    double v[kSliceValues] = {0.0, 0.0, 0.0, 0.0};
    for (int i = 0; i < p.tiles && tile_of(p, rank, i, t); ++i) {
      if (!resident) fetch(p, &tm_x, &tm_g, sm, t, chunk, phase);
      for_positions(l.slice, l.nsl, t.rr, t.cw, [&](int qy, int qx) {
        const int ly = 1 + qy, lx = 1 + qx;
        const float a = conv<CC>(p, l.xs, wr, ly, lx);
        const Terms e = terms(a, l.gs[(ly * p.gw + lx) * CC], m, inv, sc, bi, relu6);
        v[0] = __dadd_rn(v[0], __fmul_rn(e.dz, e.yn));
        v[1] = __dadd_rn(v[1], e.dz);
        v[2] = __dadd_rn(v[2], __fmul_rn(e.dyn, inv));
        v[3] = __dadd_rn(v[3], __fmul_rn(e.dyn, e.xc));
      });
    }
    v[2] = group_sum(v[2]);
    v[3] = group_sum(v[3]);
    slice_sum<CC>(p, l, v, sm.red, [&](int j, int u, double s) {
      if (j < 2)
        (j == 0 ? xch_ds : xch_db)[u] = s;
      else if (u % kGroup == 0)
        xch_d[group_slot(j - 2, u)] = s;
    });
    exchange_sync(p);
    stat_grads_from_slots(p, sm.st, xch_d, eps);
    const int u = threadIdx.x, b = blockIdx.z * p.nb + u / CC;
    if (rank == 0 && u < ncc && b < p.B) {
      const int64_t at = static_cast<int64_t>(b) * p.C + chunk * CC + u % CC;
      ds_part[at] = __double2float_rn(rank_sum(xch_ds + u, p.cluster));
      db_part[at] = __double2float_rn(rank_sum(xch_db + u, p.cluster));
    }
    __syncthreads();
  }
  const float kv = sm.st[grp + 4], km = sm.st[grp + 5];

  // pass 3, tile by tile: the cotangent over the tile and its ring (in
  // place of g), dw's nine sums over the tile's outputs, dx over the inputs
  // it owns
  double dw[9] = {};
  for (int i = 0; i < p.tiles && tile_of(p, rank, i, t); ++i) {
    if (!resident) fetch(p, &tm_x, &tm_g, sm, t, chunk, phase);
    const int ew = t.cw + 2;
    // the ring's cells outside the image keep the copy's zero fill of g:
    // their cotangent, 0. At the tile's own outputs the conv's nine inputs
    // then give dw's nine products.
    const int ly0 = t.r0 == 0, lx0 = t.c0 == 0;
    const int ly1 = min(t.rr + 2, p.OH - t.r0 + 1), lx1 = min(t.cw + 2, p.OW - t.c0 + 1);
    for_positions(l.slice, l.nsl, ly1 - ly0, lx1 - lx0, [&](int qy, int qx) {
      const int ly = ly0 + qy, lx = lx0 + qx;
      float* cell = l.gs + (ly * p.gw + lx) * CC;
      float xv[9];
      const float a = conv<CC>(p, l.xs, wr, ly, lx, xv);
      const Terms e = terms(a, *cell, m, inv, sc, bi, relu6);
      const float d =
          __fadd_rn(__fadd_rn(__fmul_rn(e.dyn, inv), __fmul_rn(__fmul_rn(2.f, a), kv)), km);
      *cell = d;
      if (ly >= 1 && ly <= t.rr && lx >= 1 && lx <= t.cw) {
#pragma unroll
        for (int k = 0; k < 9; ++k) dw[k] = __dadd_rn(dw[k], __fmul_rn(d, xv[k]));
      }
    });
    __syncthreads();
    // dx at the inputs this tile owns: rows [r0 * s, (r0 + rows) * s) and
    // columns likewise, clipped to the image; at stride 2 by parity class,
    // each class with its own taps
    const int iy0 = t.r0 * p.s, ix0 = t.c0 * p.s;
    const int ih = min((t.r0 + p.rows) * p.s, p.H) - iy0, iw = min((t.c0 + p.cols) * p.s, p.W) - ix0;
    if (p.s == 1) {
      dx_class<CC, 1, 0, 0>(p, l, t, iy0, ix0, ih, iw, wr, dx);
    } else {
      dx_class<CC, 2, 0, 0>(p, l, t, iy0, ix0, ih, iw, wr, dx);
      dx_class<CC, 2, 0, 1>(p, l, t, iy0, ix0, ih, iw, wr, dx);
      dx_class<CC, 2, 1, 0>(p, l, t, iy0, ix0, ih, iw, wr, dx);
      dx_class<CC, 2, 1, 1>(p, l, t, iy0, ix0, ih, iw, wr, dx);
    }
  }
  // dw: one slice sum of the nine taps in the x boxes' place, once every
  // thread has read its last x
  if (l.nsl > 1) __syncthreads();
  slice_sum<CC>(p, l, dw, reinterpret_cast<double*>(sm.x),
            [&](int k, int u, double s) { xch_dw[k * ncc + u] = s; });
  exchange_sync(p);
  if (rank == 0) {
    for (int v = threadIdx.x; v < 9 * ncc; v += kThreads) {
      const int k = v / ncc, u = v % ncc, b = blockIdx.z * p.nb + u / CC;
      if (b >= p.B) continue;
      dw_part[(static_cast<int64_t>(b) * 9 + k) * p.C + chunk * CC + u % CC] =
          __double2float_rn(rank_sum(xch_dw + v, p.cluster));
    }
  }
  if (p.cluster > 1) cluster_sync();  // no CTA leaves while rank 0 may still read its slots
}

using Kernel = decltype(&bwd_kernel<8>);

// The kernel for a chunk of cc channels (make_plan admits 8 to 128, a
// power of two).
Kernel kernel_of(int cc) {
  switch (cc) {
    case 8:
      return bwd_kernel<8>;
    case 16:
      return bwd_kernel<16>;
    case 32:
      return bwd_kernel<32>;
    case 64:
      return bwd_kernel<64>;
    default:
      return bwd_kernel<128>;
  }
}

}  // namespace f32bwd

// Kernel 11 in f32: the forward on f32 activations, one channel a thread.
//
// The same cut as the bf16 forward (dwgn_plan: a cluster a (batch element,
// chunk of cc channels), tiles of rows x cols outputs, nb small images side
// by side, resident or streamed) and the same passes and exchange, but a
// thread owns ONE channel of its image (c = its index mod cc, f32bwd's Lane)
// and a share of the tile's columns: the tile is cut into units, each one
// column of up to `strip` rows (unit u = (row block j, column x), numbered
// j * cols + x), and slice `slice` of nsl = kThreads / (nb * cc) takes
// units slice, slice + nsl, ... A thread walks each of its units down the
// column with the conv's 3 x 3 window in registers, sliding it S rows an
// output: 3 S new inputs an output where a fresh window reads 9.
// Neighbouring threads read neighbouring channels of
// one position (4-byte loads, conflict-free from cc 32 up; at stride 2 a
// warp of cc 8 or 16 meets 2-way conflicts). The kernel is built for each
// chunk width (fwd_kernel<CC>), so that the window's offsets are
// immediates. __launch_bounds__ holds it to 64 registers (kBlocks = 4),
// so that a plan's shared memory alone sets its CTAs an SM: 4 up to 56 KB,
// 2 at the plan's target of 112 KB (SMEM_TARGET[(False, 4)]; asked for 2
// CTAs, ptxas takes 87 registers and the small plans lose their third and
// fourth CTA). One CTA's copy and barriers overlap another's passes.
//   - Pass 1 adds each conv output and its square into two f64 sums a
//     thread; a plan that keeps the conv output (`keep`, resident plans
//     only) also stores it into the output tile, where pass 2 reads it
//     back instead of computing the conv again (one 4-byte load against
//     3 S). The statistics take a 3-step butterfly over the group's 8
//     neighbouring lanes (group_sum: the same bits in all 8) and one slice
//     sum of 2 values (f32bwd::slice_sum), then the cluster's ranks in
//     order through the exchange slots: the f32 of f64 sums of the same
//     f32 terms as the plain version's, the same bits at every launch.
//   - Pass 2 turns each conv output into y (the affine in f32, ReLU6). A
//     plan that keeps the conv output turns the tile into y in place and
//     sends it with one TMA store (the copy drops what lies outside the
//     tensor: the image's edge, a batch's last CTA); otherwise each thread
//     stores its own (a warp's stores are whole 32-byte sectors).
// A thread's units are its own in both passes, so the passes meet only at
// the exchange (and a kept tile at the barrier before its copy out).
namespace f32fwd {

// CTAs an SM __launch_bounds__ asks for (ops/depthwise_gn.py F32_FWD_BLOCKS,
// the most its plan search counts on)
constexpr int kBlocks = 4;

// f32bwd's Lane for the forward: gs points at channel c of its image's kept
// conv-output tile.
template <int CC>
__device__ __forceinline__ f32bwd::Lane lane_of(const Plan& p, const Smem<F32>& sm, int chunk) {
  const int tpi = kThreads / p.nb, lt = threadIdx.x % tpi;
  f32bwd::Lane l;
  l.img = threadIdx.x / tpi;
  l.b = blockIdx.z * p.nb + l.img;
  l.live = l.b < p.B;
  l.c = lt % CC;
  l.ch = chunk * CC + l.c;
  l.u = l.img * CC + l.c;
  l.slice = lt / CC;
  l.nsl = tpi / CC;
  l.xs = sm.x + l.img * p.xr * p.xc * CC + l.c;
  l.gs = sm.g + l.img * p.rows * p.cols * CC + l.c;
  return l;
}

// f(y0, y1, x) for each unit of this thread's slice in tile t: column x,
// rows y0 to y1 - 1 (ops/depthwise_gn.py::_unit_of mirrors the numbering).
template <typename F>
__device__ __forceinline__ void for_units(const Plan& p, const f32bwd::Lane& l, const Tile& t,
                                          F f) {
  // unit u = j * cw + x, stepped by nsl without a division a unit
  const int blocks = (t.rr + p.strip - 1) / p.strip, dj = l.nsl / t.cw, dx = l.nsl - dj * t.cw;
  for (int j = l.slice / t.cw, x = l.slice - j * t.cw; j < blocks;) {
    const int y0 = j * p.strip;
    f(y0, min(y0 + p.strip, t.rr), x);
    x += dx;
    j += dj;
    if (x >= t.cw) {
      x -= t.cw;
      ++j;
    }
  }
}

// The conv down column x of the box, outputs y0 to y1 - 1: f(oy, a) for
// each, a the nine rounded products added in (ky, kx) order with a
// rounding after each add. The window slides S input rows an output.
template <int CC, int S, typename F>
__device__ __forceinline__ void conv_column(const Plan& p, const float* xs, const float (&w)[9],
                                            int y0, int y1, int x, F f) {
  const int row = p.xc * CC;
  const float* at = xs + (y0 * S * p.xc + x * S) * CC;  // the first window's top left
  float v[9];
#pragma unroll
  for (int r = 0; r < 3 - S; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) v[3 * (r + S) + k] = at[r * row + k * CC];
  at += (3 - S) * row;
  for (int oy = y0; oy < y1; ++oy) {
#pragma unroll
    for (int k = 0; k < 9 - 3 * S; ++k) v[k] = v[k + 3 * S];
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) v[9 - 3 * S + 3 * r + k] = at[r * row + k * CC];
    at += S * row;
    float acc = __fmul_rn(v[0], w[0]);
#pragma unroll
    for (int k = 1; k < 9; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], w[k]));
    f(oy, acc);
  }
}

// f(oy, ox, a) at every output of this thread's units of tile t, the conv
// computed from the box.
template <int CC, typename F>
__device__ __forceinline__ void conv_units(const Plan& p, const f32bwd::Lane& l,
                                           const float (&w)[9], const Tile& t, F f) {
  if (p.s == 1) {
    for_units(p, l, t, [&](int y0, int y1, int x) {
      conv_column<CC, 1>(p, l.xs, w, y0, y1, x, [&](int oy, float a) { f(oy, x, a); });
    });
  } else {
    for_units(p, l, t, [&](int y0, int y1, int x) {
      conv_column<CC, 2>(p, l.xs, w, y0, y1, x, [&](int oy, float a) { f(oy, x, a); });
    });
  }
}

template <int CC>
__global__ void __launch_bounds__(kThreads, kBlocks) fwd_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_y,
    const float* __restrict__ w, const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, const Plan p, float eps, int relu6) {
  const Smem<F32> sm = carve<F32>(p);
  const int rank = static_cast<int>(cluster_rank()), chunk = blockIdx.y;
  const f32bwd::Lane l = lane_of<CC>(p, sm, chunk);
  constexpr int kGc = CC / kGroup;
  const int grp = (l.img * kGc + l.c / kGroup) * 8;  // the thread's statistics in sm.st
  const bool resident = start(p, &tm_x, &tm_x, sm, rank, chunk);
  float wr[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wr[k] = w[k * p.C + l.ch];
  const float sc = scale[l.ch], bi = bias[l.ch];
  __syncthreads();  // the mbarrier thread 0 set up
  uint32_t phase = 0;
  Tile t;
  if (resident) {
    mbar_wait(sm.bar, 0);
    phase = 1;
  }

  // pass 1: the statistics (and the kept conv output)
  {
    double v[2] = {0.0, 0.0};
    for (int i = 0; i < p.tiles && tile_of(p, rank, i, t); ++i) {
      if (!resident) fetch(p, &tm_x, &tm_x, sm, t, chunk, phase);
      conv_units<CC>(p, l, wr, t, [&](int oy, int ox, float a) {
        v[0] = __dadd_rn(v[0], a);
        v[1] = __dadd_rn(v[1], __fmul_rn(a, a));
        if (p.keep) l.gs[(oy * p.cols + ox) * CC] = a;
      });
    }
    v[0] = f32bwd::group_sum(v[0]);
    v[1] = f32bwd::group_sum(v[1]);
    f32bwd::slice_sum<CC>(p, l, v, sm.red, [&](int j, int u, double s) {
      if (u % kGroup == 0) sm.xch[((u / CC) * 2 + j) * kGc + u % CC / kGroup] = s;
    });
    exchange_sync(p);
    stats_from_slots(p, sm, eps);
  }
  const float m = sm.st[grp], inv = sm.st[grp + 2];

  // pass 2: y
  auto y_of = [&](float a) {
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(a, m), inv), sc), bi);
    return relu6 ? fminf(fmaxf(y, 0.f), 6.f) : y;
  };
  if (p.keep) {  // resident: the tile in place, then one copy out
    tile_of(p, rank, 0, t);
    for_units(p, l, t, [&](int y0, int y1, int x) {
      for (int oy = y0; oy < y1; ++oy) {
        float* cell = l.gs + (oy * p.cols + x) * CC;
        *cell = y_of(*cell);
      }
    });
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) tma_store_nhwc(&tm_y, sm.g, chunk * CC, t.c0, t.r0, blockIdx.z * p.nb);
  } else {
    for (int i = 0; i < p.tiles && tile_of(p, rank, i, t); ++i) {
      if (!resident) fetch(p, &tm_x, &tm_x, sm, t, chunk, phase);
      float* o = out + (static_cast<int64_t>(l.b) * p.OH + t.r0) * p.OW * p.C + t.c0 * p.C + l.ch;
      if (l.live)
        conv_units<CC>(p, l, wr, t,
                       [&](int oy, int ox, float a) { o[(oy * p.OW + ox) * p.C] = y_of(a); });
    }
  }
  if (p.cluster > 1) cluster_sync();  // no CTA leaves while another may still read its slots
}

using Kernel = decltype(&fwd_kernel<8>);

// The kernel for a chunk of cc channels (make_plan admits 8 to 128, a
// power of two).
Kernel kernel_of(int cc) {
  switch (cc) {
    case 8:
      return fwd_kernel<8>;
    case 16:
      return fwd_kernel<16>;
    case 32:
      return fwd_kernel<32>;
    case 64:
      return fwd_kernel<64>;
    default:
      return fwd_kernel<128>;
  }
}

}  // namespace f32fwd

// The backward kernel of element type T for a chunk of cc channels: the
// template's for bf16; f32bwd's, built for each chunk width, for f32.
template <typename T>
auto bwd_kernel_of(int cc) {
  if constexpr (T::kItemsize == 2) {
    return dwgn_bwd_kernel<T>;
  } else {
    return f32bwd::kernel_of(cc);
  }
}

// Opts a kernel into the card's whole shared memory once.
template <typename Kernel>
int opt_in(Kernel kernel, bool& done) {
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemLimit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

// Launches grid (cluster, C / cc, ceil(B / nb)) in clusters of `cluster` CTAs.
template <typename... Exp, typename... Act>
int launch_cluster(void (*kernel)(Exp...), const Plan& p, cudaStream_t st, Act&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.C / p.cc, (p.B + p.nb - 1) / p.nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The forward of element type T: the bf16 template's, or (strip, keep set)
// f32fwd's, built for each chunk width.
template <typename T>
int dwgn_fwd(const void* x, const void* w, const void* scale, const void* bias, void* out, int B,
             int H, int W, int C, int stride, float eps, int relu6, int cc, int rows, int cols,
             int cluster, int tiles, int nb, int strip, int keep, int smem, void* stream) {
  Plan p;
  if (!make_plan(p, B, H, W, C, stride, T::kItemsize, cc, rows, cols, cluster, tiles, nb, 0, strip,
                 keep) ||
      p.smem != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x;
  int err = dftt::hopper::make_nhwc_map(&tm_x, x, B, H, W, C, cc, p.xc, p.xr, nb, T::kItemsize);
  if (err) return err;
  using E = typename T::Elem;
  if constexpr (T::kItemsize == 2) {
    static bool opted = false;
    err = opt_in(dwgn_fwd_kernel<T>, opted);
    if (err) return err;
    return launch_cluster(dwgn_fwd_kernel<T>, p, static_cast<cudaStream_t>(stream), tm_x,
                          static_cast<const E*>(w), static_cast<const float*>(scale),
                          static_cast<const float*>(bias), static_cast<E*>(out), p, eps, relu6);
  } else {
    // the kept tile leaves as one box {cc, cols, rows, nb} of y
    CUtensorMap tm_y;
    err = dftt::hopper::make_nhwc_map(&tm_y, out, B, p.OH, p.OW, C, cc, cols, rows, nb, 4);
    static bool opted[kMaxChunk / kGroup + 1] = {};
    const auto kernel = f32fwd::kernel_of(cc);
    if (!err) err = opt_in(kernel, opted[cc / kGroup]);
    if (err) return err;
    return launch_cluster(kernel, p, static_cast<cudaStream_t>(stream), tm_x, tm_y,
                          static_cast<const E*>(w), static_cast<const float*>(scale),
                          static_cast<const float*>(bias), static_cast<E*>(out), p, eps, relu6);
  }
}

template <typename T>
int dwgn_bwd(const void* x, const void* w, const void* scale, const void* bias, const void* g,
             void* dx, void* dw_part, void* ds_part, void* db_part, int B, int H, int W, int C,
             int stride, float eps, int relu6, int cc, int rows, int cols, int cluster, int tiles,
             int nb, int smem, void* stream) {
  Plan p;
  if (!make_plan(p, B, H, W, C, stride, T::kItemsize, cc, rows, cols, cluster, tiles, nb, 1) ||
      p.smem != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_g;
  int err = dftt::hopper::make_nhwc_map(&tm_x, x, B, H, W, C, cc, p.xc, p.xr, nb, T::kItemsize);
  if (!err)
    err = dftt::hopper::make_nhwc_map(&tm_g, g, B, p.OH, p.OW, C, cc, p.gw, p.gr, nb,
                                      T::kItemsize);
  const auto kernel = bwd_kernel_of<T>(cc);
  static bool opted[kMaxChunk / kGroup + 1] = {};
  if (!err) err = opt_in(kernel, opted[cc / kGroup]);
  if (err) return err;
  using E = typename T::Elem;
  return launch_cluster(kernel, p, static_cast<cudaStream_t>(stream), tm_x, tm_g,
                        static_cast<const E*>(w), static_cast<const float*>(scale),
                        static_cast<const float*>(bias), static_cast<E*>(dx),
                        static_cast<float*>(dw_part), static_cast<float*>(ds_part),
                        static_cast<float*>(db_part), p, eps, relu6);
}

}  // namespace

// x: [B, H, W, C] NHWC contiguous, bf16 (_bf16) or f32 (_f32); w: [3, 3, C]
// in x's dtype; scale, bias: [C] f32; out: [B, OH, OW, C] in x's dtype. C a
// multiple of 8, stride 1 or 2, x 16-byte aligned. cc, rows, cols, cluster,
// tiles, nb (and for f32, strip and keep) and smem are the plan
// (ops/depthwise_gn.py::dwgn_plan at x's itemsize); a plan this source
// cannot run, or whose shared memory differs from its layout's (a plan for
// the other dtype among them), returns cudaErrorInvalidValue. Launches on
// `stream`; returns a CUDA error code (0 = launched). The f32 entry runs
// f32fwd::fwd_kernel<cc>.
extern "C" int dftt_dwgn_fwd_bf16(const void* x, const void* w, const void* scale,
                                  const void* bias, void* out, int B, int H, int W, int C,
                                  int stride, float eps, int relu6, int cc, int rows, int cols,
                                  int cluster, int tiles, int nb, int smem, void* stream) {
  return dwgn_fwd<Bf16>(x, w, scale, bias, out, B, H, W, C, stride, eps, relu6, cc, rows, cols,
                        cluster, tiles, nb, 0, 0, smem, stream);
}
extern "C" int dftt_dwgn_fwd_f32(const void* x, const void* w, const void* scale, const void* bias,
                                 void* out, int B, int H, int W, int C, int stride, float eps,
                                 int relu6, int cc, int rows, int cols, int cluster, int tiles,
                                 int nb, int strip, int keep, int smem, void* stream) {
  return dwgn_fwd<F32>(x, w, scale, bias, out, B, H, W, C, stride, eps, relu6, cc, rows, cols,
                       cluster, tiles, nb, strip, keep, smem, stream);
}

// As the forward, plus g: [B, OH, OW, C] in x's dtype (16-byte aligned);
// dx: [B, H, W, C] in x's dtype; dw_part: [B, 3, 3, C] f32; ds_part,
// db_part: [B, C] f32. The f32 entry runs f32bwd::bwd_kernel<cc>.
#define DWGN_BWD_ENTRY(name, T)                                                                \
  extern "C" int name(const void* x, const void* w, const void* scale, const void* bias,       \
                      const void* g, void* dx, void* dw_part, void* ds_part, void* db_part,     \
                      int B, int H, int W, int C, int stride, float eps, int relu6, int cc,     \
                      int rows, int cols, int cluster, int tiles, int nb, int smem,             \
                      void* stream) {                                                          \
    return dwgn_bwd<T>(x, w, scale, bias, g, dx, dw_part, ds_part, db_part, B, H, W, C, stride, \
                       eps, relu6, cc, rows, cols, cluster, tiles, nb, smem, stream);          \
  }
DWGN_BWD_ENTRY(dftt_dwgn_bwd_bf16, Bf16)
DWGN_BWD_ENTRY(dftt_dwgn_bwd_f32, F32)

// CTAs of the f32 backward (_bwd_) or forward (_fwd_) for a chunk of cc
// channels an SM holds at `smem` bytes of dynamic shared memory a CTA (the
// runtime's occupancy calculator), or minus a CUDA error.
template <typename Kernel>
int ctas_per_sm(Kernel (*kernel_of)(int), int cc, int smem, bool (&opted)[kMaxChunk / kGroup + 1]) {
  if (cc < kGroup || cc > kMaxChunk || cc & (cc - 1)) return -static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kernel_of(cc);
  int err = opt_in(kernel, opted[cc / kGroup]), n = 0;
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem));
  return err ? -err : n;
}
extern "C" int dftt_dwgn_bwd_f32_ctas_per_sm(int cc, int smem) {
  static bool opted[kMaxChunk / kGroup + 1] = {};
  return ctas_per_sm(f32bwd::kernel_of, cc, smem, opted);
}
extern "C" int dftt_dwgn_fwd_f32_ctas_per_sm(int cc, int smem) {
  static bool opted[kMaxChunk / kGroup + 1] = {};
  return ctas_per_sm(f32fwd::kernel_of, cc, smem, opted);
}
