// Fused depthwise 3x3 (SAME) + GroupNorm(8) + affine + ReLU6, forward and
// backward, over bf16 NHWC activations.
//
// Replaces the Pallas TPU kernels of the JAX package
//   distriflow_tpu/ops/depthwise_gn.py::_fwd_kernel  (kernel 11)
//   distriflow_tpu/ops/depthwise_gn.py::_bwd_kernel  (kernel 12, the jax.vjp
//                                                     of the same tile)
//
// Arithmetic (depthwise_gn.py:141-177): the conv adds the nine products
// x * w[ky, kx] in (ky, kx) order, each product and each sum rounded to
// bf16 (done in f32 with __fmul_rn/__fadd_rn, which nvcc never contracts
// into an FMA, then rounded: the f32 product of two bf16 values is exact and
// the f32 sum of two rounds to the same bf16). Statistics per (batch, group
// of 8 channels) over all output positions in f32: mean, E[x^2],
// inv = rsqrt(max(E[x^2] - mean^2, 0) + eps); y = bf16((x - mean) * inv *
// scale + bias), then min(max(y, 0), 6). The backward is the exact
// derivative jax.vjp takes of that tile: at y == 0 and y == 6 half the
// gradient passes, as does the variance clamp at 0; the conv-output
// cotangent is rounded to bf16 and the nine dx contributions are added in
// bf16 from tap (2, 2) down to (0, 0). dw, dscale, dbias leave the kernel as
// per-batch f32 partials (dw rounded to bf16 per batch, as the tile's dw
// is), summed over the batch outside in a fixed order: no atomics, so every
// run gives the same bits.
//
// Every sum over a group's or a channel's positions (the statistics, the
// statistics' gradients, dscale, dbias; dw over the threads) is accumulated
// in f64 and rounded to f32 once, so it is the f32 of the exact sum, in
// whatever order the threads add. The plain versions do the same, so the
// two agree bit for bit where JAX's f32 sums would leave them apart by
// their orders: the one-pass variance E[x^2] - E[x]^2 of a group whose
// values are nearly constant (flat image regions) cancels, and f32 sums in
// two orders then give variances, and outputs, percent apart.
//
// Grid. The TPU kernel keeps a (batch, channel-block) tile at full spatial
// extent in VMEM. Here a block of 256 threads owns one batch element and up
// to 32 groups (blockIdx = (group chunk, batch)); thread t takes group
// t % gb and every (256 / gb)-th output position, so neighbouring threads
// read neighbouring 16-byte group vectors (one load per position, tap and
// group). Group statistics need every position of a group, and a 112x112
// group does not fit shared memory, so nothing is kept: the forward walks
// its positions twice (statistics, then output), recomputing the conv; the
// second walk reads what the first just brought into L1/L2. The backward's
// first kernel walks three times (statistics; dscale, dbias and the
// statistics' gradients; the conv-output cotangent and dw) and writes the
// cotangent to a bf16 scratch; its second kernel, one thread per (input
// position, group), gathers the nine taps of that cotangent into dx. Shapes
// of one MobileNetV2 step at 96 px and B 256 range from 48x48x32 (256
// blocks, 36 positions a thread) to 3x3x960 (1,024 blocks, 9 positions).
//
// Bound: a few f32 operations per element against 2 bytes read and 2
// written, so bytes bound both kernels (forward: x read, y written;
// backward: x and g read, dx written).

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroupsPerBlock = 32;
constexpr int kGroup = 8;

struct Geo {
  int B, H, W, C, G, s, OH, OW, pt, pl, P, gb, nps;
};

Geo make_geo(int B, int H, int W, int C, int s) {
  Geo q;
  q.B = B;
  q.H = H;
  q.W = W;
  q.C = C;
  q.G = C / kGroup;
  q.s = s;
  const int th = std::max(((H + s - 1) / s - 1) * s + 3 - H, 0);
  const int tw = std::max(((W + s - 1) / s - 1) * s + 3 - W, 0);
  q.pt = th / 2;
  q.pl = tw / 2;
  q.OH = (H + th - 3) / s + 1;
  q.OW = (W + tw - 3) / s + 1;
  q.P = q.OH * q.OW;
  q.gb = std::min(q.G, kMaxGroupsPerBlock);
  q.nps = kThreads / q.gb;
  return q;
}

__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  __align__(16) __nv_bfloat162 o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}

// The 8 input values of group g at tap (ky, kx) of output (oy, ox); zeros
// in the SAME padding.
__device__ __forceinline__ void tap8(const __nv_bfloat16* xb, const Geo& q, int oy, int ox, int ky,
                                     int kx, int g, float* v) {
  const int iy = oy * q.s + ky - q.pt, ix = ox * q.s + kx - q.pl;
  if (iy >= 0 && iy < q.H && ix >= 0 && ix < q.W) {
    dftt::load8(xb + ((int64_t)iy * q.W + ix) * q.C + g * kGroup, v);
  } else {
#pragma unroll
    for (int c = 0; c < kGroup; ++c) v[c] = 0.f;
  }
}

// The conv at output position p for group g: nine rounded products added
// in (ky, kx) order with a rounding after each add. w: [9][8] in shared.
__device__ __forceinline__ void conv8(const __nv_bfloat16* xb, const Geo& q, int p, int g,
                                      const float* w, float* acc) {
  const int oy = p / q.OW, ox = p % q.OW;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float v[kGroup];
    tap8(xb, q, oy, ox, k / 3, k % 3, g, v);
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      const float t = rb(__fmul_rn(v[c], w[k * kGroup + c]));
      acc[c] = k == 0 ? t : rb(__fadd_rn(acc[c], t));
    }
  }
}

// Per-thread state: this thread's group (local and global) and position slot.
struct Lane {
  int gl, ps, g, b;
  bool active;
};

__device__ __forceinline__ Lane lane(const Geo& q) {
  Lane l;
  l.gl = threadIdx.x % q.gb;
  l.ps = threadIdx.x / q.gb;
  l.g = blockIdx.x * q.gb + l.gl;
  l.b = blockIdx.y;
  l.active = l.ps < q.nps && l.g < q.G;
  return l;
}

// The block's groups' depthwise weights into shared memory as f32.
__device__ __forceinline__ void load_weights(const __nv_bfloat16* w, const Geo& q, const Lane& l,
                                             float (*sw)[9 * kGroup]) {
  if (l.active && l.ps == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) dftt::load8(w + k * q.C + l.g * kGroup, &sw[l.gl][k * kGroup]);
  }
  __syncthreads();
}

// Sum over position slots of each group's per-thread values, in slot
// order; returns the sum to thread gl < gb (the others get 0).
__device__ __forceinline__ double group_sum(double v, const Geo& q, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x < q.gb) {
    for (int i = 0; i < q.nps; ++i) s = __dadd_rn(s, red[i * q.gb + threadIdx.x]);
  }
  __syncthreads();
  return s;
}

// Sum over position slots of each (group, channel) value; thread
// gl * 8 + c receives the sum of channel c of local group gl.
template <typename T>
__device__ __forceinline__ double channel_sum(const T* v, const Geo& q, double* red) {
#pragma unroll
  for (int c = 0; c < kGroup; ++c) red[threadIdx.x * kGroup + c] = v[c];
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x < q.gb * kGroup) {
    const int gl = threadIdx.x / kGroup, c = threadIdx.x % kGroup;
    for (int i = 0; i < q.nps; ++i) s = __dadd_rn(s, red[(i * q.gb + gl) * kGroup + c]);
  }
  __syncthreads();
  return s;
}

struct Stats {
  float m, var, inv;
};

// Pass over every position: each group's mean, E[x^2] - mean^2 and inv,
// broadcast to the block through shared memory.
__device__ Stats group_stats(const __nv_bfloat16* xb, const Geo& q, const Lane& l,
                             const float* w, float eps, double* red, Stats* sh) {
  double s = 0.0, ss = 0.0;
  if (l.active) {
    for (int p = l.ps; p < q.P; p += q.nps) {
      float acc[kGroup];
      conv8(xb, q, p, l.g, w, acc);
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        s = __dadd_rn(s, acc[c]);
        ss = __dadd_rn(ss, __fmul_rn(acc[c], acc[c]));
      }
    }
  }
  s = group_sum(s, q, red);
  ss = group_sum(ss, q, red);
  if (threadIdx.x < q.gb) {
    const double n = static_cast<double>(q.P * kGroup);
    const float m = __double2float_rn(__ddiv_rn(s, n)), m2 = __double2float_rn(__ddiv_rn(ss, n));
    const float var = __fsub_rn(m2, __fmul_rn(m, m));
    sh[threadIdx.x] = {m, var, rsqrtf(__fadd_rn(fmaxf(var, 0.f), eps))};
  }
  __syncthreads();
  return sh[l.gl];
}

__global__ void __launch_bounds__(kThreads) dwgn_fwd_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, Geo q, float eps, int relu6) {
  __shared__ float sw[kMaxGroupsPerBlock][9 * kGroup];
  __shared__ double red[kThreads];
  __shared__ Stats sh[kMaxGroupsPerBlock];
  const Lane l = lane(q);
  const __nv_bfloat16* xb = x + (int64_t)l.b * q.H * q.W * q.C;
  load_weights(w, q, l, sw);
  const Stats st = group_stats(xb, q, l, sw[l.gl], eps, red, sh);
  if (!l.active) return;
  float sc[kGroup], bi[kGroup];
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    sc[c] = scale[l.g * kGroup + c];
    bi[c] = bias[l.g * kGroup + c];
  }
  __nv_bfloat16* ob = out + (int64_t)l.b * q.P * q.C + l.g * kGroup;
  for (int p = l.ps; p < q.P; p += q.nps) {
    float acc[kGroup];
    conv8(xb, q, p, l.g, sw[l.gl], acc);
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      const float yn = __fmul_rn(__fsub_rn(acc[c], st.m), st.inv);
      float y = rb(__fadd_rn(__fmul_rn(yn, sc[c]), bi[c]));
      if (relu6) y = fminf(fmaxf(y, 0.f), 6.f);
      acc[c] = y;
    }
    store8(ob + (int64_t)p * q.C, acc);
  }
}

// d(min(max(y, 0), 6))/dy as jax.vjp takes it: 1 inside, 0.5 on a bound.
__device__ __forceinline__ float relu6_grad(float y) {
  const float lo = y > 0.f ? 1.f : (y == 0.f ? 0.5f : 0.f);
  const float hi = y < 6.f ? 1.f : (y == 6.f ? 0.5f : 0.f);
  return lo * hi;
}

// Per element of one position: xc = x - mean and dyn, the gradient of the
// normalized value, from the upstream gradient.
struct Elem {
  float xc[kGroup], dz[kGroup], yn[kGroup], dyn[kGroup];
};

__device__ __forceinline__ void elem(const float* acc, const float* gv, const Stats& st,
                                     const float* sc, const float* bi, int relu6, Elem& e) {
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    e.xc[c] = __fsub_rn(acc[c], st.m);
    e.yn[c] = __fmul_rn(e.xc[c], st.inv);
    const float y = rb(__fadd_rn(__fmul_rn(e.yn[c], sc[c]), bi[c]));
    e.dz[c] = relu6 ? __fmul_rn(gv[c], relu6_grad(y)) : gv[c];
    e.dyn[c] = __fmul_rn(e.dz[c], sc[c]);
  }
}

__global__ void __launch_bounds__(kThreads) dwgn_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ gout, __nv_bfloat16* __restrict__ dacc,
    float* __restrict__ dw_part, float* __restrict__ ds_part, float* __restrict__ db_part,
    Geo q, float eps, int relu6) {
  __shared__ float sw[kMaxGroupsPerBlock][9 * kGroup];
  __shared__ double red[kThreads * kGroup];
  __shared__ Stats sh[kMaxGroupsPerBlock];
  __shared__ float2 coef[kMaxGroupsPerBlock];  // (dvar / n, dm / n) per group
  const Lane l = lane(q);
  const __nv_bfloat16* xb = x + (int64_t)l.b * q.H * q.W * q.C;
  const int64_t out_off = (int64_t)l.b * q.P * q.C + l.g * kGroup;
  load_weights(w, q, l, sw);
  const Stats st = group_stats(xb, q, l, sw[l.gl], eps, red, sh);
  float sc[kGroup], bi[kGroup];
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    sc[c] = l.active ? scale[l.g * kGroup + c] : 0.f;
    bi[c] = l.active ? bias[l.g * kGroup + c] : 0.f;
  }

  // walk 2: dscale, dbias per channel; sum(dxc) and sum(dyn * xc) per group
  double ds[kGroup] = {}, db[kGroup] = {}, sdxc = 0.0, sdinv = 0.0;
  if (l.active) {
    for (int p = l.ps; p < q.P; p += q.nps) {
      float acc[kGroup], gv[kGroup];
      conv8(xb, q, p, l.g, sw[l.gl], acc);
      dftt::load8(gout + out_off + (int64_t)p * q.C, gv);
      Elem e;
      elem(acc, gv, st, sc, bi, relu6, e);
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        ds[c] = __dadd_rn(ds[c], __fmul_rn(e.dz[c], e.yn[c]));
        db[c] = __dadd_rn(db[c], e.dz[c]);
        sdxc = __dadd_rn(sdxc, __fmul_rn(e.dyn[c], st.inv));
        sdinv = __dadd_rn(sdinv, __fmul_rn(e.dyn[c], e.xc[c]));
      }
    }
  }
  const float dsum = __double2float_rn(channel_sum(ds, q, red));
  const float bsum = __double2float_rn(channel_sum(db, q, red));
  if (threadIdx.x < q.gb * kGroup) {
    const int c = (blockIdx.x * q.gb) * kGroup + threadIdx.x;
    if (c < q.C) {
      ds_part[(int64_t)l.b * q.C + c] = dsum;
      db_part[(int64_t)l.b * q.C + c] = bsum;
    }
  }
  sdxc = group_sum(sdxc, q, red);
  sdinv = group_sum(sdinv, q, red);
  if (threadIdx.x < q.gb) {
    const Stats s = sh[threadIdx.x];
    const float n = static_cast<float>(q.P * kGroup);
    const float dinv = __double2float_rn(sdinv), sxc = __double2float_rn(sdxc);
    float dvar = __fmul_rn(dinv, __fmul_rn(-0.5f, __fdiv_rn(s.inv, __fadd_rn(fmaxf(s.var, 0.f), eps))));
    dvar = __fmul_rn(dvar, s.var > 0.f ? 1.f : (s.var == 0.f ? 0.5f : 0.f));
    const float dm = __fsub_rn(-sxc, __fmul_rn(__fmul_rn(2.f, dvar), s.m));
    coef[threadIdx.x] = make_float2(__fdiv_rn(dvar, n), __fdiv_rn(dm, n));
  }
  __syncthreads();

  // walk 3: the conv-output cotangent (to the scratch) and dw per tap
  float dwa[9][kGroup] = {};
  if (l.active) {
    const float2 k2 = coef[l.gl];
    for (int p = l.ps; p < q.P; p += q.nps) {
      float acc[kGroup], gv[kGroup], da[kGroup];
      conv8(xb, q, p, l.g, sw[l.gl], acc);
      dftt::load8(gout + out_off + (int64_t)p * q.C, gv);
      Elem e;
      elem(acc, gv, st, sc, bi, relu6, e);
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        const float dxc = __fmul_rn(e.dyn[c], st.inv);
        da[c] = rb(__fadd_rn(__fadd_rn(dxc, __fmul_rn(__fmul_rn(2.f, acc[c]), k2.x)), k2.y));
      }
      store8(dacc + out_off + (int64_t)p * q.C, da);
      const int oy = p / q.OW, ox = p % q.OW;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        float v[kGroup];
        tap8(xb, q, oy, ox, k / 3, k % 3, l.g, v);
#pragma unroll
        for (int c = 0; c < kGroup; ++c) dwa[k][c] = __fadd_rn(dwa[k][c], rb(__fmul_rn(da[c], v[c])));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const double s = channel_sum(dwa[k], q, red);
    if (threadIdx.x < q.gb * kGroup) {
      const int c = (blockIdx.x * q.gb) * kGroup + threadIdx.x;
      if (c < q.C) dw_part[((int64_t)l.b * 9 + k) * q.C + c] = rb(__double2float_rn(s));
    }
  }
}

// dx at one (batch, input position, group): the cotangent at every output
// position whose taps cover it, times that tap's weight, added in bf16 from
// tap (2, 2) down to (0, 0).
__global__ void __launch_bounds__(kThreads) dwgn_bwd_dx_kernel(
    const __nv_bfloat16* __restrict__ dacc, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ dx, Geo q) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)q.B * q.H * q.W * q.G) return;
  const int g = static_cast<int>(idx % q.G);
  int64_t rest = idx / q.G;
  const int ix = static_cast<int>(rest % q.W);
  rest /= q.W;
  const int iy = static_cast<int>(rest % q.H);
  const int64_t b = rest / q.H;
  const int py = iy + q.pt, px = ix + q.pl;
  float acc[kGroup] = {};
  for (int ky = 2; ky >= 0; --ky) {
    const int ty = py - ky;
    if (ty < 0 || ty % q.s) continue;
    const int oy = ty / q.s;
    if (oy >= q.OH) continue;
    for (int kx = 2; kx >= 0; --kx) {
      const int tx = px - kx;
      if (tx < 0 || tx % q.s) continue;
      const int ox = tx / q.s;
      if (ox >= q.OW) continue;
      float d[kGroup], wv[kGroup];
      dftt::load8(dacc + ((b * q.OH + oy) * q.OW + ox) * q.C + g * kGroup, d);
      dftt::load8(w + (ky * 3 + kx) * q.C + g * kGroup, wv);
#pragma unroll
      for (int c = 0; c < kGroup; ++c) acc[c] = rb(__fadd_rn(acc[c], rb(__fmul_rn(d[c], wv[c]))));
    }
  }
  store8(dx + idx * kGroup, acc);
}

}  // namespace

// x: [B, H, W, C] bf16 NHWC contiguous; w: [3, 3, C] bf16; scale, bias: [C]
// f32; out: [B, OH, OW, C] bf16. C a multiple of 8, stride 1 or 2, every
// pointer 16-byte aligned. Launches on `stream`; returns cudaGetLastError().
extern "C" int dftt_dwgn_fwd_bf16(const void* x, const void* w, const void* scale,
                                  const void* bias, void* out, int B, int H, int W, int C,
                                  int stride, float eps, int relu6, void* stream) {
  const Geo q = make_geo(B, H, W, C, stride);
  const dim3 grid((q.G + q.gb - 1) / q.gb, B);
  dwgn_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), q, eps, relu6);
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus g: [B, OH, OW, C] bf16; dx: [B, H, W, C] bf16;
// dacc: [B, OH, OW, C] bf16 scratch; dw_part: [B, 3, 3, C] f32; ds_part,
// db_part: [B, C] f32.
extern "C" int dftt_dwgn_bwd_bf16(const void* x, const void* w, const void* scale,
                                  const void* bias, const void* g, void* dx, void* dacc,
                                  void* dw_part, void* ds_part, void* db_part, int B, int H,
                                  int W, int C, int stride, float eps, int relu6, void* stream) {
  const Geo q = make_geo(B, H, W, C, stride);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((q.G + q.gb - 1) / q.gb, B);
  dwgn_bwd_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dacc),
      static_cast<float*>(dw_part), static_cast<float*>(ds_part), static_cast<float*>(db_part),
      q, eps, relu6);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = (int64_t)B * H * W * q.G;
  dwgn_bwd_dx_kernel<<<static_cast<unsigned>((items + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(dacc), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(dx), q);
  return static_cast<int>(cudaGetLastError());
}
