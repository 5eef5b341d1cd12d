// Train-mode, image-weighted BatchNorm with its residual add and ReLU,
// forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package writes this BN in jnp
// (src/pd_fusion/nn/resnet.py, _bn with sample_weight) and XLA fuses it.
// The port wrote it as torch ops (nn/resnet.py), about 27 launches a BN
// forward and autograd's backward of each; on an H100 those elementwise
// and reduction kernels held about a third of the ResNet-50 fine-tune
// step's device time and about half of its ~7,100 launches (PERF.md), so
// the op is hot and is fused here. Wrapper, launch arithmetic and the plain
// PyTorch version: ops/weighted_bn.py.
//
// What it computes, for x [N, C, H, W] held channels-last (a [R = N*H*W, C]
// matrix, contiguous in C), w [N] image weights (nullptr: all 1):
//   n = sum_i w_i * H * W, mean = sum w x / n, var = sum w (x - mean)^2 / n,
//   y = relu?((x - mean) * rsqrt(var + eps) * gamma + beta [+ identity]),
//   running mean and variance moved by their EMA (the unbiased variance),
// and backward, with gz = gy * [y > 0] under the ReLU and xh = (x - mean) * inv:
//   dbeta = sum gz, dgamma = sum gz * xh (over every row),
//   dx = gamma * inv * (gz - (w / n) * dbeta - xh * (w / n) * dgamma), didentity = gz.
//
// What bounds it on an H100: bytes. It does a few flops an element against
// 4 bytes read or written, far below the ridge. The forward reads x twice
// (statistics, then the apply), reads the identity and writes y once; the
// backward reads gy, y and x twice (sums, then the apply) and writes dx and
// didentity once. At ResNet-50's stem (256 x 64 x 112^2, 822 MB a tensor)
// that is 0.74 ms forward and 1.72 ms backward at 3.35 TB/s; the least
// bytes, each tensor once, take 0.49 and 0.98 ms.
//
// Design.
// - Three launches each way: a tiled reduction to per-tile partials, a
//   finishing kernel that merges them, an elementwise apply. No float
//   atomics: every sum runs in a fixed order, so a call gives the same bits
//   on every run (the step's determinism, PERF.md).
// - Tiling (made in Python, weighted_bn.py::launch_config, where the CPU
//   tests reach it): 256 threads a block, `lanes` threads along C, each on
//   four channels (float4, 16-byte loads), and 256 / lanes row lanes; a
//   block takes a tile of rows by lanes * 4 channels, so a warp reads whole
//   256-byte rows or row segments. Tiles are sized so that the grid is
//   about one wave of 8 blocks on each of 132 SMs, from C = 64 at 3.2 M
//   rows to C = 2048 at 12,544 rows; each thread loads four rows before it
//   adds any, to keep loads in flight.
// - Statistics: each thread sums w (x - k) and w (x - k)^2 over its rows in
//   float32, k the tile's first row (a shift drawn from the data, so the
//   sum of squares does not cancel); the block adds its row lanes in a
//   fixed tree; the finishing kernel re-centres each tile's sums on tile
//   0's shift and adds the tiles in float64, 32 lanes a channel and a fixed
//   tree, then writes mean, rsqrt(var + eps), n and both EMAs in the launch.
// - Backward sums: the same tiling and trees for sum gz and sum gz * xh;
//   the finish writes dgamma, dbeta and the apply's three coefficients.
// - The per-channel values (gamma, beta, mean, inv, coefficients) are read
//   once a thread with scalar loads, so parameter tensors need no alignment.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;    // reduction and apply blocks
constexpr int kFinishLanes = 32; // finishing blocks: 32 channels x 32 lanes
constexpr int kUnroll = 4;       // rows loaded before any is added

__device__ __forceinline__ float4 ld4(const float* p, long long i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}
__device__ __forceinline__ void st4(float* p, long long i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}
__device__ __forceinline__ float4 f4(const float* p, int c) {
  return make_float4(p[c], p[c + 1], p[c + 2], p[c + 3]);
}
__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// The block's place: its tile of rows, its channel vector, its row lane.
struct Place {
  int lane, row_lane, row_lanes, v, cv, r0, r1;
  bool active;
};

__device__ __forceinline__ Place place(int R, int C, int lanes, int rows_per_tile) {
  Place p;
  p.lane = threadIdx.x % lanes;
  p.row_lane = threadIdx.x / lanes;
  p.row_lanes = kThreads / lanes;
  p.cv = C / 4;
  p.v = blockIdx.y * lanes + p.lane;
  p.active = p.v < p.cv;
  p.r0 = blockIdx.x * rows_per_tile;
  p.r1 = min(p.r0 + rows_per_tile, R);
  return p;
}

// ---- forward ----

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
wbn_stats_kernel(const float* __restrict__ x, const float* __restrict__ w, int R, int C, int HW,
                 int lanes, int rows_per_tile, int tiles, float* __restrict__ part,
                 float* __restrict__ part_n) {
  __shared__ float4 s_sum[kThreads];
  __shared__ float4 s_sq[kThreads];
  __shared__ float s_n[kThreads];
  const Place p = place(R, C, lanes, rows_per_tile);
  float4 sum = zero4(), sq = zero4(), k = zero4();
  float n = 0.f;
  if (p.active) {
    k = ld4(x, (long long)p.r0 * p.cv + p.v);
    const int step = p.row_lanes;
    int r = p.r0 + p.row_lane;
    for (; r + (kUnroll - 1) * step < p.r1; r += kUnroll * step) {
      float4 a[kUnroll];
      float wt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a[u] = ld4(x, (long long)(r + u * step) * p.cv + p.v);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) wt[u] = kWeighted ? __ldg(w + (r + u * step) / HW) : 1.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float dx = a[u].x - k.x, dy = a[u].y - k.y, dz = a[u].z - k.z, dw = a[u].w - k.w;
        sum.x = fmaf(wt[u], dx, sum.x); sum.y = fmaf(wt[u], dy, sum.y);
        sum.z = fmaf(wt[u], dz, sum.z); sum.w = fmaf(wt[u], dw, sum.w);
        sq.x = fmaf(wt[u] * dx, dx, sq.x); sq.y = fmaf(wt[u] * dy, dy, sq.y);
        sq.z = fmaf(wt[u] * dz, dz, sq.z); sq.w = fmaf(wt[u] * dw, dw, sq.w);
        n += wt[u];
      }
    }
    for (; r < p.r1; r += step) {
      const float4 a = ld4(x, (long long)r * p.cv + p.v);
      const float wt = kWeighted ? __ldg(w + r / HW) : 1.f;
      const float dx = a.x - k.x, dy = a.y - k.y, dz = a.z - k.z, dw = a.w - k.w;
      sum.x = fmaf(wt, dx, sum.x); sum.y = fmaf(wt, dy, sum.y);
      sum.z = fmaf(wt, dz, sum.z); sum.w = fmaf(wt, dw, sum.w);
      sq.x = fmaf(wt * dx, dx, sq.x); sq.y = fmaf(wt * dy, dy, sq.y);
      sq.z = fmaf(wt * dz, dz, sq.z); sq.w = fmaf(wt * dw, dw, sq.w);
      n += wt;
    }
  }
  s_sum[threadIdx.x] = sum;
  s_sq[threadIdx.x] = sq;
  s_n[threadIdx.x] = n;
  for (int h = p.row_lanes / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (p.row_lane < h) {
      add4(s_sum[threadIdx.x], s_sum[threadIdx.x + h * lanes]);
      add4(s_sq[threadIdx.x], s_sq[threadIdx.x + h * lanes]);
      s_n[threadIdx.x] += s_n[threadIdx.x + h * lanes];
    }
  }
  __syncthreads();
  if (p.row_lane == 0 && p.active) {
    // part: [3][tiles][C] sums, sums of squares, shifts; part_n: [tiles]
    const long long at = (long long)blockIdx.x * p.cv + p.v;
    st4(part, at, s_sum[threadIdx.x]);
    st4(part, (long long)tiles * p.cv + at, s_sq[threadIdx.x]);
    st4(part, 2LL * tiles * p.cv + at, k);
    if (p.v == 0) part_n[blockIdx.x] = s_n[threadIdx.x];
  }
}

// Merges the tiles of each channel; writes stats = [mean (C), inv (C), n]
// and the running statistics' EMA.
__global__ void __launch_bounds__(kFinishLanes * kFinishLanes)
wbn_stats_finish_kernel(const float* __restrict__ part, const float* __restrict__ part_n,
                        int tiles, int C, const float* __restrict__ running_mean,
                        const float* __restrict__ running_var, float keep, float momentum,
                        float eps, float* __restrict__ stats, float* __restrict__ new_mean,
                        float* __restrict__ new_var) {
  __shared__ double s[3][kFinishLanes][kFinishLanes + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kFinishLanes + tx;
  double S = 0.0, Q = 0.0, N = 0.0, k0 = 0.0;
  if (c < C) {
    const long long tc = (long long)tiles * C;
    k0 = part[2 * tc + c];
    for (int t = ty; t < tiles; t += kFinishLanes) {
      const long long at = (long long)t * C + c;
      const double nt = part_n[t], st = part[at], qt = part[tc + at];
      const double d = (double)part[2 * tc + at] - k0;  // this tile's shift against tile 0's
      S += st + nt * d;
      Q += qt + d * (2.0 * st + nt * d);
      N += nt;
    }
  }
  s[0][ty][tx] = S;
  s[1][ty][tx] = Q;
  s[2][ty][tx] = N;
  for (int h = kFinishLanes / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (ty < h) {
#pragma unroll
      for (int j = 0; j < 3; ++j) s[j][ty][tx] += s[j][ty + h][tx];
    }
  }
  __syncthreads();
  if (ty != 0 || c >= C) return;
  S = s[0][0][tx];
  Q = s[1][0][tx];
  N = s[2][0][tx];
  const double var = fmax(Q - S * S / N, 0.0) / N;
  const float mean = (float)(k0 + S / N);
  const float varf = (float)var;
  const float n = (float)N;
  stats[c] = mean;
  stats[C + c] = (float)(1.0 / sqrt((double)(varf + eps)));
  if (c == 0) stats[2 * C] = n;
  const float unbiased = varf * (n / fmaxf(n - 1.f, 1.f));
  new_mean[c] = keep * running_mean[c] + momentum * mean;
  new_var[c] = keep * running_var[c] + momentum * unbiased;
}

template <bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
wbn_apply_kernel(const float* __restrict__ x, const float* __restrict__ identity,
                 const float* __restrict__ stats, const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ y, int R, int C, int lanes,
                 int rows_per_tile) {
  const Place p = place(R, C, lanes, rows_per_tile);
  if (!p.active) return;
  const int c = 4 * p.v;
  const float4 mean = f4(stats, c), inv = f4(stats + C, c), g = f4(gamma, c), b = f4(beta, c);
  const float4 scale = make_float4(inv.x * g.x, inv.y * g.y, inv.z * g.z, inv.w * g.w);
  const int step = p.row_lanes;
  auto out = [&](float4 a, float4 id) {
    float4 o;
    o.x = (a.x - mean.x) * scale.x + b.x; o.y = (a.y - mean.y) * scale.y + b.y;
    o.z = (a.z - mean.z) * scale.z + b.z; o.w = (a.w - mean.w) * scale.w + b.w;
    if (kRes) add4(o, id);
    if (kRelu) {
      o.x = fmaxf(o.x, 0.f); o.y = fmaxf(o.y, 0.f); o.z = fmaxf(o.z, 0.f); o.w = fmaxf(o.w, 0.f);
    }
    return o;
  };
  int r = p.r0 + p.row_lane;
  for (; r + (kUnroll - 1) * step < p.r1; r += kUnroll * step) {
    float4 a[kUnroll], id[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = (long long)(r + u * step) * p.cv + p.v;
      a[u] = ld4(x, i);
      id[u] = kRes ? ld4(identity, i) : zero4();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      st4(y, (long long)(r + u * step) * p.cv + p.v, out(a[u], id[u]));
  }
  for (; r < p.r1; r += step) {
    const long long i = (long long)r * p.cv + p.v;
    st4(y, i, out(ld4(x, i), kRes ? ld4(identity, i) : zero4()));
  }
}

// ---- backward ----

template <bool kRelu>
__global__ void __launch_bounds__(kThreads)
wbn_bwd_reduce_kernel(const float* __restrict__ gy, const float* __restrict__ y,
                      const float* __restrict__ x, const float* __restrict__ stats, int R, int C,
                      int lanes, int rows_per_tile, int tiles, float* __restrict__ part) {
  __shared__ float4 s_g[kThreads];
  __shared__ float4 s_gx[kThreads];
  const Place p = place(R, C, lanes, rows_per_tile);
  float4 sg = zero4(), sgx = zero4();
  if (p.active) {
    const int c = 4 * p.v;
    const float4 mean = f4(stats, c), inv = f4(stats + C, c);
    const int step = p.row_lanes;
    auto acc = [&](float4 g, float4 yy, float4 a) {
      if (kRelu) {
        g.x = yy.x > 0.f ? g.x : 0.f; g.y = yy.y > 0.f ? g.y : 0.f;
        g.z = yy.z > 0.f ? g.z : 0.f; g.w = yy.w > 0.f ? g.w : 0.f;
      }
      add4(sg, g);
      sgx.x = fmaf(g.x, (a.x - mean.x) * inv.x, sgx.x);
      sgx.y = fmaf(g.y, (a.y - mean.y) * inv.y, sgx.y);
      sgx.z = fmaf(g.z, (a.z - mean.z) * inv.z, sgx.z);
      sgx.w = fmaf(g.w, (a.w - mean.w) * inv.w, sgx.w);
    };
    int r = p.r0 + p.row_lane;
    for (; r + (kUnroll - 1) * step < p.r1; r += kUnroll * step) {
      float4 g[kUnroll], yy[kUnroll], a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = (long long)(r + u * step) * p.cv + p.v;
        g[u] = ld4(gy, i);
        yy[u] = kRelu ? ld4(y, i) : zero4();
        a[u] = ld4(x, i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc(g[u], yy[u], a[u]);
    }
    for (; r < p.r1; r += step) {
      const long long i = (long long)r * p.cv + p.v;
      acc(ld4(gy, i), kRelu ? ld4(y, i) : zero4(), ld4(x, i));
    }
  }
  s_g[threadIdx.x] = sg;
  s_gx[threadIdx.x] = sgx;
  for (int h = p.row_lanes / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (p.row_lane < h) {
      add4(s_g[threadIdx.x], s_g[threadIdx.x + h * lanes]);
      add4(s_gx[threadIdx.x], s_gx[threadIdx.x + h * lanes]);
    }
  }
  __syncthreads();
  if (p.row_lane == 0 && p.active) {
    // part: [2][tiles][C] sums of gz, of gz * xh
    const long long at = (long long)blockIdx.x * p.cv + p.v;
    st4(part, at, s_g[threadIdx.x]);
    st4(part, (long long)tiles * p.cv + at, s_gx[threadIdx.x]);
  }
}

// Adds the tiles; writes dgamma, dbeta and coef = [gamma * inv, dbeta / n,
// dgamma / n] (3 x C).
__global__ void __launch_bounds__(kFinishLanes * kFinishLanes)
wbn_bwd_finish_kernel(const float* __restrict__ part, int tiles, int C,
                      const float* __restrict__ stats, const float* __restrict__ gamma,
                      float* __restrict__ dgamma, float* __restrict__ dbeta,
                      float* __restrict__ coef) {
  __shared__ double s[2][kFinishLanes][kFinishLanes + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kFinishLanes + tx;
  double G = 0.0, GX = 0.0;
  if (c < C) {
    const long long tc = (long long)tiles * C;
    for (int t = ty; t < tiles; t += kFinishLanes) {
      const long long at = (long long)t * C + c;
      G += part[at];
      GX += part[tc + at];
    }
  }
  s[0][ty][tx] = G;
  s[1][ty][tx] = GX;
  for (int h = kFinishLanes / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (ty < h) {
      s[0][ty][tx] += s[0][ty + h][tx];
      s[1][ty][tx] += s[1][ty + h][tx];
    }
  }
  __syncthreads();
  if (ty != 0 || c >= C) return;
  G = s[0][0][tx];
  GX = s[1][0][tx];
  const double n = stats[2 * C];
  dbeta[c] = (float)G;
  dgamma[c] = (float)GX;
  coef[c] = gamma[c] * stats[C + c];
  coef[C + c] = (float)(G / n);
  coef[2 * C + c] = (float)(GX / n);
}

template <bool kRelu, bool kRes, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
wbn_bwd_apply_kernel(const float* __restrict__ gy, const float* __restrict__ y,
                     const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ stats, const float* __restrict__ coef,
                     float* __restrict__ dx, float* __restrict__ didentity, int R, int C, int HW,
                     int lanes, int rows_per_tile) {
  const Place p = place(R, C, lanes, rows_per_tile);
  if (!p.active) return;
  const int c = 4 * p.v;
  const float4 mean = f4(stats, c), inv = f4(stats + C, c);
  const float4 a = f4(coef, c), b1 = f4(coef + C, c), b2 = f4(coef + 2 * C, c);
  const int step = p.row_lanes;
  auto one = [&](long long i, float4 g, float4 yy, float4 xx, float wt) {
    if (kRelu) {
      g.x = yy.x > 0.f ? g.x : 0.f; g.y = yy.y > 0.f ? g.y : 0.f;
      g.z = yy.z > 0.f ? g.z : 0.f; g.w = yy.w > 0.f ? g.w : 0.f;
    }
    float4 o;
    o.x = a.x * (g.x - wt * b1.x - (xx.x - mean.x) * inv.x * (wt * b2.x));
    o.y = a.y * (g.y - wt * b1.y - (xx.y - mean.y) * inv.y * (wt * b2.y));
    o.z = a.z * (g.z - wt * b1.z - (xx.z - mean.z) * inv.z * (wt * b2.z));
    o.w = a.w * (g.w - wt * b1.w - (xx.w - mean.w) * inv.w * (wt * b2.w));
    st4(dx, i, o);
    if (kRes) st4(didentity, i, g);
  };
  int r = p.r0 + p.row_lane;
  for (; r + (kUnroll - 1) * step < p.r1; r += kUnroll * step) {
    float4 g[kUnroll], yy[kUnroll], xx[kUnroll];
    float wt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = (long long)(r + u * step) * p.cv + p.v;
      g[u] = ld4(gy, i);
      yy[u] = kRelu ? ld4(y, i) : zero4();
      xx[u] = ld4(x, i);
      wt[u] = kWeighted ? __ldg(w + (r + u * step) / HW) : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      one((long long)(r + u * step) * p.cv + p.v, g[u], yy[u], xx[u], wt[u]);
  }
  for (; r < p.r1; r += step) {
    const long long i = (long long)r * p.cv + p.v;
    one(i, ld4(gy, i), kRelu ? ld4(y, i) : zero4(), ld4(x, i), kWeighted ? __ldg(w + r / HW) : 1.f);
  }
}

}  // namespace

// Each function launches on `stream` with the launch values of
// weighted_bn.py::launch_config (lanes, tiles, rows_per_tile; grid (tiles,
// chunks)), does not synchronise, and returns the first launch error (0 on
// success). Scratch `part` and every output are allocated by the caller.

// Forward: 3 launches. part: 3 * tiles * C + tiles floats; stats: 2 * C + 1.
extern "C" int wbn_forward(const float* x, const float* w, const float* identity,
                           const float* gamma, const float* beta, const float* running_mean,
                           const float* running_var, float keep, float momentum, float eps,
                           float* y, float* part, float* stats, float* new_mean, float* new_var,
                           int R, int C, int HW, int lanes, int chunks, int tiles,
                           int rows_per_tile, int relu, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)tiles, (unsigned)chunks);
  float* part_n = part + 3LL * tiles * C;
  if (w != nullptr)
    wbn_stats_kernel<true><<<grid, kThreads, 0, st>>>(x, w, R, C, HW, lanes, rows_per_tile, tiles,
                                                      part, part_n);
  else
    wbn_stats_kernel<false><<<grid, kThreads, 0, st>>>(x, w, R, C, HW, lanes, rows_per_tile,
                                                       tiles, part, part_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 fin_block(kFinishLanes, kFinishLanes);
  const unsigned fin_grid = (unsigned)((C + kFinishLanes - 1) / kFinishLanes);
  wbn_stats_finish_kernel<<<fin_grid, fin_block, 0, st>>>(part, part_n, tiles, C, running_mean,
                                                          running_var, keep, momentum, eps, stats,
                                                          new_mean, new_var);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool res = identity != nullptr;
  if (res && relu)
    wbn_apply_kernel<true, true><<<grid, kThreads, 0, st>>>(x, identity, stats, gamma, beta, y, R,
                                                            C, lanes, rows_per_tile);
  else if (res)
    wbn_apply_kernel<true, false><<<grid, kThreads, 0, st>>>(x, identity, stats, gamma, beta, y,
                                                             R, C, lanes, rows_per_tile);
  else if (relu)
    wbn_apply_kernel<false, true><<<grid, kThreads, 0, st>>>(x, identity, stats, gamma, beta, y,
                                                             R, C, lanes, rows_per_tile);
  else
    wbn_apply_kernel<false, false><<<grid, kThreads, 0, st>>>(x, identity, stats, gamma, beta, y,
                                                              R, C, lanes, rows_per_tile);
  return (int)cudaGetLastError();
}

// Backward: 3 launches. part: 2 * tiles * C floats; coef: 3 * C. y is read
// only under relu; didentity is written when it is not nullptr.
extern "C" int wbn_backward(const float* gy, const float* y, const float* x, const float* w,
                            const float* stats, const float* gamma, float* dx, float* didentity,
                            float* dgamma, float* dbeta, float* part, float* coef, int R, int C,
                            int HW, int lanes, int chunks, int tiles, int rows_per_tile, int relu,
                            void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)tiles, (unsigned)chunks);
  if (relu)
    wbn_bwd_reduce_kernel<true><<<grid, kThreads, 0, st>>>(gy, y, x, stats, R, C, lanes,
                                                           rows_per_tile, tiles, part);
  else
    wbn_bwd_reduce_kernel<false><<<grid, kThreads, 0, st>>>(gy, y, x, stats, R, C, lanes,
                                                            rows_per_tile, tiles, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 fin_block(kFinishLanes, kFinishLanes);
  const unsigned fin_grid = (unsigned)((C + kFinishLanes - 1) / kFinishLanes);
  wbn_bwd_finish_kernel<<<fin_grid, fin_block, 0, st>>>(part, tiles, C, stats, gamma, dgamma,
                                                        dbeta, coef);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int key = (relu ? 4 : 0) | (didentity != nullptr ? 2 : 0) | (w != nullptr ? 1 : 0);
#define WBN_BWD_APPLY(RELU, RES, W)                                                       \
  wbn_bwd_apply_kernel<RELU, RES, W><<<grid, kThreads, 0, st>>>(                          \
      gy, y, x, w, stats, coef, dx, didentity, R, C, HW, lanes, rows_per_tile)
  switch (key) {
    case 0: WBN_BWD_APPLY(false, false, false); break;
    case 1: WBN_BWD_APPLY(false, false, true); break;
    case 2: WBN_BWD_APPLY(false, true, false); break;
    case 3: WBN_BWD_APPLY(false, true, true); break;
    case 4: WBN_BWD_APPLY(true, false, false); break;
    case 5: WBN_BWD_APPLY(true, false, true); break;
    case 6: WBN_BWD_APPLY(true, true, false); break;
    default: WBN_BWD_APPLY(true, true, true); break;
  }
#undef WBN_BWD_APPLY
  return (int)cudaGetLastError();
}
