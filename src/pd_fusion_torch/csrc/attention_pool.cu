// Masked-softmax attention pooling for MIL bags, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K1 of the JAX package:
// src/pd_fusion/ops/pallas_mil.py::_attention_pool_kernel (launched by
// _pallas_pool). Per bag b:
//   masked_l = mask[b,l] > 0 ? scores[b,l] : -1e9
//   w_l      = exp(masked_l - max_l masked_l) / sum_l exp(...)
//   pooled_h = sum_l w_l * h[b,l,h]
// Outputs: pooled [B,H] f32 and weights [B,L] f32. An all-masked bag has
// every entry at -1e9 and pools to the uniform mean, as in the JAX package
// (-1e9, not -inf, so no inf - inf = NaN).
//
// What bounds it on an H100: it moves 4*(B*L*H + 3*B*L + B*H) bytes
// (h, scores and mask read once; pooled and weights written once) and does
// about 2*B*L*H flops, far below the card's float32 rate. At the MIL CV
// path's training shape B=16, L=48, H=256 that is about 0.8 MB, 0.24 us at
// 3.35 TB/s: below the device time of the least launch (about 1.0-1.3 us,
// chip_smoke.py's launch_floor_ms). So the time is the launch plus the
// chain of dependent steps inside one block, and the design shortens that
// chain; at B=80 (4 MB) the copy of h takes a large part of it.
//
// Design. The launch arithmetic (grid, block, shared memory, path,
// staging) is made in Python, ops/attention_pool.py::launch_config, where
// the CPU tests reach it; this file takes those values as given.
// - Grid (B, ceil(H / chunk)): one block per bag and column chunk. Chunks
//   narrow (64 -> 16 columns) until the grid has 64 blocks, so a small
//   batch still spreads over the SMs.
// - h moves first: before the softmax, each thread starts a cp.async
//   (16-byte; 4-byte on the scalar path) of exactly the elements of h it
//   will sum, into dynamic shared memory, so the softmax runs while they are
//   in flight and no block barrier stands between copy and sum. A tile too
//   large for one buffer is staged through two buffers in a loop over L.
// - Each warp does the softmax on its own, with no block-wide reduction and
//   no __syncthreads: for L <= 96 each lane keeps at most 3 scores in
//   registers; warp-shuffle max and sum; expf once per score, then one
//   reciprocal (a divide per weight cost more than the rest of the
//   softmax). A general loop covers longer bags. The weights go to the
//   warp's own shared memory; warp 0 of the chunk holding column 0 writes
//   them out.
// - The bag is split across lanes: each warp owns chunk / 4 of the block's
//   columns, its lanes read float4 along them and split L into row groups
//   (8 at 64 columns), each summing four rows a step in registers; shuffles
//   add the row groups. The serial chain is about L / 8, not L, and no
//   shared-memory reduction or barrier follows.
// - Alignment: float4 needs 16-byte addresses. Rows start on 16 bytes only
//   when H % 4 == 0 and h's pointer is 16-byte aligned; else the wrapper
//   picks the scalar path, which copies and sums one float at a time,
//   inside this kernel. Tails of L and H are masked, so every L >= 1 and
//   H >= 1 is taken. expf, not __expf.
// TMA bulk copies on an mbarrier, and a thread-block cluster per bag that
// splits L, were built and timed against this design on an H100; both were
// slower at every shape timed (PERF.md), and neither is kept.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmemBytes = 232448;  // what one block may have on sm_90
constexpr int kRegScores = 3;          // scores a lane keeps in registers: L <= 96
constexpr float kMaskedScore = -1e9f;

// The values of launch_config's `path` (ops/attention_pool.py::PATHS).
enum Path : int { kScalar = 0, kVec4 = 1 };

__device__ __forceinline__ float masked_score(const float* s, const float* m, int l) {
  const float score = s[l];  // both loads issued together
  return m[l] > 0.0f ? score : kMaskedScore;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Row l's weight, given the bag's (max, 1 / normaliser).
__device__ __forceinline__ float weight(const float* s, const float* m, int l, float2 sm) {
  return expf(masked_score(s, m, l) - sm.x) * sm.y;
}

// One warp: the max and 1 / normaliser of the L scores at s (mask m).
// Writes their weights to w (global) when given, and the first n of them to
// ws (this warp's shared memory).
__device__ float2 warp_softmax(const float* s, const float* m, int L, float* w, float* ws,
                               int n) {
  const int lane = threadIdx.x & 31;
  float2 sm;
  if (L <= 32 * kRegScores) {
    float v[kRegScores];
    float vmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < kRegScores; ++k) {
      const int l = lane + 32 * k;
      v[k] = l < L ? masked_score(s, m, l) : -INFINITY;
      vmax = fmaxf(vmax, v[k]);
    }
    sm.x = warp_max(vmax);
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kRegScores; ++k) {
      v[k] = lane + 32 * k < L ? expf(v[k] - sm.x) : 0.0f;
      sum += v[k];
    }
    sm.y = 1.0f / warp_sum(sum);  // one division: a divide per weight costs more than the rest
#pragma unroll
    for (int k = 0; k < kRegScores; ++k) {
      const int l = lane + 32 * k;
      const float wl = v[k] * sm.y;
      if (w != nullptr && l < L) w[l] = wl;
      if (l < n) ws[l] = wl;
    }
  } else {
    float vmax = -INFINITY;
#pragma unroll 4
    for (int l = lane; l < L; l += 32) vmax = fmaxf(vmax, masked_score(s, m, l));
    sm.x = warp_max(vmax);
    float sum = 0.0f;
#pragma unroll 4
    for (int l = lane; l < L; l += 32) sum += expf(masked_score(s, m, l) - sm.x);
    sm.y = 1.0f / warp_sum(sum);
    if (w != nullptr)
      for (int l = lane; l < L; l += 32) w[l] = weight(s, m, l, sm);
    for (int l = lane; l < n; l += 32) ws[l] = weight(s, m, l, sm);
  }
  __syncwarp();
  return sm;
}

// Starts copying one stage: `rows` rows (row stride H in src, `chunk` in
// buf). Each thread copies the elements it will sum itself (the kVec
// columns at c of rows rg, rg + groups, ...), so it needs no barrier to
// read them.
template <int kVec>
__device__ void load_stage(float* buf, const float* src, int rows, int cols, int chunk, int H,
                           int c, int rg, int groups) {
  if (c >= cols) return;
  for (int r = rg; r < rows; r += groups) {
    if constexpr (kVec == 4)
      cp_async_16(buf + r * chunk + c, src + (size_t)r * H + c);
    else
      cp_async_4(buf + r * chunk + c, src + (size_t)r * H + c);
  }
}

// Shared memory, as launch_config counts it: [weights: one array of
// stage_rows floats per warp, padded to 16 B][h: n_buffers x stage_rows x
// chunk floats].
template <int kPath>
__global__ void __launch_bounds__(kMaxThreads)
attention_pool_fwd_kernel(const float* __restrict__ scores, const float* __restrict__ mask,
                          const float* __restrict__ h, float* __restrict__ pooled,
                          float* __restrict__ weights, int L, int H, int chunk, int stage_rows,
                          int n_buffers) {
  constexpr int kVec = kPath == kScalar ? 1 : 4;
  extern __shared__ __align__(128) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  float* ws = smem + warp * stage_rows;
  float* tile = smem + ((n_warps * stage_rows + 3) & ~3);

  const int bag = blockIdx.x;
  const int col0 = blockIdx.y * chunk;
  const int cols = min(chunk, H - col0);
  const int n_stages = (L + stage_rows - 1) / stage_rows;
  const float* s = scores + (size_t)bag * L;
  const float* m = mask + (size_t)bag * L;
  const float* hb = h + (size_t)bag * L * H + col0;

  // warp -> chunk / n_warps columns; lane -> the kVec columns at c of rows
  // rg, rg + groups, ... (lanes_per_row lanes per row, a power of two)
  const int lanes_per_row = chunk / (n_warps * kVec);
  const int lane_shift = __ffs(lanes_per_row) - 1;
  const int c = (warp * lanes_per_row + (lane & (lanes_per_row - 1))) * kVec;
  const int rg = lane >> lane_shift;
  const int groups = 32 >> lane_shift;

  auto stage_len = [&](int st) { return min(stage_rows, L - st * stage_rows); };
  auto buffer = [&](int st) { return tile + (st % n_buffers) * stage_rows * chunk; };
  auto issue = [&](int st) {  // one cp.async group per stage, empty past the last
    if (st < n_stages)
      load_stage<kVec>(buffer(st), hb + (size_t)st * stage_rows * H, stage_len(st), cols, chunk,
                       H, c, rg, groups);
    cp_async_commit();
  };

  // 1. start moving h
  issue(0);
  if (n_buffers == 2) issue(1);

  // 2. meanwhile each warp: the softmax, and the weights of its first stage
  const bool writes = blockIdx.y == 0 && warp == 0;
  const float2 sm =
      warp_softmax(s, m, L, writes ? weights + (size_t)bag * L : nullptr, ws, stage_len(0));

  // 3. the weighted sum of each stage, four rows a step
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
  const bool active = c < cols;
  for (int st = 0; st < n_stages; ++st) {
    const int n = stage_len(st);
    if (st > 0) {  // this stage's weights, into the warp's array
      __syncwarp();
      for (int i = lane; i < n; i += 32) ws[i] = weight(s, m, st * stage_rows + i, sm);
      __syncwarp();
    }
    if (n_buffers == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    const float* buf = buffer(st) + c;
    if (active) {
      for (int r = rg; r < n; r += 4 * groups) {
        float w[4], x[4][kVec];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ru = r + u * groups;
          w[u] = ru < n ? ws[ru] : 0.0f;
          if constexpr (kVec == 4) {
            const float4 v = ru < n ? *reinterpret_cast<const float4*>(buf + ru * chunk)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            x[u][0] = v.x;
            x[u][1] = v.y;
            x[u][2] = v.z;
            x[u][3] = v.w;
          } else {
            x[u][0] = ru < n ? buf[ru * chunk] : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[j] = fmaf(w[u], x[u][j], acc[j]);
        }
      }
    }
    // refill the buffer just read: this thread's own elements, so no barrier
    if (st + n_buffers < n_stages)
      issue(st + n_buffers);
    else
      cp_async_commit();
  }

  // 4. add the warp's row groups by shuffles: lanes [0, lanes_per_row) get
  // the sums of the warp's columns
  for (int off = 16; off >= lanes_per_row; off >>= 1) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  if (lane < lanes_per_row && active) {
    float* out = pooled + (size_t)bag * H + col0 + c;
    if constexpr (kVec == 4)
      *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    else
      out[0] = acc[0];
  }
}

}  // namespace

// C interface, bound with ctypes.
//
// attention_pool_configure: lets both instantiations take up to 227 KB of
// dynamic shared memory. Call once per device before the first launch.
extern "C" int attention_pool_configure() {
  const void* kernels[] = {
      reinterpret_cast<const void*>(&attention_pool_fwd_kernel<kScalar>),
      reinterpret_cast<const void*>(&attention_pool_fwd_kernel<kVec4>),
  };
  for (const void* k : kernels) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// attention_pool_forward: launches on `stream` with the launch values of
// launch_config, does not synchronise, and returns the launch's error
// (0 on success).
extern "C" int attention_pool_forward(const float* scores, const float* mask, const float* h,
                                      float* pooled, float* weights, int L, int H, int grid_x,
                                      int grid_y, int threads, int smem_bytes, int path,
                                      int chunk, int stage_rows, int n_buffers, void* stream) {
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y, 1);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (path) {
    case kScalar:
      attention_pool_fwd_kernel<kScalar><<<grid, threads, smem_bytes, st>>>(
          scores, mask, h, pooled, weights, L, H, chunk, stage_rows, n_buffers);
      break;
    case kVec4:
      attention_pool_fwd_kernel<kVec4><<<grid, threads, smem_bytes, st>>>(
          scores, mask, h, pooled, weights, L, H, chunk, stage_rows, n_buffers);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
