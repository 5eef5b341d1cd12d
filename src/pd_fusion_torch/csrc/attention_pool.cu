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
// path's training shape B=16, L=48, H=256 that is about 0.8 MB, about
// 0.24 us at 3.35 TB/s: the launch (a few us) dominates, not the memory.
//
// Design, simple first: grid (B, ceil(H / kThreads)), one block per bag
// and column chunk, each thread owns one output column. The block
// recomputes its bag's softmax (L is small: two block reductions with warp
// shuffles), stages the weights in shared memory kTile at a time, then each
// thread walks l and accumulates w_l * h[b,l,col] in f32, so the reads of h
// run coalesced along H. Tails of L and H are masked, so every L >= 1 and
// H >= 1 is taken. expf, not __expf. Several bags per block, float4 loads
// and fusing the score projection are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // weights staged in shared memory per pass over L
constexpr float kMaskedScore = -1e9f;

__device__ __forceinline__ float masked_score(const float* s, const float* m, int l) {
  return m[l] > 0.0f ? s[l] : kMaskedScore;
}

// Block-wide reduction; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : (kMax ? -INFINITY : 0.0f);
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  __syncthreads();  // red is reused by the next reduction
  return v;
}

__global__ void __launch_bounds__(kThreads)
attention_pool_fwd_kernel(const float* __restrict__ scores, const float* __restrict__ mask,
                          const float* __restrict__ h, float* __restrict__ pooled,
                          float* __restrict__ weights, int L, int H) {
  __shared__ float red[kWarps];
  __shared__ float w_tile[kTile];

  const long long b = blockIdx.x;
  const float* s = scores + b * L;
  const float* m = mask + b * L;
  const float* hb = h + b * (long long)L * H;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  const bool write_weights = blockIdx.y == 0;

  float mx = -INFINITY;
  for (int l = threadIdx.x; l < L; l += kThreads) mx = fmaxf(mx, masked_score(s, m, l));
  mx = block_reduce<true>(mx, red);

  float z = 0.0f;
  for (int l = threadIdx.x; l < L; l += kThreads) z += expf(masked_score(s, m, l) - mx);
  z = block_reduce<false>(z, red);

  float acc = 0.0f;
  for (int l0 = 0; l0 < L; l0 += kTile) {
    const int n = min(kTile, L - l0);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float w = expf(masked_score(s, m, l0 + i) - mx) / z;
      w_tile[i] = w;
      if (write_weights) weights[b * L + l0 + i] = w;
    }
    __syncthreads();
    if (col < H) {
      const float* hp = hb + (long long)l0 * H + col;
      for (int i = 0; i < n; ++i) acc += w_tile[i] * hp[(long long)i * H];
    }
    __syncthreads();  // w_tile is rewritten by the next tile
  }
  if (col < H) pooled[b * H + col] = acc;
}

}  // namespace

// C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int attention_pool_forward(const float* scores, const float* mask, const float* h,
                                      float* pooled, float* weights, int B, int L, int H,
                                      void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)((H + kThreads - 1) / kThreads));
  attention_pool_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      scores, mask, h, pooled, weights, L, H);
  return (int)cudaGetLastError();
}
