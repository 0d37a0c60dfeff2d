// Fused ProdLDA decode + reconstruction loss: hand-written CUDA kernels for
// Hopper (sm_90a), bound to Python with ctypes through a plain C interface.
//
// The function, per batch (theta [B,K], beta [K,V], x [B,V], row mask [B]):
//   z  = theta @ beta                          [B, V]
//   n  = (z - mean) * rsqrt(var + 1e-5)        batch-norm, affine-free
//   p  = softmax(n, axis=V)
//   rl = -sum_v x * log(p + 1e-10)             [B]
// No [B, V] array reaches device memory in either direction.
//
// Kernels, and the TPU kernels (gfedntm_tpu/ops/fused_decoder.py) they replace:
//   K1 stats_kernel + merge_softmax_kernel  <- _stats_kernel (:189-260) via _pass1_p (:500-533)
//      z, the masked per-column mean and biased variance (training) or the
//      running stats (eval), and the per-row online-softmax max m and
//      denominator s over valid rows and columns.
//   K2 loss_kernel + sum_partials_kernel    <- _loss_kernel (:266-317) via _pass2_p (:536-568)
//      recomputes z, n and p = exp(n - m)/s; the row loss and the row-dot
//      rd = sum_v x * p/(p + floor) that the backward needs.
//   K3 grads_kernel + sum_partials_kernel   <- _grads_kernel (:612-676) via _grads_p (:679-712)
//      recomputes p; gn = g * (p*rd - x*p/(p+floor)); the training-BN
//      correction gz = inv_std*(gn - mask*sum(gn*mask)/cnt - n*mask*sum(gn*n*mask)/cnt)
//      (eval: gz = gn*inv_std); g_beta = theta^T gz and g_theta = gz beta^T.
//
// Design. Each block owns a contiguous range of V columns and walks it in
// strips of 32 columns (one warp lane per column). theta [B,K] and the strip
// of beta sit in shared memory; because a block holds all B rows of each of
// its columns, the column batch statistics (and, in K3, the column sums of
// the BN correction) are exact inside the block. The per-row reductions over
// V (softmax max/denominator, loss, rd, g_theta) are carried across the
// block's strips in shared memory and written as [grid, B] (or [grid, B, K])
// partials, which a small kernel folds in a fixed order: the TPU carried them
// across its sequential grid, and CUDA blocks run in no order. No atomics,
// so results are deterministic for a given card. The three small products
// (z, g_beta, g_theta) are FP32 FMAs on the CUDA cores, summed in a fixed
// order. Ragged edges in B, K and V are masked here; inputs are unpadded and
// contiguous.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 without tensor cores) at
// B=256, K=50, V=100,000: K1 moves ~21 MB (6 us) and does 2BKV = 2.56 GFLOP
// (38 us), so FP32 operations bound it; K2 moves ~123 MB (37 us) for the same
// 2.56 GFLOP (38 us); K3 moves ~143 MB (43 us) for 3 x 2.56 GFLOP (115 us).
// All three are bound by FP32 operations on the CUDA cores. This simple
// design feeds each FMA from shared memory and is far from that bound. Left
// for later: TF32 or bf16 mma/wgmma for the three products, TMA loads of the
// beta and x strips into a multi-stage ring, and wider strips per block.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kStrip = 32;          // columns per strip: one lane per column
constexpr int kPitch = kStrip + 1;  // padded pitch of the beta strip rows
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 4;         // rows per thread in the strip product
constexpr int kTopicTile = 4;       // topics per thread in g_beta / g_theta
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind { kStats = 0, kLoss = 1, kGrads = 2 };

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// theta [B, K] -> shared [Bp, Kp], zero-padded.
__device__ void load_theta(float* th_s, const float* __restrict__ theta, int B, int K,
                           int Bp, int Kp) {
  for (int i = threadIdx.x; i < Bp * Kp; i += kThreads) {
    const int r = i / Kp, k = i - r * Kp;
    th_s[i] = (r < B && k < K) ? theta[(size_t)r * K + k] : 0.f;
  }
}

// beta[:, v0:v0+32] -> shared [Kp, kPitch], zero-padded past K and V.
__device__ void load_beta_strip(float* b_s, const float* __restrict__ beta, int K, int Kp,
                                int V, int v0) {
  for (int i = threadIdx.x; i < Kp * kStrip; i += kThreads) {
    const int k = i / kStrip, c = i - k * kStrip;
    const int v = v0 + c;
    b_s[k * kPitch + c] = (k < K && v < V) ? beta[(size_t)k * V + v] : 0.f;
  }
}

// z[rb + j, v0 + lane] for j < kRowTile, summed over k in order.
__device__ inline void strip_product(float (&acc)[kRowTile], const float* th_s,
                                     const float* b_s, int K, int Kp, int rb, int lane) {
#pragma unroll
  for (int j = 0; j < kRowTile; ++j) acc[j] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float b = b_s[k * kPitch + lane];
#pragma unroll
    for (int j = 0; j < kRowTile; ++j) acc[j] = fmaf(th_s[(rb + j) * Kp + k], b, acc[j]);
  }
}

// Shared memory of each kernel, in floats.
size_t smem_floats(int kind, int B, int K) {
  const size_t Bp = round_up(B, kRowTile), Kp = round_up(K, kTopicTile);
  switch (kind) {
    case kStats:  // theta, beta strip, z strip, mask/m/s rows, reduce, mean/istd, cnt
      return Bp * Kp + Kp * kPitch + Bp * kStrip + 3 * (size_t)B + kWarps * kStrip +
             2 * kStrip + 1;
    case kLoss:  // theta, beta strip, safe m/s, row ok, loss/rd rows, mean/istd
      return Bp * Kp + Kp * kPitch + 5 * (size_t)B + 2 * kStrip;
    case kGrads:  // theta, g_theta acc, beta strip, n/gz strips, 5 rows, 4 cols, reduce, cnt
      return 2 * Bp * Kp + Kp * kPitch + 2 * Bp * kStrip + 5 * (size_t)B + 4 * kStrip +
             2 * kWarps * kStrip + 1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// K1: batch-norm statistics + per-row online-softmax partials.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ theta, const float* __restrict__ beta,
             const float* __restrict__ mask, const float* __restrict__ run_mean,
             const float* __restrict__ run_var, float* __restrict__ mean_out,
             float* __restrict__ var_out, float* __restrict__ m_part,
             float* __restrict__ s_part, int B, int K, int V, int training, float eps,
             int strips_per_block) {
  extern __shared__ float smem[];
  const int Bp = round_up(B, kRowTile), Kp = round_up(K, kTopicTile);
  const int n_strips = (V + kStrip - 1) / kStrip;
  float* th_s = smem;
  float* b_s = th_s + Bp * Kp;
  float* z_s = b_s + Kp * kPitch;
  float* mk_s = z_s + Bp * kStrip;
  float* m_s = mk_s + B;
  float* s_s = m_s + B;
  float* red_s = s_s + B;
  float* mean_s = red_s + kWarps * kStrip;
  float* istd_s = mean_s + kStrip;
  float* cnt_s = istd_s + kStrip;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_theta(th_s, theta, B, K, Bp, Kp);
  for (int r = tid; r < B; r += kThreads) {
    mk_s[r] = mask[r];
    m_s[r] = kNegInf;
    s_s[r] = 0.f;
  }
  if (tid == 0) {
    float c = 0.f;
    for (int r = 0; r < B; ++r) c += mask[r];
    cnt_s[0] = fmaxf(c, 1.f);
  }
  __syncthreads();
  const float cnt = cnt_s[0];

  const int first = blockIdx.x * strips_per_block;
  const int last = min(first + strips_per_block, n_strips);
  for (int strip = first; strip < last; ++strip) {
    const int v0 = strip * kStrip;
    const int col = v0 + lane;
    const bool col_ok = col < V;
    load_beta_strip(b_s, beta, K, Kp, V, v0);
    __syncthreads();
    for (int rb = warp * kRowTile; rb < B; rb += kWarps * kRowTile) {
      float acc[kRowTile];
      strip_product(acc, th_s, b_s, K, Kp, rb, lane);
#pragma unroll
      for (int j = 0; j < kRowTile; ++j) z_s[(rb + j) * kStrip + lane] = acc[j];
    }
    __syncthreads();
    if (training) {
      // Exact masked column statistics: the block holds every row.
      float part = 0.f;
      for (int r = warp; r < B; r += kWarps) part += z_s[r * kStrip + lane] * mk_s[r];
      red_s[warp * kStrip + lane] = part;
      __syncthreads();
      if (warp == 0) {
        float t = 0.f;
        for (int w = 0; w < kWarps; ++w) t += red_s[w * kStrip + lane];
        mean_s[lane] = t / cnt;
      }
      __syncthreads();
      const float mu = mean_s[lane];
      part = 0.f;
      for (int r = warp; r < B; r += kWarps) {
        const float d = (z_s[r * kStrip + lane] - mu) * mk_s[r];
        part += d * d;
      }
      red_s[warp * kStrip + lane] = part;
      __syncthreads();
      if (warp == 0) {
        float t = 0.f;
        for (int w = 0; w < kWarps; ++w) t += red_s[w * kStrip + lane];
        const float var = t / cnt;  // biased
        istd_s[lane] = rsqrtf(var + eps);
        if (col_ok) {
          mean_out[col] = mu;
          var_out[col] = var;
        }
      }
    } else if (warp == 0) {
      const float mu = col_ok ? run_mean[col] : 0.f;
      const float var = col_ok ? run_var[col] : 1.f;
      mean_s[lane] = mu;
      istd_s[lane] = rsqrtf(var + eps);
      if (col_ok) {
        mean_out[col] = mu;
        var_out[col] = var;
      }
    }
    __syncthreads();
    const float mu = mean_s[lane], istd = istd_s[lane];
    for (int r = warp; r < B; r += kWarps) {
      const bool valid = col_ok && mk_s[r] > 0.f;
      const float n = valid ? (z_s[r * kStrip + lane] - mu) * istd : kNegInf;
      const float m_tile = warp_max(n);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, m_tile);
      // Guard fully-masked rows: exp(-1e30 - -1e30) would be 1.
      const float safe = fmaxf(m_new, 0.5f * kNegInf);
      const float e_sum = warp_sum(valid ? expf(n - safe) : 0.f);
      if (lane == 0) {
        s_s[r] = s_s[r] * expf(fminf(m_old - safe, 0.f)) + e_sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
  }
  for (int r = tid; r < B; r += kThreads) {
    m_part[(size_t)blockIdx.x * B + r] = m_s[r];
    s_part[(size_t)blockIdx.x * B + r] = s_s[r];
  }
}

// Folds the blocks' (max, denominator) partials in block order.
__global__ void merge_softmax_kernel(const float* __restrict__ m_part,
                                     const float* __restrict__ s_part, int grid, int B,
                                     float* __restrict__ m_out, float* __restrict__ s_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  float m = kNegInf;
  for (int g = 0; g < grid; ++g) m = fmaxf(m, m_part[(size_t)g * B + r]);
  const float safe = fmaxf(m, 0.5f * kNegInf);
  float s = 0.f;
  for (int g = 0; g < grid; ++g) {
    s += s_part[(size_t)g * B + r] * expf(fminf(m_part[(size_t)g * B + r] - safe, 0.f));
  }
  m_out[r] = m;
  s_out[r] = s;
}

// out[i] = sum_g part[g, i], in block order.
__global__ void sum_partials_kernel(const float* __restrict__ part, int grid, int n,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = 0.f;
  for (int g = 0; g < grid; ++g) t += part[(size_t)g * n + i];
  out[i] = t;
}

// ---------------------------------------------------------------------------
// K2: row loss and row-dot partials.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
loss_kernel(const float* __restrict__ theta, const float* __restrict__ beta,
            const float* __restrict__ x, const float* __restrict__ mean,
            const float* __restrict__ var, const float* __restrict__ m,
            const float* __restrict__ s, float* __restrict__ loss_part,
            float* __restrict__ rd_part, int B, int K, int V, float eps, float floor_,
            int strips_per_block) {
  extern __shared__ float smem[];
  const int Bp = round_up(B, kRowTile), Kp = round_up(K, kTopicTile);
  const int n_strips = (V + kStrip - 1) / kStrip;
  float* th_s = smem;
  float* b_s = th_s + Bp * Kp;
  float* sm_s = b_s + Kp * kPitch;
  float* sl_s = sm_s + B;
  float* ok_s = sl_s + B;
  float* loss_s = ok_s + B;
  float* rd_s = loss_s + B;
  float* mean_s = rd_s + B;
  float* istd_s = mean_s + kStrip;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_theta(th_s, theta, B, K, Bp, Kp);
  for (int r = tid; r < B; r += kThreads) {
    // Fully-masked rows have the (-inf, 0) sentinel: force them finite.
    const bool ok = s[r] > 1e-20f;
    sm_s[r] = ok ? m[r] : 0.f;
    sl_s[r] = ok ? s[r] : 1.f;
    ok_s[r] = ok ? 1.f : 0.f;
    loss_s[r] = 0.f;
    rd_s[r] = 0.f;
  }

  const int first = blockIdx.x * strips_per_block;
  const int last = min(first + strips_per_block, n_strips);
  for (int strip = first; strip < last; ++strip) {
    const int v0 = strip * kStrip;
    const int col = v0 + lane;
    const bool col_ok = col < V;
    load_beta_strip(b_s, beta, K, Kp, V, v0);
    if (tid < kStrip) {
      const int c = v0 + tid;
      mean_s[tid] = c < V ? mean[c] : 0.f;
      istd_s[tid] = c < V ? rsqrtf(var[c] + eps) : 1.f;
    }
    __syncthreads();
    const float mu = mean_s[lane], istd = istd_s[lane];
    for (int rb = warp * kRowTile; rb < B; rb += kWarps * kRowTile) {
      float acc[kRowTile];
      strip_product(acc, th_s, b_s, K, Kp, rb, lane);
#pragma unroll
      for (int j = 0; j < kRowTile; ++j) {
        const int r = rb + j;
        if (r < B) {  // uniform across the warp
          const float xv = col_ok ? x[(size_t)r * V + col] : 0.f;
          const float n = (acc[j] - mu) * istd;
          const float p = expf(fminf(n - sm_s[r], 0.f)) / sl_s[r];
          const float contrib =
              (col_ok && ok_s[r] > 0.f) ? xv * logf(p + floor_) : 0.f;
          const float xr = col_ok ? xv * (p / (p + floor_)) : 0.f;
          const float c_sum = warp_sum(contrib);
          const float r_sum = warp_sum(xr);
          if (lane == 0) {
            loss_s[r] -= c_sum;
            rd_s[r] += r_sum;
          }
        }
      }
    }
    __syncthreads();
  }
  for (int r = tid; r < B; r += kThreads) {
    loss_part[(size_t)blockIdx.x * B + r] = loss_s[r];
    rd_part[(size_t)blockIdx.x * B + r] = rd_s[r];
  }
}

// ---------------------------------------------------------------------------
// K3: backward — g_beta for the block's columns, g_theta partials.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
grads_kernel(const float* __restrict__ theta, const float* __restrict__ beta,
             const float* __restrict__ x, const float* __restrict__ mean,
             const float* __restrict__ var, const float* __restrict__ m,
             const float* __restrict__ s, const float* __restrict__ rd,
             const float* __restrict__ g, const float* __restrict__ mask,
             float* __restrict__ gth_part, float* __restrict__ g_beta, int B, int K, int V,
             int training, float eps, float floor_, int strips_per_block) {
  extern __shared__ float smem[];
  const int Bp = round_up(B, kRowTile), Kp = round_up(K, kTopicTile);
  const int n_strips = (V + kStrip - 1) / kStrip;
  float* th_s = smem;
  float* gth_s = th_s + Bp * Kp;
  float* b_s = gth_s + Bp * Kp;
  float* n_s = b_s + Kp * kPitch;
  float* gz_s = n_s + Bp * kStrip;
  float* sm_s = gz_s + Bp * kStrip;
  float* sl_s = sm_s + B;
  float* rd_s = sl_s + B;
  float* g_s = rd_s + B;
  float* mk_s = g_s + B;
  float* mean_s = mk_s + B;
  float* istd_s = mean_s + kStrip;
  float* sgn_s = istd_s + kStrip;
  float* sgnn_s = sgn_s + kStrip;
  float* red_s = sgnn_s + kStrip;
  float* cnt_s = red_s + 2 * kWarps * kStrip;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_theta(th_s, theta, B, K, Bp, Kp);
  for (int i = tid; i < Bp * Kp; i += kThreads) gth_s[i] = 0.f;
  for (int r = tid; r < B; r += kThreads) {
    const bool ok = s[r] > 1e-20f;
    sm_s[r] = ok ? m[r] : 0.f;
    sl_s[r] = ok ? s[r] : 1.f;
    rd_s[r] = rd[r];
    g_s[r] = g[r];
    mk_s[r] = mask[r];
  }
  if (tid == 0) {
    float c = 0.f;
    for (int r = 0; r < B; ++r) c += mask[r];
    cnt_s[0] = fmaxf(c, 1.f);
  }
  __syncthreads();
  const float cnt = cnt_s[0];
  const int kq_count = Kp / kTopicTile;

  const int first = blockIdx.x * strips_per_block;
  const int last = min(first + strips_per_block, n_strips);
  for (int strip = first; strip < last; ++strip) {
    const int v0 = strip * kStrip;
    const int col = v0 + lane;
    const bool col_ok = col < V;
    load_beta_strip(b_s, beta, K, Kp, V, v0);
    if (tid < kStrip) {
      const int c = v0 + tid;
      mean_s[tid] = c < V ? mean[c] : 0.f;
      istd_s[tid] = c < V ? rsqrtf(var[c] + eps) : 1.f;
    }
    __syncthreads();
    const float mu = mean_s[lane], istd = istd_s[lane];
    for (int rb = warp * kRowTile; rb < B; rb += kWarps * kRowTile) {
      float acc[kRowTile];
      strip_product(acc, th_s, b_s, K, Kp, rb, lane);
#pragma unroll
      for (int j = 0; j < kRowTile; ++j) {
        const int r = rb + j;
        if (r < B) {
          const float n = (acc[j] - mu) * istd;
          const float p = expf(fminf(n - sm_s[r], 0.f)) / sl_s[r];
          const float xv = col_ok ? x[(size_t)r * V + col] : 0.f;
          const float xr = xv * (p / (p + floor_));
          n_s[r * kStrip + lane] = n;
          gz_s[r * kStrip + lane] = g_s[r] * (p * rd_s[r] - xr);  // gn
        }
      }
    }
    __syncthreads();
    if (training) {
      float p1 = 0.f, p2 = 0.f;
      for (int r = warp; r < B; r += kWarps) {
        const float mk = mk_s[r];
        const float gn = gz_s[r * kStrip + lane];
        p1 += gn * mk;
        p2 += gn * n_s[r * kStrip + lane] * mk;
      }
      red_s[warp * kStrip + lane] = p1;
      red_s[(kWarps + warp) * kStrip + lane] = p2;
      __syncthreads();
      if (warp == 0) {
        float t1 = 0.f, t2 = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          t1 += red_s[w * kStrip + lane];
          t2 += red_s[(kWarps + w) * kStrip + lane];
        }
        sgn_s[lane] = t1 / cnt;
        sgnn_s[lane] = t2 / cnt;
      }
      __syncthreads();
      const float a = sgn_s[lane], b = sgnn_s[lane];
      for (int r = warp; r < B; r += kWarps) {
        const int i = r * kStrip + lane;
        const float mk = mk_s[r];
        gz_s[i] = col_ok ? istd * (gz_s[i] - mk * a - n_s[i] * mk * b) : 0.f;
      }
    } else {
      for (int r = warp; r < B; r += kWarps) {
        const int i = r * kStrip + lane;
        gz_s[i] = col_ok ? gz_s[i] * istd : 0.f;
      }
    }
    __syncthreads();
    // g_beta[k, col] = sum_r theta[r, k] * gz[r, col]
    for (int kb = warp * kTopicTile; kb < K; kb += kWarps * kTopicTile) {
      float acc[kTopicTile];
#pragma unroll
      for (int j = 0; j < kTopicTile; ++j) acc[j] = 0.f;
      for (int r = 0; r < B; ++r) {
        const float gv = gz_s[r * kStrip + lane];
#pragma unroll
        for (int j = 0; j < kTopicTile; ++j) acc[j] = fmaf(th_s[r * Kp + kb + j], gv, acc[j]);
      }
      if (col_ok) {
#pragma unroll
        for (int j = 0; j < kTopicTile; ++j) {
          if (kb + j < K) g_beta[(size_t)(kb + j) * V + col] = acc[j];
        }
      }
    }
    // g_theta[r, k] += sum_c gz[r, c] * beta[k, c] over this strip
    for (int i = tid; i < B * kq_count; i += kThreads) {
      const int r = i / kq_count;
      const int kb = (i - r * kq_count) * kTopicTile;
      float acc[kTopicTile];
#pragma unroll
      for (int j = 0; j < kTopicTile; ++j) acc[j] = gth_s[r * Kp + kb + j];
      for (int c = 0; c < kStrip; ++c) {
        const float gv = gz_s[r * kStrip + c];
#pragma unroll
        for (int j = 0; j < kTopicTile; ++j) acc[j] = fmaf(gv, b_s[(kb + j) * kPitch + c], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kTopicTile; ++j) gth_s[r * Kp + kb + j] = acc[j];
    }
    __syncthreads();
  }
  for (int i = tid; i < B * K; i += kThreads) {
    const int r = i / K, k = i - r * K;
    gth_part[(size_t)blockIdx.x * B * K + i] = gth_s[r * Kp + k];
  }
}

// Grid for a kernel: as many resident blocks as the card holds, each with a
// whole number of strips, and no block without a strip.
template <typename KernelT>
cudaError_t plan(KernelT kernel, size_t smem, int V, int* grid, int* strips_per_block) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int n_strips = (V + kStrip - 1) / kStrip;
  int g = per_sm * sms;
  if (g < 1) g = 1;
  if (g > n_strips) g = n_strips;
  const int spb = (n_strips + g - 1) / g;
  *strips_per_block = spb;
  *grid = (n_strips + spb - 1) / spb;
  return cudaSuccess;
}

template <typename KernelT>
cudaError_t plan_kind(int kind, KernelT kernel, int B, int K, int V, int* grid, int* spb,
                      size_t* smem) {
  *smem = smem_floats(kind, B, K) * sizeof(float);
  return plan(kernel, *smem, V, grid, spb);
}

cudaError_t plan_any(int kind, int B, int K, int V, int* grid, int* spb, size_t* smem) {
  switch (kind) {
    case kStats: return plan_kind(kind, stats_kernel, B, K, V, grid, spb, smem);
    case kLoss: return plan_kind(kind, loss_kernel, B, K, V, grid, spb, smem);
    case kGrads: return plan_kind(kind, grads_kernel, B, K, V, grid, spb, smem);
  }
  return cudaErrorInvalidValue;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Shared memory each kernel needs at (B, K), the card's per-block limit and
// the grid a launch will use. Returns a cudaError_t; *grid is 0 when the
// kernel does not fit.
int fd_plan(int kind, int B, int K, int V, int* grid, long long* smem_bytes,
            long long* smem_limit) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(kind, B, K) * sizeof(float);
  *smem_bytes = (long long)smem;
  *smem_limit = (long long)limit;
  *grid = 0;
  if (smem > (size_t)limit) return (int)cudaSuccess;
  int spb = 0;
  size_t unused = 0;
  return (int)plan_any(kind, B, K, V, grid, &spb, &unused);
}

int fd_stats(const void* theta, const void* beta, const void* mask, const void* run_mean,
             const void* run_var, void* mean, void* var, void* m_part, void* s_part, void* m,
             void* s, int B, int K, int V, int training, float eps, int grid, void* stream) {
  int g = 0, spb = 0;
  size_t smem = 0;
  cudaError_t err = plan_any(kStats, B, K, V, &g, &spb, &smem);
  if (err != cudaSuccess) return (int)err;
  if (g != grid) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  stats_kernel<<<grid, kThreads, smem, st>>>(
      (const float*)theta, (const float*)beta, (const float*)mask, (const float*)run_mean,
      (const float*)run_var, (float*)mean, (float*)var, (float*)m_part, (float*)s_part, B, K,
      V, training, eps, spb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_softmax_kernel<<<blocks_for(B), kThreads, 0, st>>>(
      (const float*)m_part, (const float*)s_part, grid, B, (float*)m, (float*)s);
  return (int)cudaGetLastError();
}

int fd_loss(const void* theta, const void* beta, const void* x, const void* mean,
            const void* var, const void* m, const void* s, void* loss_part, void* rd_part,
            void* loss, void* rd, int B, int K, int V, float eps, float floor_, int grid,
            void* stream) {
  int g = 0, spb = 0;
  size_t smem = 0;
  cudaError_t err = plan_any(kLoss, B, K, V, &g, &spb, &smem);
  if (err != cudaSuccess) return (int)err;
  if (g != grid) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  loss_kernel<<<grid, kThreads, smem, st>>>(
      (const float*)theta, (const float*)beta, (const float*)x, (const float*)mean,
      (const float*)var, (const float*)m, (const float*)s, (float*)loss_part, (float*)rd_part,
      B, K, V, eps, floor_, spb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<blocks_for(B), kThreads, 0, st>>>((const float*)loss_part, grid, B,
                                                          (float*)loss);
  sum_partials_kernel<<<blocks_for(B), kThreads, 0, st>>>((const float*)rd_part, grid, B,
                                                          (float*)rd);
  return (int)cudaGetLastError();
}

int fd_grads(const void* theta, const void* beta, const void* x, const void* mean,
             const void* var, const void* m, const void* s, const void* rd, const void* g,
             const void* mask, void* gth_part, void* g_theta, void* g_beta, int B, int K,
             int V, int training, float eps, float floor_, int grid, void* stream) {
  int gr = 0, spb = 0;
  size_t smem = 0;
  cudaError_t err = plan_any(kGrads, B, K, V, &gr, &spb, &smem);
  if (err != cudaSuccess) return (int)err;
  if (gr != grid) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  grads_kernel<<<grid, kThreads, smem, st>>>(
      (const float*)theta, (const float*)beta, (const float*)x, (const float*)mean,
      (const float*)var, (const float*)m, (const float*)s, (const float*)rd, (const float*)g,
      (const float*)mask, (float*)gth_part, (float*)g_beta, B, K, V, training, eps, floor_,
      spb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<blocks_for(B * K), kThreads, 0, st>>>((const float*)gth_part, grid,
                                                              B * K, (float*)g_theta);
  return (int)cudaGetLastError();
}

}  // extern "C"
