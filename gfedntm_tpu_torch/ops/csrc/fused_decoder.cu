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
// Design of K1 and K2. Each block owns a contiguous range of V columns and
// walks it in strips of 32 columns (one warp lane per column). theta [B,K]
// and the strip of beta sit in shared memory; because a block holds all B
// rows of each of its columns, the column batch statistics are exact inside
// the block. The per-row reductions over V (softmax max/denominator, loss,
// rd) are carried across the block's strips in shared memory and written as
// [grid, B] partials, which a small kernel folds in a fixed order: the TPU
// carried them across its sequential grid, and CUDA blocks run in no order.
// No atomics, so results are deterministic for a given card. Their products
// are FP32 FMAs on the CUDA cores, summed in a fixed order. Ragged edges in
// B, K and V are masked here; inputs are unpadded and contiguous.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s FP32 on the CUDA cores; 495
// TFLOP/s dense TF32 on the tensor cores, so 165 TFLOP/s for an FP32-accurate
// 3xTF32 product) at B=256, K=50, V=100,000: K1 moves ~21 MB (6 us) and does
// 2BKV = 2.56 GFLOP (38 us on the CUDA cores); K2 moves ~123 MB (37 us) for
// the same 2.56 GFLOP. On the CUDA cores, where they run, K1 and K2 are bound
// by FP32 operations, and their simple design feeds each FMA from shared
// memory and is far from that bound. (With tensor cores the card could do
// K1 in 16 us, bound by 3xTF32 operations, and K2 in 37 us, bound by bytes.)
//
// K3 replaces _grads_kernel (:612). It moves ~143 MB (43 us) and does
// 3 x 2.56 GFLOP, which take 46 us as 3xTF32 on the tensor cores (115 us as
// FP32 FMAs): its bound is those operations. Its design: a block of 16 warps
// owns a contiguous range of V columns and all B rows (so the BatchNorm
// column sums stay exact inside the block) and walks it in tiles of VT = 32
// columns (16 when B > 256 or the 32-wide layout does not fit). All three
// products run on the tensor cores through mma.sync m16n8k8 TF32 with the
// 3xTF32 split (a = a_hi + a_lo, each rounded to TF32; D += a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi, FP32 accumulation), which keeps FP32 accuracy:
// z = theta beta_tile per 16-row tile of each warp, with n, p and gn
// computed on the accumulator fragments; gz is staged once in shared memory,
// in place of the tile's x; then half the warps accumulate g_theta +=
// gz beta_tile^T in shared memory across the block's tiles while the other
// half write g_beta = theta^T gz straight to its columns. The beta, x, mean
// and var rows of tile t+1 are in flight while tile t computes, in a
// two-stage ring: Hopper bulk copies (cp.async.bulk, one per row, completing
// on an mbarrier) where rows are 16-byte aligned, else 4-byte cp.async.
// Occupancy is one block per SM (228.6 KB of shared memory at B=256, K=50,
// at most 128 registers a thread); four warps per scheduler and independent
// mma chains hide the mma latency. Every TF32 operand is split with five
// integer and FP32 instructions before its mma, so each mma costs several
// instructions besides itself. The [grid, B, K] g_theta partials are folded
// in block order, as above.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

// Shared memory of K1 and K2, in floats.
size_t smem_floats(int kind, int B, int K) {
  const size_t Bp = round_up(B, kRowTile), Kp = round_up(K, kTopicTile);
  switch (kind) {
    case kStats:  // theta, beta strip, z strip, mask/m/s rows, reduce, mean/istd, cnt
      return Bp * Kp + Kp * kPitch + Bp * kStrip + 3 * (size_t)B + kWarps * kStrip +
             2 * kStrip + 1;
    case kLoss:  // theta, beta strip, safe m/s, row ok, loss/rd rows, mean/istd
      return Bp * Kp + Kp * kPitch + 5 * (size_t)B + 2 * kStrip;
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
// K3: backward — g_beta for the block's columns, g_theta partials, on the
// tensor cores (3xTF32 mma.sync), its tiles loaded through a two-stage ring.
// ---------------------------------------------------------------------------
constexpr int kK3Threads = 512;  // 16 warps: four per scheduler hide the mma latency
constexpr int kK3Warps = kK3Threads / 32;
constexpr int kHalf = kK3Warps / 2;
constexpr int kChunk = 4;  // g_theta n-tiles in flight per warp

// Per tile width: the x/gz and beta tiles' row pitches in floats (x: 8 or
// 24 mod 32, so the gz fragments of g_beta = theta^T gz load without bank
// conflicts; rows stay 16-byte aligned for the bulk copies) and the most
// 16-row tiles a warp holds (n is kept in registers between the two passes
// of the BatchNorm correction, so this caps B at kMaxMt * 16 * kK3Warps).
template <int VT> struct GradsTile;
template <> struct GradsTile<32> { static constexpr int kPx = 40, kPb = 40, kMaxMt = 1; };
template <> struct GradsTile<16> { static constexpr int kPx = 24, kPb = 16, kMaxMt = 4; };

__host__ __device__ inline size_t up4(size_t n) { return (n + 3) / 4 * 4; }

// K3's shared memory at tile width vt, as offsets in floats: theta [B, Pth]
// (Pth = Kp + 4, 4 mod 8, so theta's A fragments load without conflicts),
// the g_theta accumulator [B, Kp], two ring stages of x/gz [B, Px], beta
// [Kp, Pb] (rows K..Kp-1 stay zero) and the tile's mean and var [2, vt];
// five row vectors (m, 1/s, rd, g, mask); two [kK3Warps, vt] column reductions, the two BN column
// sums and the count; two mbarriers. Rows past B are never stored: fragments
// read them as 0.
struct GradsLayout {
  int Kp, Pth, Pg;
  size_t th, gth, x, x_stage, b, b_stage, mv, rows, cols, bar, floats;
};

__host__ __device__ inline GradsLayout grads_layout(int vt, int B, int K) {
  GradsLayout L;
  const int px = vt == 32 ? GradsTile<32>::kPx : GradsTile<16>::kPx;
  const int pb = vt == 32 ? GradsTile<32>::kPb : GradsTile<16>::kPb;
  L.Kp = round_up(K, 8);
  L.Pth = L.Kp + 4;
  L.Pg = L.Kp;
  L.th = 0;
  L.gth = L.th + up4((size_t)B * L.Pth);
  L.x = L.gth + up4((size_t)B * L.Pg);
  L.x_stage = up4((size_t)B * px);
  L.b = L.x + 2 * L.x_stage;
  L.b_stage = (size_t)L.Kp * pb;
  L.mv = L.b + 2 * L.b_stage;
  L.rows = L.mv + 4 * (size_t)vt;
  L.cols = L.rows + up4(5 * (size_t)B);
  L.bar = L.cols + (size_t)(2 * kK3Warps + 2) * vt + 4;
  L.floats = L.bar + 4;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cvt.rna.tf32.f32 of a finite float: round to nearest (ties away from zero)
// at the 10-bit TF32 mantissa and clear the 13 bits below it. ptxas expands
// the PTX instruction into these two integer operations plus a guard that
// passes inf and NaN through unrounded; the kernel's operands are finite.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32 (round to nearest), so hi*b_hi + hi*b_lo + lo*b_hi
// carries a's and b's FP32 mantissas (a - hi is exact in FP32).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (3xTF32), small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Start loading columns v0..v0+VT (those below V) of beta's K rows, x's B
// rows, mean and var into one ring stage. kBulk: one bulk copy per row,
// spread over the block's threads, all completing on `bar` (thread 0 posts
// the stage's byte count); else 4-byte cp.async by every thread (the caller
// commits the group).
template <int VT, bool kBulk>
__device__ void load_tile(float* b_dst, float* x_dst, float* mv_dst, uint64_t* bar,
                          const float* __restrict__ beta, const float* __restrict__ x,
                          const float* __restrict__ mean, const float* __restrict__ var, int B,
                          int K, int V, int v0) {
  constexpr int Pb = GradsTile<VT>::kPb, Px = GradsTile<VT>::kPx;
  const int ncols = min(VT, V - v0);
  const int rows = K + B + 2;
  if (kBulk) {
    if (threadIdx.x == 0) mbar_expect_tx(bar, (uint32_t)(rows * ncols * 4));
    // The stage was last read and written by the generic proxy.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int i = threadIdx.x; i < rows; i += kK3Threads) {
      if (i < K) {
        bulk_copy(b_dst + i * Pb, beta + (size_t)i * V + v0, ncols * 4, bar);
      } else if (i < K + B) {
        const int r = i - K;
        bulk_copy(x_dst + r * Px, x + (size_t)r * V + v0, ncols * 4, bar);
      } else {
        const int j = i - K - B;
        bulk_copy(mv_dst + j * VT, (j ? var : mean) + v0, ncols * 4, bar);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * VT; i += kK3Threads) {
      const int row = i / VT, c = i - row * VT;
      if (c < ncols) {
        if (row < K) {
          cp_async4(b_dst + row * Pb + c, beta + (size_t)row * V + v0 + c);
        } else if (row < K + B) {
          const int r = row - K;
          cp_async4(x_dst + r * Px + c, x + (size_t)r * V + v0 + c);
        } else {
          const int j = row - K - B;
          cp_async4(mv_dst + j * VT + c, (j ? var : mean) + v0 + c);
        }
      }
    }
  }
}

template <int VT, bool kBulk>
__global__ void __launch_bounds__(kK3Threads, 1)
grads_kernel(const float* __restrict__ theta, const float* __restrict__ beta,
             const float* __restrict__ x, const float* __restrict__ mean,
             const float* __restrict__ var, const float* __restrict__ m,
             const float* __restrict__ s, const float* __restrict__ rd,
             const float* __restrict__ g, const float* __restrict__ mask,
             float* __restrict__ gth_part, float* __restrict__ g_beta, int B, int K, int V,
             int training, float eps, float floor_, int tiles_per_block) {
  using T = GradsTile<VT>;
  constexpr int kNt = VT / 8;  // 8-column mma tiles per tile
  constexpr int Px = T::kPx, Pb = T::kPb;
  extern __shared__ __align__(128) unsigned char k3_smem[];
  float* const sm = reinterpret_cast<float*>(k3_smem);
  const GradsLayout L = grads_layout(VT, B, K);
  const int Kp = L.Kp, Pth = L.Pth, Pg = L.Pg;
  float* th_s = sm + L.th;
  float* gth_s = sm + L.gth;
  float* x_ring = sm + L.x;
  float* b_ring = sm + L.b;
  float* mv_ring = sm + L.mv;  // [stage][mean, var][VT]
  float* sm_s = sm + L.rows;
  float* isl_s = sm_s + B;  // 1 / s
  float* rd_s = isl_s + B;
  float* g_s = rd_s + B;
  float* mk_s = g_s + B;
  float* red_s = sm + L.cols;               // [2][kK3Warps][VT]
  float* ab_s = red_s + 2 * kK3Warps * VT;  // [2][VT]: sum(gn*mk)/cnt, sum(gn*n*mk)/cnt
  float* cnt_s = ab_s + 2 * VT;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L.bar);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  const int n_tiles = (V + VT - 1) / VT;
  const int mt_count = (B + 15) / 16;

  for (int i = tid; i < B * Kp; i += kK3Threads) {
    const int r = i / Kp, k = i - r * Kp;
    th_s[r * Pth + k] = k < K ? theta[(size_t)r * K + k] : 0.f;
    gth_s[r * Pg + k] = 0.f;
  }
  for (size_t i = tid; i < 2 * L.x_stage; i += kK3Threads) x_ring[i] = 0.f;
  for (size_t i = tid; i < 2 * L.b_stage; i += kK3Threads) b_ring[i] = 0.f;
  for (int i = tid; i < 4 * VT; i += kK3Threads) mv_ring[i] = 0.f;
  for (int r = tid; r < B; r += kK3Threads) {
    const bool ok = s[r] > 1e-20f;
    sm_s[r] = ok ? m[r] : 0.f;
    isl_s[r] = 1.f / (ok ? s[r] : 1.f);
    rd_s[r] = rd[r];
    g_s[r] = g[r];
    mk_s[r] = mask[r];
  }
  if (tid == 0) {
    float c = 0.f;
    for (int r = 0; r < B; ++r) c += mask[r];
    cnt_s[0] = fmaxf(c, 1.f);
    if (kBulk) {
      mbar_init(&bar[0], 1);
      mbar_init(&bar[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  const float cnt = cnt_s[0];

  const int first = blockIdx.x * tiles_per_block;
  const int last = min(first + tiles_per_block, n_tiles);
  if (first < last) {
    load_tile<VT, kBulk>(b_ring, x_ring, mv_ring, &bar[0], beta, x, mean, var, B, K, V,
                         first * VT);
    if (!kBulk) cp_async_commit();
  }
  for (int tile = first, it = 0; tile < last; ++tile, ++it) {
    const int st = it & 1;
    const int v0 = tile * VT;
    if (tile + 1 < last) {
      load_tile<VT, kBulk>(b_ring + (st ^ 1) * L.b_stage, x_ring + (st ^ 1) * L.x_stage,
                           mv_ring + (st ^ 1) * 2 * VT, &bar[st ^ 1], beta, x, mean, var, B,
                           K, V, v0 + VT);
    }
    if (kBulk) {
      mbar_wait(&bar[st], (it >> 1) & 1);
    } else {
      cp_async_commit();  // possibly empty: one group per tile
      cp_async_wait_prior();
    }
    __syncthreads();
    float* xs = x_ring + st * L.x_stage;  // x, then gn, then gz
    const float* bs = b_ring + st * L.b_stage;
    const float* mvs = mv_ring + st * 2 * VT;

    // This lane's columns: mean and inv_std (past V: 0 and 1).
    float mu[kNt][2], istd[kNt][2];
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * tig + e;
        const bool ok = v0 + c < V;
        mu[nt][e] = ok ? mvs[c] : 0.f;
        istd[nt][e] = ok ? rsqrtf(mvs[VT + c] + eps) : 1.f;
      }
    }

    // Pass 1: z = theta beta_tile on the tensor cores; n and gn on the
    // accumulator fragments; gn replaces x in shared memory, n stays here.
    float nv[T::kMaxMt][kNt][4];
    float s1[kNt][2], s2[kNt][2];
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;
#pragma unroll
    for (int q = 0; q < T::kMaxMt; ++q) {
      const int mt = warp + q * kK3Warps;
      if (mt < mt_count) {
        const int r_lo = mt * 16 + grp, r_hi = r_lo + 8;
        const bool ok_lo = r_lo < B, ok_hi = r_hi < B;
        float acc[kNt][4];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
        for (int k0 = 0; k0 < Kp; k0 += 8) {
          uint32_t ah[4], al[4];
          split_tf32(ok_lo ? th_s[r_lo * Pth + k0 + tig] : 0.f, ah[0], al[0]);
          split_tf32(ok_hi ? th_s[r_hi * Pth + k0 + tig] : 0.f, ah[1], al[1]);
          split_tf32(ok_lo ? th_s[r_lo * Pth + k0 + tig + 4] : 0.f, ah[2], al[2]);
          split_tf32(ok_hi ? th_s[r_hi * Pth + k0 + tig + 4] : 0.f, ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            uint32_t bh[2], bl[2];
            split_tf32(bs[(k0 + tig) * Pb + nt * 8 + grp], bh[0], bl[0]);
            split_tf32(bs[(k0 + tig + 4) * Pb + nt * 8 + grp], bh[1], bl[1]);
            mma_3xtf32(acc[nt], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? r_hi : r_lo;
          const bool rok = h ? ok_hi : ok_lo;
          const float smv = rok ? sm_s[r] : 0.f, islv = rok ? isl_s[r] : 1.f;
          const float rdv = rok ? rd_s[r] : 0.f, gv = rok ? g_s[r] : 0.f;
          const float mkv = rok ? mk_s[r] : 0.f;
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            const int c = nt * 8 + 2 * tig;
            const float2 xv = rok ? *reinterpret_cast<const float2*>(xs + r * Px + c)
                                  : make_float2(0.f, 0.f);
            float gn2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool ok = rok && v0 + c + e < V;
              const float n = (acc[nt][2 * h + e] - mu[nt][e]) * istd[nt][e];
              const float p = expf(fminf(n - smv, 0.f)) * islv;
              const float xr = (ok ? (e ? xv.y : xv.x) : 0.f) * __fdividef(p, p + floor_);
              const float gn = ok ? gv * (p * rdv - xr) : 0.f;
              nv[q][nt][2 * h + e] = n;
              gn2[e] = gn;
              if (ok) {
                s1[nt][e] += gn * mkv;
                s2[nt][e] += gn * n * mkv;
              }
            }
            if (rok) *reinterpret_cast<float2*>(xs + r * Px + c) = make_float2(gn2[0], gn2[1]);
          }
        }
      }
    }

    // Training: the column sums of the BatchNorm correction, over the
    // warp's rows (butterfly over the 8 row groups), then over warps in
    // order. Eval: gz = gn * inv_std (both sums zero).
    if (training) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v1 = s1[nt][e], v2 = s2[nt][e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            v1 += __shfl_xor_sync(kFullMask, v1, o);
            v2 += __shfl_xor_sync(kFullMask, v2, o);
          }
          if (grp == 0) {
            red_s[warp * VT + nt * 8 + 2 * tig + e] = v1;
            red_s[(kK3Warps + warp) * VT + nt * 8 + 2 * tig + e] = v2;
          }
        }
      }
      __syncthreads();
      if (tid < VT) {
        float t1 = 0.f, t2 = 0.f;
        for (int w = 0; w < kK3Warps; ++w) {
          t1 += red_s[w * VT + tid];
          t2 += red_s[(kK3Warps + w) * VT + tid];
        }
        ab_s[tid] = t1 / cnt;
        ab_s[VT + tid] = t2 / cnt;
      }
      __syncthreads();
    }

    // Pass 2: gz = inv_std * (gn - mk*a - n*mk*b), 0 past V; gz replaces gn.
#pragma unroll
    for (int q = 0; q < T::kMaxMt; ++q) {
      const int mt = warp + q * kK3Warps;
      if (mt < mt_count) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + grp + 8 * h;
          if (r < B) {
            const float mkv = mk_s[r];
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
              const int c = nt * 8 + 2 * tig;
              const float2 v = *reinterpret_cast<const float2*>(xs + r * Px + c);
              float gz[2] = {v.x, v.y};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float a = training ? ab_s[c + e] : 0.f;
                const float b = training ? ab_s[VT + c + e] : 0.f;
                gz[e] = v0 + c + e < V
                            ? istd[nt][e] * (gz[e] - mkv * a - nv[q][nt][2 * h + e] * mkv * b)
                            : 0.f;
              }
              *reinterpret_cast<float2*>(xs + r * Px + c) = make_float2(gz[0], gz[1]);
            }
          }
        }
      }
    }
    __syncthreads();

    // The two products of gz run side by side: warps kHalf.. accumulate
    // g_theta, warps ..kHalf-1 write g_beta.
    if (warp >= kHalf) {
      // g_theta[rows, :] += gz beta_tile^T per 16-row tile, the accumulator
      // in shared memory, kChunk independent n-tiles at a time.
      for (int mt = warp - kHalf; mt < mt_count; mt += kHalf) {
        const int r_lo = mt * 16 + grp, r_hi = r_lo + 8;
        const bool ok_lo = r_lo < B, ok_hi = r_hi < B;
        uint32_t gh[kNt][4], gl[kNt][4];
#pragma unroll
        for (int ks = 0; ks < kNt; ++ks) {
          const int c = ks * 8 + tig;
          split_tf32(ok_lo ? xs[r_lo * Px + c] : 0.f, gh[ks][0], gl[ks][0]);
          split_tf32(ok_hi ? xs[r_hi * Px + c] : 0.f, gh[ks][1], gl[ks][1]);
          split_tf32(ok_lo ? xs[r_lo * Px + c + 4] : 0.f, gh[ks][2], gl[ks][2]);
          split_tf32(ok_hi ? xs[r_hi * Px + c + 4] : 0.f, gh[ks][3], gl[ks][3]);
        }
        for (int n0 = 0; n0 < Kp; n0 += 8 * kChunk) {
          float acc[kChunk][4];
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const int c = n0 + j * 8 + 2 * tig;
            const bool in = n0 + j * 8 < Kp;
            const float2 lo = in && ok_lo ? *reinterpret_cast<const float2*>(gth_s + r_lo * Pg + c)
                                          : make_float2(0.f, 0.f);
            const float2 hi = in && ok_hi ? *reinterpret_cast<const float2*>(gth_s + r_hi * Pg + c)
                                          : make_float2(0.f, 0.f);
            acc[j][0] = lo.x;
            acc[j][1] = lo.y;
            acc[j][2] = hi.x;
            acc[j][3] = hi.y;
          }
#pragma unroll
          for (int ks = 0; ks < kNt; ++ks) {
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
              if (n0 + j * 8 < Kp) {
                const int kk = n0 + j * 8 + grp;
                uint32_t bh[2], bl[2];
                split_tf32(bs[kk * Pb + ks * 8 + tig], bh[0], bl[0]);
                split_tf32(bs[kk * Pb + ks * 8 + tig + 4], bh[1], bl[1]);
                mma_3xtf32(acc[j], gh[ks], gl[ks], bh, bl);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const int c = n0 + j * 8 + 2 * tig;
            if (n0 + j * 8 < Kp) {
              if (ok_lo) *reinterpret_cast<float2*>(gth_s + r_lo * Pg + c) = make_float2(acc[j][0], acc[j][1]);
              if (ok_hi) *reinterpret_cast<float2*>(gth_s + r_hi * Pg + c) = make_float2(acc[j][2], acc[j][3]);
            }
          }
        }
      }
    } else {
      // g_beta[k, v0:v0+VT] = theta^T gz: a warp per (16 topics, 16
      // columns), summed over all B rows in two interleaved halves (even
      // and odd 8-row steps, added at the end), written straight to its
      // columns.
      constexpr int kNg = VT / 16;
      const int items = (Kp + 15) / 16 * kNg;
      for (int item = warp; item < items; item += kHalf) {
        const int m0 = item / kNg * 16, n0 = item % kNg * 16;
        const int k_lo = m0 + grp, k_hi = k_lo + 8;
        const bool kok_lo = k_lo < K, kok_hi = k_hi < K;
        float acc[2][2][4];  // [half][n-tile][fragment]
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[u][j][0] = acc[u][j][1] = acc[u][j][2] = acc[u][j][3] = 0.f;
#pragma unroll 2
        for (int r0 = 0; r0 < B; r0 += 16) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int ra = r0 + 8 * u + tig, rb = ra + 4;
            const bool oa = ra < B, ob = rb < B;
            uint32_t ah[4], al[4];
            split_tf32(oa && kok_lo ? th_s[ra * Pth + k_lo] : 0.f, ah[0], al[0]);
            split_tf32(oa && kok_hi ? th_s[ra * Pth + k_hi] : 0.f, ah[1], al[1]);
            split_tf32(ob && kok_lo ? th_s[rb * Pth + k_lo] : 0.f, ah[2], al[2]);
            split_tf32(ob && kok_hi ? th_s[rb * Pth + k_hi] : 0.f, ah[3], al[3]);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              uint32_t bh[2], bl[2];
              split_tf32(oa ? xs[ra * Px + n0 + j * 8 + grp] : 0.f, bh[0], bl[0]);
              split_tf32(ob ? xs[rb * Px + n0 + j * 8 + grp] : 0.f, bh[1], bl[1]);
              mma_3xtf32(acc[u][j], ah, al, bh, bl);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = h ? k_hi : k_lo;
            if (k < K) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = v0 + n0 + j * 8 + 2 * tig + e;
                if (col < V) {
                  g_beta[(size_t)k * V + col] = acc[0][j][2 * h + e] + acc[1][j][2 * h + e];
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the load of tile + 2
  }
  for (int i = tid; i < B * K; i += kK3Threads) {
    const int r = i / K, k = i - r * K;
    gth_part[(size_t)blockIdx.x * B * K + i] = gth_s[r * Pg + k];
  }
}

// Grid for a kernel: as many resident blocks as the card holds, each with a
// whole number of tiles of `cols` columns, and no block without a tile.
template <typename KernelT>
cudaError_t plan(KernelT kernel, int threads, size_t smem, int V, int cols, int* grid,
                 int* tiles_per_block) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + cols - 1) / cols;
  int g = per_sm * sms;
  if (g < 1) g = 1;
  if (g > n_tiles) g = n_tiles;
  const int tpb = (n_tiles + g - 1) / g;
  *tiles_per_block = tpb;
  *grid = (n_tiles + tpb - 1) / tpb;
  return cudaSuccess;
}

template <typename KernelT>
cudaError_t plan_kind(int kind, KernelT kernel, int B, int K, int V, int* grid, int* spb,
                      size_t* smem) {
  *smem = smem_floats(kind, B, K) * sizeof(float);
  return plan(kernel, kThreads, *smem, V, kStrip, grid, spb);
}

// K3's tile width at (B, K) under a per-block shared-memory limit: 32 when
// that layout fits and B fits the warps' registers, else 16; 0 when neither
// fits. *smem is the chosen layout's bytes (the 16-wide one's on refusal).
int grads_vt(int B, int K, size_t limit, size_t* smem) {
  const int widths[2] = {32, 16};
  const int max_rows[2] = {GradsTile<32>::kMaxMt * 16 * kK3Warps,
                           GradsTile<16>::kMaxMt * 16 * kK3Warps};
  for (int i = 0; i < 2; ++i) {
    *smem = grads_layout(widths[i], B, K).floats * sizeof(float);
    if (*smem <= limit && B <= max_rows[i]) return widths[i];
  }
  return 0;
}

cudaError_t smem_limit(size_t* limit) {
  int dev = 0, value = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *limit = (size_t)value;
  return err;
}

// K3's grid (the 16-byte-aligned variant's occupancy stands for both) and
// tile width; *vt is 0 when it does not fit.
cudaError_t plan_grads(int B, int K, int V, int* grid, int* tpb, size_t* smem, int* vt) {
  size_t limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  *vt = grads_vt(B, K, limit, smem);
  *grid = 0;
  if (*vt == 32) return plan(grads_kernel<32, true>, kK3Threads, *smem, V, 32, grid, tpb);
  if (*vt == 16) return plan(grads_kernel<16, true>, kK3Threads, *smem, V, 16, grid, tpb);
  return cudaSuccess;
}

cudaError_t plan_any(int kind, int B, int K, int V, int* grid, int* spb, size_t* smem) {
  switch (kind) {
    case kStats: return plan_kind(kind, stats_kernel, B, K, V, grid, spb, smem);
    case kLoss: return plan_kind(kind, loss_kernel, B, K, V, grid, spb, smem);
  }
  return cudaErrorInvalidValue;
}

template <int VT, bool kBulk>
cudaError_t launch_grads(const void* theta, const void* beta, const void* x, const void* mean,
                         const void* var, const void* m, const void* s, const void* rd,
                         const void* g, const void* mask, void* gth_part, void* g_beta, int B,
                         int K, int V, int training, float eps, float floor_, int grid, int tpb,
                         size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(grads_kernel<VT, kBulk>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  grads_kernel<VT, kBulk><<<grid, kK3Threads, smem, st>>>(
      (const float*)theta, (const float*)beta, (const float*)x, (const float*)mean,
      (const float*)var, (const float*)m, (const float*)s, (const float*)rd, (const float*)g,
      (const float*)mask, (float*)gth_part, (float*)g_beta, B, K, V, training, eps, floor_, tpb);
  return cudaGetLastError();
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Shared memory each kernel needs at (B, K), the card's per-block limit and
// the grid a launch will use. Returns a cudaError_t; *grid is 0 when the
// kernel does not fit.
int fd_plan(int kind, int B, int K, int V, int* grid, long long* smem_bytes,
            long long* smem_limit_out) {
  size_t limit = 0, smem = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  *smem_limit_out = (long long)limit;
  *grid = 0;
  int tpb = 0;
  if (kind == kGrads) {
    int vt = 0;
    err = plan_grads(B, K, V, grid, &tpb, &smem, &vt);
    *smem_bytes = (long long)smem;
    return (int)err;
  }
  smem = smem_floats(kind, B, K) * sizeof(float);
  *smem_bytes = (long long)smem;
  if (smem > limit) return (int)cudaSuccess;
  return (int)plan_any(kind, B, K, V, grid, &tpb, &smem);
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

// K3: the bulk-copy variant when every row of beta, x, mean and var starts
// on 16 bytes (V % 4 == 0 and aligned base pointers), else the 4-byte
// cp.async one.
int fd_grads(const void* theta, const void* beta, const void* x, const void* mean,
             const void* var, const void* m, const void* s, const void* rd, const void* g,
             const void* mask, void* gth_part, void* g_theta, void* g_beta, int B, int K,
             int V, int training, float eps, float floor_, int grid, void* stream) {
  int gr = 0, tpb = 0, vt = 0;
  size_t smem = 0;
  cudaError_t err = plan_grads(B, K, V, &gr, &tpb, &smem, &vt);
  if (err != cudaSuccess) return (int)err;
  if (vt == 0 || gr != grid) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool bulk = V % 4 == 0 && (uintptr_t)beta % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)mean % 16 == 0 && (uintptr_t)var % 16 == 0;
  if (vt == 32) {
    err = bulk ? launch_grads<32, true>(theta, beta, x, mean, var, m, s, rd, g, mask, gth_part,
                                        g_beta, B, K, V, training, eps, floor_, grid, tpb,
                                        smem, st)
               : launch_grads<32, false>(theta, beta, x, mean, var, m, s, rd, g, mask,
                                         gth_part, g_beta, B, K, V, training, eps, floor_,
                                         grid, tpb, smem, st);
  } else {
    err = bulk ? launch_grads<16, true>(theta, beta, x, mean, var, m, s, rd, g, mask, gth_part,
                                        g_beta, B, K, V, training, eps, floor_, grid, tpb,
                                        smem, st)
               : launch_grads<16, false>(theta, beta, x, mean, var, m, s, rd, g, mask,
                                         gth_part, g_beta, B, K, V, training, eps, floor_,
                                         grid, tpb, smem, st);
  }
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<blocks_for(B * K), kThreads, 0, st>>>((const float*)gth_part, grid,
                                                              B * K, (float*)g_theta);
  return (int)cudaGetLastError();
}

}  // extern "C"
