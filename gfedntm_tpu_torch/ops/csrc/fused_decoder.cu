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
// All three share one design. A block of 16 warps owns a contiguous range of
// V columns and all B rows, so the masked column statistics stay exact inside
// the block, and walks it in tiles of VT = 32 columns (16 when B > 256 or the
// 32-wide layout does not fit). z = theta beta_tile comes from one tile
// product (tile_product), the same for K1, K2 and K3 and summed in the same
// k order: mma.sync m16n8k8 TF32 on the tensor cores with the 3xTF32 split
// (a = a_hi + a_lo, each rounded to TF32; D += a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi, FP32 accumulation), which keeps FP32 accuracy, per 16-row tile
// of each warp. The beta rows of tile t+1 (and x, mean and var where the
// kernel reads them) are in flight while tile t computes, in a two-stage ring
// of cp.async copies spread over the block's threads: 16 bytes each where
// rows are 16-byte aligned, else 4 bytes (on the card, 16-byte copies beat
// one Hopper bulk copy per 128-byte row in all three kernels). Per-row
// reductions over V (K1's softmax max and denominator, K2's loss and
// row-dot) live in the registers of the four lanes that hold the row's
// accumulator fragments and are written as [grid, B] partials, which a
// small kernel folds in a fixed order: the TPU carried them across its sequential grid, and CUDA blocks run
// in no order. No atomics, so results are deterministic for a given card.
//
// K1 and K2 replace _stats_kernel (:189) and _loss_kernel (:266). Bounds on
// an H100 SXM (3.35 TB/s; 495 TFLOP/s dense TF32 on the tensor cores, so 165
// TFLOP/s for an FP32-accurate 3xTF32 product; 67 TFLOP/s FP32 on the CUDA
// cores) at B=256, K=50, V=100,000: K1 moves ~21 MB (6 us) and does
// 2BKV = 2.56 GFLOP, 16 us as 3xTF32: its bound is 0.0155 ms, by operations.
// The tile product puts those operations on the tensor cores. Since theta is
// the same for every tile, its TF32 halves are split once per block and kept
// in shared memory, and in the 32-wide layout the block splits each beta
// tile once (hi in place, lo beside it) rather than each warp splitting it
// again, so the product's operands cost shared-memory loads, not splitting
// instructions. The column statistics stay in registers: a column's sum is
// reduced over the eight row groups of a warp by shuffles and over the warps
// through shared memory (twice: the mean, then the centred variance). Each of
// the four lanes holding a row keeps its own online-softmax (m, s) across the
// block's tiles, and the four merge once, at the end, with two shuffles. K2
// moves ~123 MB (37 us) for the same 2.56 GFLOP: its bound is 0.0368 ms, by
// bytes, 102 MB of it x. Its x rows come through the ring beside beta, so the
// next tile's x streams in while the current tile's product and loss epilogue
// run; the epilogue takes 1/s per row and the hardware's fast reciprocal and
// log2 for p/(p + floor) and log(p + floor). The partials are folded by a warp
// per row, which hides the latency of the [grid, B] loads.
//
// Batches past the tensor-core layouts (more than 1,024 rows, or theta and
// the ring past the card's shared memory) take the CUDA-core K1 and K2 of
// the first port (simt_stats_kernel, simt_loss_kernel), chosen by shape alone
// in fd_stats and fd_loss: 32-column strips, one lane per column, theta and
// the strip in shared memory, FP32 FMAs. Every batch those kernels took is
// still accepted, and the tensor-core layouts take every batch K3 takes (the
// 16-wide layout leaves beta's split to each warp so that it fits wherever
// K3's does).
//
// K3 replaces _grads_kernel (:612). It moves ~143 MB (43 us) and does
// 3 x 2.56 GFLOP, which take 46 us as 3xTF32 on the tensor cores (115 us as
// FP32 FMAs): its bound is those operations. After the tile product it
// computes n, p and gn on the accumulator fragments; gz is staged once in
// shared memory as float32 (with FP32 storage in place of the tile's x);
// then half the warps accumulate g_theta += gz beta_tile^T in shared memory
// across the block's tiles while the other half write g_beta = theta^T gz
// straight to its columns. Occupancy is one block per SM (228.6 KB of
// shared memory at B=256, K=50 with FP32 storage, 219.7 KB with bf16; at
// most 128 registers a thread); four warps per scheduler and independent
// mma chains hide the mma latency. Every FP32 operand is split into its TF32
// halves with five integer and FP32 instructions before its mma, so each mma
// costs several instructions besides itself, and its operands come from
// shared memory: the kernel is bound by those instructions and operand
// loads, not by the tensor cores' rate. The [grid, B, K] g_theta partials are folded in
// block order by a thread per element.
//
// bf16 storage (compute_dtype="bfloat16"; the TPU kernels' bf16-storage
// instantiation, _pad_core :459-481 and the upcasts at :219, :296, :643):
// beta and x arrive as bf16 at a row pitch ld, a multiple of 8 values (the
// wrapper's float32 -> bf16 cast writes them so). Every kernel takes the
// storage type as a template parameter; theta, mean, var and all the math
// stay float32, and the ring copies bf16 rows into bf16 stages of shared
// memory 16 bytes (8 values) a copy at every V. A bf16 value is exact in
// TF32 (8 significant bits of TF32's 11, the same exponent): its TF32 hi
// half is the value itself and its lo half is zero. So every product with a
// bf16 operand takes two TF32 products per k-step (a_lo*b + a_hi*b) where
// FP32 takes three, reading the bf16 value where the FP32 kernel splits its
// operand; the product left out is exactly zero and the others keep their
// order, so the outputs are the FP32 kernels' on the bf16-rounded values bit
// for bit. K1 and K2 take two for z; K2 reads x as bf16 pairs. K3 takes two
// for z = theta beta and two for g_theta += gz beta^T, reads x in pass 1 as
// bf16 pairs, and keeps three for g_beta = theta^T gz, whose operands are
// float32: seven TF32 products of the FP32 kernel's nine, with no split of
// beta and no upcast pass; its z loop stays rolled (unrolled by the
// compiler, the 16-wide variant spilled at the 128-register cap). Its gn and
// gz go to a float32 [B, Px] tile of their own, not over x, so no float32
// row overwrites bf16 rows that other warps have yet to read, and its layout
// is never larger than the FP32 one: every (B, K) the FP32 layout takes, the
// bf16 one takes, some on a wider tile. So K3 on bf16 storage is bound as the
// FP32 kernel is, with fewer of the instructions and operand loads that bind
// it. At B=256, K=50, V=100,000 K2 moves ~61 MB (bound 0.0186 ms, bytes),
// K1 ~11 MB for two TF32 products (0.0103 ms, operations) and K3 ~82 MB for
// seven (0.0362 ms, operations). Up to 256 rows, bf16 K1 and K2 take tiles
// of 64 columns with theta's float32 values in each lane's own slots, the
// beta fragments in 16-byte loads, a deeper ring, one cross-warp step for K1's
// statistics and K2's terms only where x is nonzero ("bf16 K1 and K2 on wide
// tiles" below); their z is the 32-column kernels' bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 32;          // CUDA-core K1/K2: columns per strip, one lane per column
constexpr int kPitch = kStrip + 1;  // padded pitch of the beta strip rows
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 4;         // rows per thread in the strip product
constexpr int kTopicTile = 4;       // topic padding of the CUDA-core layouts
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind { kStats = 0, kLoss = 1, kGrads = 2 };
// fd_plan's and fd_route's kind carries this bit for the bf16 instantiations.
constexpr int kBf16Kind = 4;

using bf16 = __nv_bfloat16;
template <typename TS> constexpr bool kIsBf16 = false;
template <> constexpr bool kIsBf16<bf16> = true;

// A stored element as float32.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Two adjacent stored elements (4-byte aligned) as float32.
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A bf16 value's TF32 bit pattern: the value itself, exact.
__device__ __forceinline__ uint32_t bf16_tf32(bf16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16;
}

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

// ---------------------------------------------------------------------------
// CUDA-core K1 and K2, for the batches the tensor-core layouts do not take.
// ---------------------------------------------------------------------------

// theta [B, K] -> shared [Bp, Kp], zero-padded.
__device__ void load_theta(float* th_s, const float* __restrict__ theta, int B, int K,
                           int Bp, int Kp) {
  for (int i = threadIdx.x; i < Bp * Kp; i += kThreads) {
    const int r = i / Kp, k = i - r * Kp;
    th_s[i] = (r < B && k < K) ? theta[(size_t)r * K + k] : 0.f;
  }
}

// beta[:, v0:v0+32] (rows at pitch ld) -> shared [Kp, kPitch] in float32,
// zero-padded past K and V.
template <typename TS>
__device__ void load_beta_strip(float* b_s, const TS* __restrict__ beta, int K, int Kp, int V,
                                int ld, int v0) {
  for (int i = threadIdx.x; i < Kp * kStrip; i += kThreads) {
    const int k = i / kStrip, c = i - k * kStrip;
    const int v = v0 + c;
    b_s[k * kPitch + c] = (k < K && v < V) ? to_f32(beta[(size_t)k * ld + v]) : 0.f;
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

// Shared memory of the CUDA-core K1 and K2, in floats.
size_t simt_smem_floats(int kind, int B, int K) {
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

template <typename TS>
__global__ void __launch_bounds__(kThreads)
simt_stats_kernel(const float* __restrict__ theta, const TS* __restrict__ beta,
                  const float* __restrict__ mask, const float* __restrict__ run_mean,
                  const float* __restrict__ run_var, float* __restrict__ mean_out,
                  float* __restrict__ var_out, float* __restrict__ m_part,
                  float* __restrict__ s_part, int B, int K, int V, int ld, int training,
                  float eps, int strips_per_block) {
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
    load_beta_strip(b_s, beta, K, Kp, V, ld, v0);
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

template <typename TS>
__global__ void __launch_bounds__(kThreads)
simt_loss_kernel(const float* __restrict__ theta, const TS* __restrict__ beta,
                 const TS* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ var, const float* __restrict__ m,
                 const float* __restrict__ s, float* __restrict__ loss_part,
                 float* __restrict__ rd_part, int B, int K, int V, int ld, float eps,
                 float floor_, int strips_per_block) {
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
    load_beta_strip(b_s, beta, K, Kp, V, ld, v0);
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
          const float xv = col_ok ? to_f32(x[(size_t)r * ld + col]) : 0.f;
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
// Partials folded in block order.
// ---------------------------------------------------------------------------

// K1 and K2's [grid, B] partials are folded by a warp per row: lane l takes
// blocks l, l + 32, ... in order, then the lanes combine by a butterfly, so
// the order is fixed and the latency is that of grid / 32 loads.

// The blocks' (max, denominator) partials of row r.
__global__ void merge_softmax_kernel(const float* __restrict__ m_part,
                                     const float* __restrict__ s_part, int grid, int B,
                                     float* __restrict__ m_out, float* __restrict__ s_out) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (r >= B) return;  // the whole warp
  float m = kNegInf;
  for (int g = lane; g < grid; g += 32) m = fmaxf(m, m_part[(size_t)g * B + r]);
  m = warp_max(m);
  const float safe = fmaxf(m, 0.5f * kNegInf);
  float s = 0.f;
  for (int g = lane; g < grid; g += 32) {
    s += s_part[(size_t)g * B + r] * expf(fminf(m_part[(size_t)g * B + r] - safe, 0.f));
  }
  s = warp_sum(s);
  if (lane == 0) {
    m_out[r] = m;
    s_out[r] = s;
  }
}

// a_out[r] = sum_g a_part[g, r] for the first B warps, b likewise for the
// next B.
__global__ void fold_rows_kernel(const float* __restrict__ a_part,
                                 const float* __restrict__ b_part, int grid, int B,
                                 float* __restrict__ a_out, float* __restrict__ b_out) {
  int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= 2 * B) return;  // the whole warp
  const float* part = r < B ? a_part : b_part;
  float* out = r < B ? a_out : b_out;
  r = r < B ? r : r - B;
  float t = 0.f;
  for (int g = lane; g < grid; g += 32) t += part[(size_t)g * B + r];
  t = warp_sum(t);
  if (lane == 0) out[r] = t;
}

// out[i] = sum_g part[g, i], in block order (K3's g_theta).
__global__ void sum_partials_kernel(const float* __restrict__ part, int grid, int n,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = 0.f;
  for (int g = 0; g < grid; ++g) t += part[(size_t)g * n + i];
  out[i] = t;
}

// ---------------------------------------------------------------------------
// The tensor-core machinery of K1-K3: 3xTF32 mma.sync, the copy ring, the
// tile product.
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 512;  // 16 warps: four per scheduler hide the mma latency
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kHalf = kTcWarps / 2;
constexpr int kChunk = 4;  // K3's g_theta n-tiles in flight per warp

// The tile timeline: a build of this source with -DFD_TIMELINE (a library of
// its own, ops/timeline.py; never the production one) records clock64() at
// each phase boundary of K1 and K2, per block, tile and warp (lane 0), into
// fd_tl [kTlBlocks, kTlTiles + 1, kTcWarps, kTlStamps]; its row kTlTiles
// holds the block's prologue and end. fd_timeline_* clear and read it.
// Without the define the stamps are empty statements.
constexpr int kTlBlocks = 132, kTlTiles = 64, kTlStamps = 8;
#ifdef FD_TIMELINE
__device__ long long fd_tl[kTlBlocks * (kTlTiles + 1) * kTcWarps * kTlStamps];
__device__ __forceinline__ void fd_stamp(int row, int slot) {
  if ((threadIdx.x & 31) == 0 && blockIdx.x < kTlBlocks && row <= kTlTiles) {
    const int w = threadIdx.x >> 5;
    fd_tl[((blockIdx.x * (kTlTiles + 1) + row) * kTcWarps + w) * kTlStamps + slot] = clock64();
  }
}
#define FD_TILE(it, slot) fd_stamp((it) < kTlTiles ? (it) : kTlTiles + 1, (slot))
#define FD_BLOCK(slot) fd_stamp(kTlTiles, (slot))
#else
#define FD_TILE(it, slot) ((void)0)
#define FD_BLOCK(slot) ((void)0)
#endif

// Per tile width and storage: the x and beta tiles' row pitches in stored
// elements (x: 8 or 24 mod 32 floats, or 20 or 12 mod 32 words of bf16 pairs,
// so fragments of x, gn and gz load without bank conflicts; beta's bf16 rows
// likewise; rows stay 16-byte aligned for the 16-byte copies) and the most
// 16-row tiles a warp holds (a warp keeps its tiles' fragments in registers
// across a tile's passes, so this caps B at kMaxMt * 16 * kTcWarps). K3's
// float32 gz tile of the bf16 kernels takes the float32 x pitch.
//
// split_b: K1 and K2 split each FP32 beta tile into its TF32 halves once per
// block (hi in place, lo beside it) in the 32-wide layout; the 16-wide one,
// for batches past 256 rows, leaves that to each warp, as K3 does, so that it
// fits wherever K3's layout fits. A bf16 tile needs no split.
//
// The wide tile (kWideVt = 64 columns) is bf16 K1's and K2's alone (see
// "bf16 K1 and K2 on wide tiles"): x at 72 values (144 bytes, 16 mod 128,
// so a lane's two 16-byte loads of a row and its neighbour's land in other
// banks) and beta at 80 (160 bytes, 32 mod 128, likewise for the four rows
// of a k-step).
constexpr int kWideVt = 64;
__host__ __device__ constexpr int tile_px(int vt) {
  return vt == kWideVt ? 72 : vt == 32 ? 40 : 24;
}
__host__ __device__ constexpr int tile_pb(int vt, bool bf) {
  return vt == kWideVt ? 80 : vt == 32 ? 40 : (bf ? 24 : 16);
}
__host__ __device__ constexpr bool tile_split_b(int vt, bool bf) { return vt == 32 && !bf; }
__host__ __device__ constexpr int tile_rows(int vt) {
  return (vt == 16 ? 4 : 1) * 16 * kTcWarps;
}

template <typename TS, int VT> struct Tile {
  static constexpr bool kBf16 = kIsBf16<TS>;
  static constexpr int kPx = tile_px(VT), kPb = tile_pb(VT, kBf16);
  static constexpr int kMaxMt = VT == 16 ? 4 : 1;
  static constexpr bool kSplitB = tile_split_b(VT, kBf16);
};

// Floats that n stored elements of a tile take, rounded up to 16 bytes.
__host__ __device__ inline size_t stored_floats(size_t n, bool bf) {
  return ((bf ? (n + 1) / 2 : n) + 3) / 4 * 4;
}

__host__ __device__ inline size_t up4(size_t n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cvt.rna.tf32.f32 of a finite float: round to nearest (ties away from zero)
// at the 10-bit TF32 mantissa and clear the 13 bits below it. ptxas expands
// the PTX instruction into these two integer operations plus a guard that
// passes inf and NaN through unrounded; the kernels' operands are finite.
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

// The A fragment (rows r_lo and r_hi = r_lo + 8, columns k0 + tig and
// k0 + tig + 4) of theta [rows, pitch] in shared memory, split here; rows
// past B read 0.
struct ThetaFrag {
  const float* th;
  int pitch, r_lo, r_hi, tig;
  bool ok_lo, ok_hi;
  __device__ __forceinline__ void operator()(int k0, uint32_t (&ah)[4], uint32_t (&al)[4]) const {
    split_tf32(ok_lo ? th[r_lo * pitch + k0 + tig] : 0.f, ah[0], al[0]);
    split_tf32(ok_hi ? th[r_hi * pitch + k0 + tig] : 0.f, ah[1], al[1]);
    split_tf32(ok_lo ? th[r_lo * pitch + k0 + tig + 4] : 0.f, ah[2], al[2]);
    split_tf32(ok_hi ? th[r_hi * pitch + k0 + tig + 4] : 0.f, ah[3], al[3]);
  }
};

// The B fragment of n-tile nt (rows k0 + tig and k0 + tig + 4, column
// nt * 8 + grp) of a beta tile [Kp, pitch] in shared memory, split here.
struct BetaFrag {
  static constexpr bool kExact = false;
  const float* bs;
  int pitch, grp, tig;
  __device__ __forceinline__ void operator()(int k0, int nt, uint32_t (&bh)[2],
                                             uint32_t (&bl)[2]) const {
    split_tf32(bs[(k0 + tig) * pitch + nt * 8 + grp], bh[0], bl[0]);
    split_tf32(bs[(k0 + tig + 4) * pitch + nt * 8 + grp], bh[1], bl[1]);
  }
};

// The same A fragment from theta's TF32 halves, split once per block.
struct ThetaHalves {
  const uint32_t* hi;
  const uint32_t* lo;
  int pitch, r_lo, r_hi, tig;
  bool ok_lo, ok_hi;
  __device__ __forceinline__ void operator()(int k0, uint32_t (&ah)[4], uint32_t (&al)[4]) const {
    const int a = r_lo * pitch + k0 + tig, b = r_hi * pitch + k0 + tig;
    ah[0] = ok_lo ? hi[a] : 0u;
    al[0] = ok_lo ? lo[a] : 0u;
    ah[1] = ok_hi ? hi[b] : 0u;
    al[1] = ok_hi ? lo[b] : 0u;
    ah[2] = ok_lo ? hi[a + 4] : 0u;
    al[2] = ok_lo ? lo[a + 4] : 0u;
    ah[3] = ok_hi ? hi[b + 4] : 0u;
    al[3] = ok_hi ? lo[b + 4] : 0u;
  }
};

// The same B fragment from a beta tile's TF32 halves, split once per block.
struct BetaHalves {
  static constexpr bool kExact = false;
  const uint32_t* hi;
  const uint32_t* lo;
  int pitch, grp, tig;
  __device__ __forceinline__ void operator()(int k0, int nt, uint32_t (&bh)[2],
                                             uint32_t (&bl)[2]) const {
    const int i = (k0 + tig) * pitch + nt * 8 + grp;
    bh[0] = hi[i];
    bl[0] = lo[i];
    bh[1] = hi[i + 4 * pitch];
    bl[1] = lo[i + 4 * pitch];
  }
};

// The same B fragment of a bf16 beta tile [Kp, pitch]: each value is its own
// TF32 hi half, and its lo half is zero (kExact).
struct BetaBf16 {
  static constexpr bool kExact = true;
  const bf16* bs;
  int pitch, grp, tig;
  __device__ __forceinline__ void operator()(int k0, int nt, uint32_t (&bh)[2],
                                             uint32_t (&bl)[2]) const {
    bh[0] = bf16_tf32(bs[(k0 + tig) * pitch + nt * 8 + grp]);
    bh[1] = bf16_tf32(bs[(k0 + tig + 4) * pitch + nt * 8 + grp]);
    bl[0] = bl[1] = 0u;
  }
};

// The B-fragment reader of a stored beta tile that no layout split.
__device__ __forceinline__ BetaFrag beta_frag(const float* bs, int pitch, int grp, int tig) {
  return BetaFrag{bs, pitch, grp, tig};
}
__device__ __forceinline__ BetaBf16 beta_frag(const bf16* bs, int pitch, int grp, int tig) {
  return BetaBf16{bs, pitch, grp, tig};
}

// K3's B fragment of beta_tile^T (topic kk, columns c and c + 4 of the tile)
// from p = the element (kk, c) of a bf16 tile: read as it is, its lo half
// zero (mma_ab<true>).
__device__ __forceinline__ void beta_t_frag(const bf16* p, uint32_t (&bh)[2],
                                            uint32_t (&bl)[2]) {
  bh[0] = bf16_tf32(p[0]);
  bh[1] = bf16_tf32(p[4]);
  bl[0] = bl[1] = 0u;
}

// D += a*b as 3xTF32, or, when b is exact in TF32 (its lo half zero), as
// a_lo*b + a_hi*b: the product left out adds exactly zero, so the sum is
// mma_3xtf32's bit for bit.
template <bool kExact>
__device__ __forceinline__ void mma_ab(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  if constexpr (kExact) {
    mma_tf32(d, al, bh);
    mma_tf32(d, ah, bh);
  } else {
    mma_3xtf32(d, ah, al, bh, bl);
  }
}

// z = theta beta_tile for one warp's 16-row tile: acc[nt] is the m16n8
// accumulator fragment of columns nt*8 .. nt*8+7 (rows grp and grp + 8,
// columns 2*tig and 2*tig + 1). K1, K2 and K3 all sum k0 = 0, 8, .. < Kp in
// this order, each k-step as mma_3xtf32 (two of its products for a bf16
// beta), so they take the same z. kRolled keeps the k loop rolled, where
// the compiler would unroll it past the register cap (bf16 K3).
template <int kNt, bool kRolled = false, typename AFrag, typename BFrag>
__device__ __forceinline__ void tile_product(float (&acc)[kNt][4], int Kp, const AFrag& a_frag,
                                             const BFrag& b_frag) {
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  auto k_step = [&](int k0) {
    uint32_t ah[4], al[4];
    a_frag(k0, ah, al);
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      uint32_t bh[2], bl[2];
      b_frag(k0, nt, bh, bl);
      mma_ab<BFrag::kExact>(acc[nt], ah, al, bh, bl);
    }
  };
  if constexpr (kRolled) {
#pragma unroll 1
    for (int k0 = 0; k0 < Kp; k0 += 8) k_step(k0);
  } else {
    for (int k0 = 0; k0 < Kp; k0 += 8) k_step(k0);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
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

// The ring: tile it of a block goes to stage it % kStages while the next
// tile loads into the other stage. The wide tiles' ring has kWideStages.
constexpr int kStages = 2;
constexpr int kWideStages = 3;

// Start loading columns v0..v0+VT (those below V) of beta's K rows, the first
// nx rows of x (both at row pitch ld), and (n_mv = 2) mean and var into one
// ring stage (beta rows at pitch Pb, x rows at Px, in stored elements), by
// every thread of the block. FP32: 16-byte cp.async when every
// row starts on 16 bytes (kVec16: V % 4 == 0, so ncols is a multiple of 4
// too), else 4-byte. bf16: 8 values a 16-byte copy for beta and x (ld is a
// multiple of 8), but the row's last values below V by plain loads, zero past
// V, so nothing past V is read; 4-byte copies for mean and var. The caller
// commits the group.
template <typename TS, int VT, bool kVec16, int Pb = Tile<TS, VT>::kPb,
          int Px = Tile<TS, VT>::kPx>
__device__ void load_tile(TS* b_dst, TS* x_dst, float* mv_dst, const TS* __restrict__ beta,
                          const TS* __restrict__ x, const float* __restrict__ mean,
                          const float* __restrict__ var, int nx, int K, int V, int ld, int v0,
                          int n_mv) {
  const int ncols = min(VT, V - v0);
  if constexpr (kIsBf16<TS>) {
    static_assert(kVec16, "bf16 rows always take the 16-byte ring");
    constexpr int kW = 8;
    for (int i = threadIdx.x; i < (K + nx) * (VT / kW); i += kTcThreads) {
      const int row = i / (VT / kW), c = (i - row * (VT / kW)) * kW;
      if (c < ncols) {
        bf16* dst;
        const bf16* src;
        if (row < K) {
          dst = b_dst + row * Pb + c;
          src = beta + (size_t)row * ld + v0 + c;
        } else {
          const int r = row - K;
          dst = x_dst + r * Px + c;
          src = x + (size_t)r * ld + v0 + c;
        }
        if (c + kW <= ncols) {
          cp_async16(dst, src);
        } else {  // the row's last values: nothing past V is read
          for (int e = 0; e < kW; ++e) dst[e] = c + e < ncols ? src[e] : __float2bfloat16(0.f);
        }
      }
    }
    for (int i = threadIdx.x; i < n_mv * VT; i += kTcThreads) {
      const int j = i / VT, c = i - j * VT;
      if (c < ncols) cp_async4(mv_dst + j * VT + c, (j ? var : mean) + v0 + c);
    }
  } else {
    constexpr int kW = kVec16 ? 4 : 1;
    const int rows = K + nx + n_mv;
    for (int i = threadIdx.x; i < rows * (VT / kW); i += kTcThreads) {
      const int row = i / (VT / kW), c = (i - row * (VT / kW)) * kW;
      if (c < ncols) {
        float* dst;
        const float* src;
        if (row < K) {
          dst = b_dst + row * Pb + c;
          src = beta + (size_t)row * ld + v0 + c;
        } else if (row < K + nx) {
          const int r = row - K;
          dst = x_dst + r * Px + c;
          src = x + (size_t)r * ld + v0 + c;
        } else {
          const int j = row - K - nx;
          dst = mv_dst + j * VT + c;
          src = (j ? var : mean) + v0 + c;
        }
        if (kVec16) {
          cp_async16(dst, src);
        } else {
          cp_async4(dst, src);
        }
      }
    }
  }
}

// Wait for the oldest tile in flight (the caller syncs the block).
__device__ __forceinline__ void wait_tile() {
  cp_async_commit();  // possibly empty: one group per tile
  cp_async_wait_prior();
}

// K1 and K2's shared memory at tile width vt and storage bf (bf16 or FP32),
// as offsets in floats: theta's TF32 halves hi and lo [B, Pth] each (Pth =
// Kp + 4, 4 mod 8, so the A fragments load without conflicts); the ring's
// stages of x [B, Px] (K2 only) and beta [Kp, Pb] (rows K..Kp-1 stay zero),
// stored, and mean/var [2, vt]; the lo half of the current beta tile [Kp, Pb]
// (split_b); K1's column reductions [kTcWarps, vt], mean and inv_std [vt] and
// the row count. The wide tiles keep theta as float32 in each lane's own
// slots [kTcWarps, Kp / 8, 32 lanes, 4] (at th_hi; no th_lo) and have
// kWideStages stages, and K1's reductions there are two [kTcWarps, vt]
// (each warp's column sums and centred sums of squares) beside the warps'
// row counts and their inverses [kTcWarps] each.
struct FwdLayout {
  int Kp, Pth;
  size_t th_hi, th_lo, x, x_stage, b, b_stage, b_lo, mv, cols, floats;
};

__host__ __device__ inline FwdLayout fwd_layout(int kind, int vt, int B, int K, bool bf) {
  const bool wide = vt == kWideVt;
  const int S = wide ? kWideStages : kStages;
  FwdLayout L;
  L.Kp = round_up(K, 8);
  L.Pth = L.Kp + 4;
  L.th_hi = 0;
  L.th_lo = L.th_hi + (wide ? (size_t)kTcWarps * L.Kp * 16 : up4((size_t)B * L.Pth));
  L.x = L.th_lo + (wide ? 0 : up4((size_t)B * L.Pth));
  L.x_stage = kind == kLoss ? stored_floats((size_t)B * tile_px(vt), bf) : 0;
  L.b = L.x + S * L.x_stage;
  L.b_stage = stored_floats((size_t)L.Kp * tile_pb(vt, bf), bf);
  L.b_lo = L.b + S * L.b_stage;
  L.mv = L.b_lo + (tile_split_b(vt, bf) ? L.b_stage : 0);
  L.cols = L.mv + S * 2 * (size_t)vt;
  L.floats = L.cols + (kind != kStats ? 0
                       : wide     ? (size_t)(2 * kTcWarps + 2) * vt + 2 * kTcWarps + 4
                                  : (size_t)(kTcWarps + 2) * vt + 4);
  return L;
}

// theta [B, K] -> its TF32 halves in shared [B, Pth], columns K..Kp-1 zero.
__device__ void load_theta_halves(uint32_t* hi, uint32_t* lo, const float* __restrict__ theta,
                                  int B, int K, int Kp, int Pth) {
  for (int i = threadIdx.x; i < B * Kp; i += kTcThreads) {
    const int r = i / Kp, k = i - r * Kp;
    split_tf32(k < K ? theta[(size_t)r * K + k] : 0.f, hi[r * Pth + k], lo[r * Pth + k]);
  }
}

// The current ring stage's beta tile [Kp, Pb] -> its TF32 halves, hi in
// place and lo into b_lo, once for the whole block (the caller syncs before
// and after).
template <int VT>
__device__ void split_beta_tile(float* bs, uint32_t* b_lo, int Kp) {
  constexpr int Pb = Tile<float, VT>::kPb;
  for (int i = threadIdx.x; i < Kp * VT; i += kTcThreads) {
    const int k = i / VT, j = k * Pb + (i - k * VT);
    uint32_t hi, lo;
    split_tf32(bs[j], hi, lo);
    bs[j] = __uint_as_float(hi);
    b_lo[j] = lo;
  }
}

// K1 and K2's z for one warp's 16-row tile: A fragments from theta's halves;
// B fragments from the beta tile's halves where the layout split it
// (kSplitB), else split here from the FP32 tile, or read as they are from a
// bf16 tile.
template <typename TS, int VT>
__device__ __forceinline__ void fwd_tile_product(float (&acc)[VT / 8][4], const uint32_t* th_hi,
                                                 const uint32_t* th_lo, int Pth, int Kp,
                                                 const TS* bs, const uint32_t* b_lo,
                                                 int r_lo, int B, int grp, int tig) {
  using T = Tile<TS, VT>;
  const ThetaHalves a{th_hi, th_lo, Pth, r_lo, r_lo + 8, tig, r_lo < B, r_lo + 8 < B};
  if constexpr (T::kSplitB) {
    tile_product(acc, Kp, a,
                 BetaHalves{reinterpret_cast<const uint32_t*>(bs), b_lo, T::kPb, grp, tig});
  } else {
    tile_product(acc, Kp, a, beta_frag(bs, T::kPb, grp, tig));
  }
}

__device__ void zero_smem(float* p, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += kTcThreads) p[i] = 0.f;
}

// ---------------------------------------------------------------------------
// bf16 K1 and K2 on wide tiles: 64 columns, theta in per-lane slots.
// ---------------------------------------------------------------------------
// Where a warp holds one 16-row tile (B <= 256) and the layout fits, bf16
// K1 and K2 take 64-column tiles. On the card the 32-column kernels spent a
// tile's time in the product's shared-memory loads (per k-step 8 of theta's
// halves and 8 two-byte beta values for 8 mma), in six __syncthreads and two
// serial cross-warp reductions, and, for K2, in three MUFU operations per
// (row, column).
//  - theta: each lane keeps its A fragments' float32 values in slots of its
//    own in shared memory, a k-step's four one 16-byte load (no barrier: a
//    lane reads only what it wrote), and splits each into its TF32 halves at
//    its k-step, as load_theta_halves splits it, so the halves are the same.
//    (Held in registers beside the 64-column accumulators they spilled at
//    the 128-register cap.)
//  - beta: the n-tiles' columns are permuted: column n of n-tile nt is tile
//    column 8 n + nt, so the B fragments of a lane's eight n-tiles at a
//    k-step are eight consecutive bf16 values of each of its two beta rows,
//    two 16-byte loads. acc[nt][2h + e] is then z of row grp + 8h and tile
//    column 16 tig + 8 e + nt: a lane's columns are the 16 from 16 tig on.
//    Each element of z is the same chain of mma as in the 32-column kernels
//    (k-steps in order, a_lo b then a_hi b, on the same values), so z is
//    theirs bit for bit.
//  - the ring has kWideStages stages; a tile's one __syncthreads, after its
//    copies have landed, also frees the stage that the next copy refills.
//  - K1's column statistics take one cross-warp step: each warp reduces its
//    rows' column sums and centred sums of squares about its own mean in
//    registers and shuffles, and 64 threads merge the warps' (count, sum,
//    M2) in warp order (Chan et al.; the row mask is 0 or 1). The mean is
//    the 32-column kernels' bit for bit (the same sums in the same order);
//    the variance differs in its last bits. Three __syncthreads per 64
//    columns.
//  - K2 takes a (row, column) term only where some lane of the warp has
//    x != 0 there: a term with x = 0 adds +0 or -0, which leaves the sums as
//    they are (they start at +0, and a sum that is not -0 stays so).
// A row's four lanes now sum other columns than in the 32-column kernels,
// so K1's s and K2's loss and rd differ from theirs in their last bits.
__device__ __forceinline__ void cp_async_wait_wide() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kWideStages - 2) : "memory");
}

// This lane's slots of theta: for each k-step ks < Kp / 8 its A-fragment
// values (rows r_lo and r_lo + 8, columns 8 ks + tig and 8 ks + tig + 4),
// 0 past B and K, at th_lane[32 ks]. Slots [warp][ks][lane].
__device__ __forceinline__ float4* theta_slots(float* th, int Kp, int warp, int lane) {
  return reinterpret_cast<float4*>(th) + (size_t)warp * (Kp / 8) * 32 + lane;
}

__device__ __forceinline__ void store_theta_slots(float4* th_lane, const float* __restrict__ theta,
                                                  int B, int K, int Kp, int r_lo, int tig) {
  for (int ks = 0; ks < Kp / 8; ++ks) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r_lo + 8 * (i & 1), k = ks * 8 + tig + 4 * (i >> 1);
      a[i] = r < B && k < K ? theta[(size_t)r * K + k] : 0.f;
    }
    th_lane[32 * ks] = make_float4(a[0], a[1], a[2], a[3]);
  }
}

// z = theta beta_tile for the warp's 16 rows and a wide tile's 64 columns,
// the n-tiles' columns permuted as above; k-steps below Kp.
__device__ __forceinline__ void wide_product(float (&acc)[kWideVt / 8][4], const float4* th_lane,
                                             int Kp, const bf16* bs, int grp, int tig) {
  constexpr int kNt = kWideVt / 8, Pb = tile_pb(kWideVt, true);
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int ks = 0; ks < Kp / 8; ++ks) {
    const float4 a = th_lane[32 * ks];
    uint32_t ah[4], al[4];
    split_tf32(a.x, ah[0], al[0]);
    split_tf32(a.y, ah[1], al[1]);
    split_tf32(a.z, ah[2], al[2]);
    split_tf32(a.w, ah[3], al[3]);
    const uint4 r0 = *reinterpret_cast<const uint4*>(bs + (ks * 8 + tig) * Pb + grp * 8);
    const uint4 r1 = *reinterpret_cast<const uint4*>(bs + (ks * 8 + tig + 4) * Pb + grp * 8);
    const uint32_t w[2][4] = {{r0.x, r0.y, r0.z, r0.w}, {r1.x, r1.y, r1.z, r1.w}};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      // The bf16 value nt of each row's eight: its TF32 bits, exact.
      uint32_t bh[2], bl[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 2; ++j) bh[j] = nt & 1 ? w[j][nt / 2] & 0xffff0000u : w[j][nt / 2] << 16;
      mma_ab<true>(acc[nt], ah, al, bh, bl);
    }
  }
}

// The sums of a lane's 16 values over the 8 lanes that share its tig
// (xor 4, 8, 16), transposed: 14 shuffles where a butterfly takes 48. Each
// level sends the half of its values that the partner keeps and adds the
// half it receives, so every sum is the butterfly's, bit for bit (the same
// pairs in the same tree, each add commutative). Lane grp ends with values
// 2 p and 2 p + 1, p = (grp & 1) * 4 + (grp & 2) + (grp >> 2 & 1).
__device__ __forceinline__ void sum16_over_rows(const float (&v)[16], float (&out)[2], int grp) {
  const bool b0 = grp & 1, b1 = grp & 2, b2 = grp & 4;
  float a[8], c[4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = (b0 ? v[j + 8] : v[j]) + __shfl_xor_sync(kFullMask, b0 ? v[j] : v[j + 8], 4);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = (b1 ? a[j + 4] : a[j]) + __shfl_xor_sync(kFullMask, b1 ? a[j] : a[j + 4], 8);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    out[j] = (b2 ? c[j + 2] : c[j]) + __shfl_xor_sync(kFullMask, b2 ? c[j] : c[j + 2], 16);
  }
}

// sum16_over_rows' inverse for one value a pair: every lane of the eight
// gets all 16 from the lanes that own them.
__device__ __forceinline__ void spread16_over_rows(const float (&in)[2], float (&v)[16], int grp) {
  const bool b0 = grp & 1, b1 = grp & 2, b2 = grp & 4;
  float a[8], c[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float other = __shfl_xor_sync(kFullMask, in[j], 16);
    c[j] = b2 ? other : in[j];
    c[j + 2] = b2 ? in[j] : other;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float other = __shfl_xor_sync(kFullMask, c[j], 8);
    a[j] = b1 ? other : c[j];
    a[j + 4] = b1 ? c[j] : other;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float other = __shfl_xor_sync(kFullMask, a[j], 4);
    v[j] = b0 ? other : a[j];
    v[j + 8] = b0 ? a[j] : other;
  }
}

// Eight consecutive floats of shared memory (16-byte aligned) in two loads.
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Rows K..Kp-1 of every stage of a wide ring's beta stay zero: theta's
// columns there are zero, and 0 times a stale value could be NaN.
__device__ __forceinline__ void zero_beta_pad(float* b_ring, size_t b_stage, int K, int Kp) {
  constexpr int Pb = tile_pb(kWideVt, true);
  for (int st = 0; st < kWideStages; ++st) {
    zero_smem(b_ring + st * b_stage + (size_t)K * Pb / 2, (size_t)(Kp - K) * Pb / 2);
  }
}

// K1 on wide tiles (stats_kernel<bf16, kWideVt, true>).
__device__ __forceinline__ void stats_wide(const float* __restrict__ theta,
                                           const bf16* __restrict__ beta,
                                           const float* __restrict__ mask,
                                           const float* __restrict__ run_mean,
                                           const float* __restrict__ run_var,
                                           float* __restrict__ mean_out,
                                           float* __restrict__ var_out,
                                           float* __restrict__ m_part, float* __restrict__ s_part,
                                           int B, int K, int V, int ld, int training, float eps,
                                           int tiles_per_block) {
  constexpr int VT = kWideVt, kNt = VT / 8, S = kWideStages;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  float* const sm = reinterpret_cast<float*>(tc_smem);
  const FwdLayout L = fwd_layout(kStats, VT, B, K, true);
  const int Kp = L.Kp;
  float* b_ring = sm + L.b;  // S stages of L.b_stage floats, stored as bf16
  float* mv_ring = sm + L.mv;
  float* sum_s = sm + L.cols;            // [kTcWarps][VT]: each warp's column sums
  float* m2_s = sum_s + kTcWarps * VT;   // [kTcWarps][VT]: and centred sums of squares
  float* mean_s = m2_s + kTcWarps * VT;  // [VT]
  float* istd_s = mean_s + VT;           // [VT]
  float* nw_s = istd_s + VT;             // [kTcWarps]: each warp's row count
  float* inw_s = nw_s + kTcWarps;        // [kTcWarps]: and its inverse (0 for none)
  float* cnt_s = inw_s + kTcWarps;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int n_tiles = (V + VT - 1) / VT;
  const int r_lo = warp * 16 + grp;
  const bool live = warp * 16 < B;  // warp-uniform: the warp holds rows
  const int n_mv = training ? 0 : 2;

  FD_BLOCK(0);
  zero_beta_pad(b_ring, L.b_stage, K, Kp);
  float4* const th_lane = theta_slots(sm + L.th_hi, Kp, warp, lane);
  store_theta_slots(th_lane, theta, B, K, Kp, r_lo, tig);
  float mk[2], m_run[2], s_run[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    mk[h] = r < B ? mask[r] : 0.f;
    m_run[h] = kNegInf;
    s_run[h] = 0.f;
  }
  const float nw = warp_sum(tig == 0 ? mk[0] + mk[1] : 0.f);
  const float inw = nw > 0.f ? 1.f / nw : 0.f;
  if (lane == 0) {
    nw_s[warp] = nw;
    inw_s[warp] = inw;
  }
  if (warp == 0) {
    float c = 0.f;
    for (int r = lane; r < B; r += 32) c += mask[r];
    c = warp_sum(c);
    if (lane == 0) cnt_s[0] = fmaxf(c, 1.f);
  }
  __syncthreads();
  const float cnt = cnt_s[0];
  FD_BLOCK(1);

  const int first = blockIdx.x * tiles_per_block;
  const int last = min(first + tiles_per_block, n_tiles);
  // Tile it of the block goes to stage it % S; S - 1 tiles load ahead.
  auto load = [&](int it) {
    if (first + it < last) {
      const int st = it % S;
      load_tile<bf16, VT, true>(reinterpret_cast<bf16*>(b_ring + st * L.b_stage), nullptr,
                                mv_ring + st * 2 * VT, beta, nullptr, run_mean, run_var, 0, K,
                                V, ld, (first + it) * VT, n_mv);
    }
    cp_async_commit();  // possibly empty: one group per tile
  };
  for (int it = 0; it < S - 1; ++it) load(it);
  for (int tile = first, it = 0; tile < last; ++tile, ++it) {
    const int st = it % S;
    const int v0 = tile * VT;
    const bool full = v0 + VT <= V;
    FD_TILE(it, 0);
    cp_async_wait_wide();
    __syncthreads();  // tile it has landed; every warp is past tile it - 1
    FD_TILE(it, 1);
    load(it + S - 1);  // into tile it - 1's stage
    const bf16* bs = reinterpret_cast<const bf16*>(b_ring + st * L.b_stage);
    const float* mvs = mv_ring + st * 2 * VT;
    float acc[kNt][4];
    if (live) {
      wide_product(acc, th_lane, Kp, bs, grp, tig);
    } else {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
    FD_TILE(it, 2);

    if (training) {
      // Per column, over the warp's rows: the masked sum (the 32-column
      // kernels' sums), the warp's mean and the masked sum of squares about
      // it. Value i = 2 nt + e; the lane ends with the sums of its pair p.
      float v[16], sums[2], m2[2];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        v[i] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) v[i] += acc[i / 2][2 * h + i % 2] * mk[h];
      }
      sum16_over_rows(v, sums, grp);
      {
        const float own[2] = {sums[0] * inw, sums[1] * inw};
        spread16_over_rows(own, v, grp);  // v: the warp's mean of each value's column
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float q = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d = (acc[i / 2][2 * h + i % 2] - v[i]) * mk[h];
          q += d * d;
        }
        v[i] = q;
      }
      sum16_over_rows(v, m2, grp);
      {
        const int p = (grp & 1) * 4 + (grp & 2) + (grp >> 2 & 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 16 * tig + 8 * e + p;
          sum_s[warp * VT + c] = sums[e];
          m2_s[warp * VT + c] = m2[e];
        }
      }
      __syncthreads();
      FD_TILE(it, 3);
      // The warps' partials merged in warp order: the mean as the 32-column
      // kernels sum it, then M2 = sum_w M2_w + n_w (mean_w - mean)^2, with
      // mean_w as the warp took it.
      if (tid < VT) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kTcWarps; ++w) t += sum_s[w * VT + tid];
        const float mean = t / cnt;
        float q = 0.f;
#pragma unroll
        for (int w = 0; w < kTcWarps; ++w) {
          const float d = sum_s[w * VT + tid] * inw_s[w] - mean;
          q += m2_s[w * VT + tid] + nw_s[w] * d * d;
        }
        const float var = q / cnt;  // biased
        mean_s[tid] = mean;
        istd_s[tid] = rsqrtf(var + eps);
        if (v0 + tid < V) {
          mean_out[v0 + tid] = mean;
          var_out[v0 + tid] = var;
        }
      }
      __syncthreads();
      FD_TILE(it, 4);
    } else {
      if (tid < VT && v0 + tid < V) {
        mean_out[v0 + tid] = mvs[tid];
        var_out[v0 + tid] = mvs[VT + tid];
      }
      FD_TILE(it, 3);
      FD_TILE(it, 4);
    }

    // The online softmax over this tile's valid columns, per row and lane;
    // a whole tile's columns are all valid, and a masked row keeps its
    // (-1e30, 0) as the per-value test would leave it.
    if (live && full) {
      float m_tile[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // The lane's eight columns 16 tig + 8 e .. + 7: mean and inv_std.
        float mu[8], istd[8];
        load8(mu, (training ? mean_s : mvs) + 16 * tig + 8 * e);
        load8(istd, (training ? istd_s : mvs + VT) + 16 * tig + 8 * e);
        if (!training) {
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) istd[nt] = rsqrtf(istd[nt] + eps);
        }
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float n = (acc[nt][2 * h + e] - mu[nt]) * istd[nt];
            acc[nt][2 * h + e] = n;
            m_tile[h] = fmaxf(m_tile[h], n);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_run[h], m_tile[h]);
        float e_sum[2] = {0.f, 0.f};  // two chains: even and odd n-tiles
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) e_sum[nt & 1] += expf(acc[nt][2 * h + e] - m_new);
        }
        if (mk[h] > 0.f) {
          s_run[h] = s_run[h] * expf(fminf(m_run[h] - m_new, 0.f)) + (e_sum[0] + e_sum[1]);
          m_run[h] = m_new;
        }
      }
    } else if (live) {
      float m_tile[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 16 * tig + 8 * e + nt;
          const bool col_ok = full || v0 + c < V;
          float mu = 0.f, istd = 1.f;
          if (training) {
            mu = mean_s[c];
            istd = istd_s[c];
          } else if (col_ok) {
            mu = mvs[c];
            istd = rsqrtf(mvs[VT + c] + eps);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool valid = col_ok && mk[h] > 0.f;
            const float n = valid ? (acc[nt][2 * h + e] - mu) * istd : kNegInf;
            acc[nt][2 * h + e] = n;
            m_tile[h] = fmaxf(m_tile[h], n);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_run[h], m_tile[h]);
        // Guard fully-masked rows: exp(-1e30 - -1e30) would be 1.
        const float safe = fmaxf(m_new, 0.5f * kNegInf);
        float e_sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool valid = (full || v0 + 16 * tig + 8 * e + nt < V) && mk[h] > 0.f;
            if (valid) e_sum += expf(acc[nt][2 * h + e] - safe);
          }
        }
        s_run[h] = s_run[h] * expf(fminf(m_run[h] - safe, 0.f)) + e_sum;
        m_run[h] = m_new;
      }
    }
    FD_TILE(it, 5);
    FD_TILE(it, 6);
  }
  FD_BLOCK(2);
  // The four lanes of each row merge their (m, s) by a butterfly, then write
  // the block's partial.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float m_o = __shfl_xor_sync(kFullMask, m_run[h], o);
      const float s_o = __shfl_xor_sync(kFullMask, s_run[h], o);
      const float m_new = fmaxf(m_run[h], m_o);
      const float safe = fmaxf(m_new, 0.5f * kNegInf);
      s_run[h] = s_run[h] * expf(fminf(m_run[h] - safe, 0.f)) +
                 s_o * expf(fminf(m_o - safe, 0.f));
      m_run[h] = m_new;
    }
    const int r = r_lo + 8 * h;
    if (tig == 0 && r < B) {
      m_part[(size_t)blockIdx.x * B + r] = m_run[h];
      s_part[(size_t)blockIdx.x * B + r] = s_run[h];
    }
  }
  FD_BLOCK(3);
}

// K2 on wide tiles (loss_kernel<bf16, kWideVt, true>).
__device__ __forceinline__ void loss_wide(const float* __restrict__ theta,
                                          const bf16* __restrict__ beta,
                                          const bf16* __restrict__ x,
                                          const float* __restrict__ mean,
                                          const float* __restrict__ var,
                                          const float* __restrict__ m,
                                          const float* __restrict__ s,
                                          float* __restrict__ loss_part,
                                          float* __restrict__ rd_part, int B, int K, int V, int ld,
                                          float eps, float floor_, int tiles_per_block) {
  constexpr int VT = kWideVt, kNt = VT / 8, S = kWideStages, Px = tile_px(VT);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  float* const sm = reinterpret_cast<float*>(tc_smem);
  const FwdLayout L = fwd_layout(kLoss, VT, B, K, true);
  const int Kp = L.Kp;
  float* x_ring = sm + L.x;  // S stages of L.x_stage floats, stored as bf16
  float* b_ring = sm + L.b;  // and of L.b_stage
  float* mv_ring = sm + L.mv;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int n_tiles = (V + VT - 1) / VT;
  const int r_lo = warp * 16 + grp;
  const bool live = warp * 16 < B;  // warp-uniform: the warp holds rows

  FD_BLOCK(0);
  zero_beta_pad(b_ring, L.b_stage, K, Kp);
  float4* const th_lane = theta_slots(sm + L.th_hi, Kp, warp, lane);
  store_theta_slots(th_lane, theta, B, K, Kp, r_lo, tig);
  // This lane's rows: the softmax max and 1 / denominator (fully-masked rows
  // have the (-1e30, 0) sentinel: forced finite, and their loss left out),
  // and the row's loss and row-dot, accumulated across the block's tiles.
  float sm_r[2], isl_r[2], loss_r[2], rd_r[2];
  bool ok_r[2], in_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    const bool ok = r < B && s[r] > 1e-20f;
    in_r[h] = r < B;
    sm_r[h] = ok ? m[r] : 0.f;
    isl_r[h] = 1.f / (ok ? s[r] : 1.f);
    ok_r[h] = ok;
    loss_r[h] = 0.f;
    rd_r[h] = 0.f;
  }
  __syncthreads();
  FD_BLOCK(1);

  const int first = blockIdx.x * tiles_per_block;
  const int last = min(first + tiles_per_block, n_tiles);
  // Tile it of the block goes to stage it % S; S - 1 tiles load ahead.
  auto load = [&](int it) {
    if (first + it < last) {
      const int st = it % S;
      load_tile<bf16, VT, true>(reinterpret_cast<bf16*>(b_ring + st * L.b_stage),
                                reinterpret_cast<bf16*>(x_ring + st * L.x_stage),
                                mv_ring + st * 2 * VT, beta, x, mean, var, B, K, V, ld,
                                (first + it) * VT, 2);
    }
    cp_async_commit();  // possibly empty: one group per tile
  };
  for (int it = 0; it < S - 1; ++it) load(it);
  for (int tile = first, it = 0; tile < last; ++tile, ++it) {
    const int st = it % S;
    const int v0 = tile * VT;
    const bool full = v0 + VT <= V;
    FD_TILE(it, 0);
    cp_async_wait_wide();
    __syncthreads();  // tile it has landed; every warp is past tile it - 1
    FD_TILE(it, 1);
    load(it + S - 1);  // into tile it - 1's stage
    const bf16* xs = reinterpret_cast<const bf16*>(x_ring + st * L.x_stage);
    const bf16* bs = reinterpret_cast<const bf16*>(b_ring + st * L.b_stage);
    const float* mvs = mv_ring + st * 2 * VT;
    float acc[kNt][4];
    if (live) wide_product(acc, th_lane, Kp, bs, grp, tig);
    FD_TILE(it, 2);
    if (live) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // x of the lane's two rows at columns 16 tig + 8 e .. + 7, zero past
        // B and V; a row's eight values are taken, or left out, together:
        // where every lane's eight are 0 (warp-uniform) their terms are +-0,
        // and a term with x = 0 that is taken adds +-0 as well (every value
        // it multiplies is finite, past V too).
        uint4 xw[2];
        bool any[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          xw[h] = in_r[h] ? *reinterpret_cast<const uint4*>(xs + (r_lo + 8 * h) * Px + 16 * tig +
                                                            8 * e)
                          : make_uint4(0u, 0u, 0u, 0u);
          if (!full) {
            uint32_t* w = &xw[h].x;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (v0 + 16 * tig + 8 * e + j >= V) w[j / 2] &= j & 1 ? 0x0000ffffu : 0xffff0000u;
            }
          }
          any[h] = __any_sync(kFullMask, (xw[h].x | xw[h].y | xw[h].z | xw[h].w) != 0u);
        }
        if (any[0] || any[1]) {
          float mu[8], istd[8];
          load8(mu, mvs + 16 * tig + 8 * e);
          load8(istd, mvs + VT + 16 * tig + 8 * e);
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) istd[nt] = rsqrtf(istd[nt] + eps);
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (any[h]) {
                const uint32_t w = (&xw[h].x)[nt / 2];
                const float xe = __uint_as_float(nt & 1 ? w & 0xffff0000u : w << 16);
                const float n = (acc[nt][2 * h + e] - mu[nt]) * istd[nt];
                const float p = expf(fminf(n - sm_r[h], 0.f)) * isl_r[h];
                if (ok_r[h]) loss_r[h] += xe * __logf(p + floor_);
                rd_r[h] += xe * __fdividef(p, p + floor_);
              }
            }
          }
        }
      }
    }
    FD_TILE(it, 3);
    FD_TILE(it, 4);
  }
  FD_BLOCK(2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lv = loss_r[h], rv = rd_r[h];
    lv += __shfl_xor_sync(kFullMask, lv, 1);
    rv += __shfl_xor_sync(kFullMask, rv, 1);
    lv += __shfl_xor_sync(kFullMask, lv, 2);
    rv += __shfl_xor_sync(kFullMask, rv, 2);
    const int r = r_lo + 8 * h;
    if (tig == 0 && r < B) {
      loss_part[(size_t)blockIdx.x * B + r] = -lv;
      rd_part[(size_t)blockIdx.x * B + r] = rv;
    }
  }
  FD_BLOCK(3);
}

// ---------------------------------------------------------------------------
// K1: batch-norm statistics + per-row online-softmax partials.
// ---------------------------------------------------------------------------
template <typename TS, int VT, bool kVec16>
__global__ void __launch_bounds__(kTcThreads, 1)
stats_kernel(const float* __restrict__ theta, const TS* __restrict__ beta,
             const float* __restrict__ mask, const float* __restrict__ run_mean,
             const float* __restrict__ run_var, float* __restrict__ mean_out,
             float* __restrict__ var_out, float* __restrict__ m_part,
             float* __restrict__ s_part, int B, int K, int V, int ld, int training, float eps,
             int tiles_per_block) {
  if constexpr (VT == kWideVt) {
    stats_wide(theta, beta, mask, run_mean, run_var, mean_out, var_out, m_part, s_part, B, K, V,
               ld, training, eps, tiles_per_block);
  } else {
    using T = Tile<TS, VT>;
    constexpr int kNt = VT / 8, kMt = T::kMaxMt;
    extern __shared__ __align__(128) unsigned char tc_smem[];
    float* const sm = reinterpret_cast<float*>(tc_smem);
    const FwdLayout L = fwd_layout(kStats, VT, B, K, T::kBf16);
    const int Kp = L.Kp, Pth = L.Pth;
    uint32_t* th_hi = reinterpret_cast<uint32_t*>(sm + L.th_hi);
    uint32_t* th_lo = reinterpret_cast<uint32_t*>(sm + L.th_lo);
    uint32_t* b_lo = reinterpret_cast<uint32_t*>(sm + L.b_lo);
    float* b_ring = sm + L.b;  // kStages stages of L.b_stage floats, stored as TS
    float* mv_ring = sm + L.mv;
    float* red_s = sm + L.cols;  // [kTcWarps][VT]
    float* mean_s = red_s + kTcWarps * VT;
    float* istd_s = mean_s + VT;
    float* cnt_s = istd_s + VT;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int grp = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
    const int n_tiles = (V + VT - 1) / VT;
    const int mt_count = (B + 15) / 16;
    const int n_mv = training ? 0 : 2;
    constexpr int S = kStages;

    FD_BLOCK(0);
    load_theta_halves(th_hi, th_lo, theta, B, K, Kp, Pth);
    zero_smem(b_ring, S * L.b_stage);
    zero_smem(mv_ring, S * 2 * VT);
    // This lane's rows (grp and grp + 8 of each of its 16-row tiles): the
    // mask and the running softmax max and denominator.
    float mk[kMt][2], m_run[kMt][2], s_run[kMt][2];
#pragma unroll
    for (int q = 0; q < kMt; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp + q * kTcWarps) * 16 + grp + 8 * h;
        mk[q][h] = r < B ? mask[r] : 0.f;
        m_run[q][h] = kNegInf;
        s_run[q][h] = 0.f;
      }
    }
    if (warp == 0) {
      float c = 0.f;
      for (int r = lane; r < B; r += 32) c += mask[r];
      c = warp_sum(c);
      if (lane == 0) cnt_s[0] = fmaxf(c, 1.f);
    }
    __syncthreads();
    const float cnt = cnt_s[0];
    FD_BLOCK(1);

    const int first = blockIdx.x * tiles_per_block;
    const int last = min(first + tiles_per_block, n_tiles);
    // Tile it of the block goes to stage it % S; S - 1 tiles load ahead.
    auto load = [&](int it) {
      if (first + it < last) {
        const int st = it % S;
        load_tile<TS, VT, kVec16>(reinterpret_cast<TS*>(b_ring + st * L.b_stage), nullptr,
                                  mv_ring + st * 2 * VT, beta, nullptr, run_mean, run_var, 0, K, V,
                                  ld, (first + it) * VT, n_mv);
      }
    };
    for (int it = 0; it < S - 1; ++it) {
      load(it);
      cp_async_commit();
    }
    for (int tile = first, it = 0; tile < last; ++tile, ++it) {
      const int st = it % S;
      const int v0 = tile * VT;
      FD_TILE(it, 0);
      load(it + S - 1);
      wait_tile();
      __syncthreads();
      FD_TILE(it, 1);
      TS* bs = reinterpret_cast<TS*>(b_ring + st * L.b_stage);
      const float* mvs = mv_ring + st * 2 * VT;
      if constexpr (T::kSplitB) {
        split_beta_tile<VT>(bs, b_lo, Kp);
        __syncthreads();
      }

      float acc[kMt][kNt][4];
#pragma unroll
      for (int q = 0; q < kMt; ++q) {
        const int mt = warp + q * kTcWarps;
        if (mt < mt_count) {
          fwd_tile_product<TS, VT>(acc[q], th_hi, th_lo, Pth, Kp, bs, b_lo, mt * 16 + grp, B,
                                   grp, tig);
        } else {
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            acc[q][nt][0] = acc[q][nt][1] = acc[q][nt][2] = acc[q][nt][3] = 0.f;
          }
        }
      }
      FD_TILE(it, 2);

      // This lane's columns (nt * 8 + 2 * tig + e): mean and inv_std.
      float mu[kNt][2] = {}, istd[kNt][2] = {};
      if (training) {
        // Masked column sums over the warp's rows (butterfly over the 8 row
        // groups), then over the warps in order: first the mean, then the
        // centred sum of squares (biased variance).
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = 0.f;
#pragma unroll
              for (int q = 0; q < kMt; ++q) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const float zv = acc[q][nt][2 * h + e];
                  const float d = pass ? (zv - mu[nt][e]) * mk[q][h] : zv * mk[q][h];
                  v += pass ? d * d : d;
                }
              }
#pragma unroll
              for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(kFullMask, v, o);
              if (grp == 0) red_s[warp * VT + nt * 8 + 2 * tig + e] = v;
            }
          }
          __syncthreads();
          if (tid < VT) {
            float t = 0.f;
            for (int w = 0; w < kTcWarps; ++w) t += red_s[w * VT + tid];
            if (pass == 0) {
              mean_s[tid] = t / cnt;
            } else {
              const float var = t / cnt;
              istd_s[tid] = rsqrtf(var + eps);
              if (v0 + tid < V) {
                mean_out[v0 + tid] = mean_s[tid];
                var_out[v0 + tid] = var;
              }
            }
          }
          __syncthreads();
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = nt * 8 + 2 * tig + e;
              if (pass == 0) {
                mu[nt][e] = mean_s[c];
              } else {
                istd[nt][e] = istd_s[c];
              }
            }
          }
          FD_TILE(it, 3 + pass);
        }
      } else {
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
        if (tid < VT && v0 + tid < V) {
          mean_out[v0 + tid] = mvs[tid];
          var_out[v0 + tid] = mvs[VT + tid];
        }
        FD_TILE(it, 3);
        FD_TILE(it, 4);
      }

      // The online softmax over this tile's valid columns, per row and lane:
      // each of the four lanes holding a row keeps its own running (m, s).
#pragma unroll
      for (int q = 0; q < kMt; ++q) {
        if (warp + q * kTcWarps < mt_count) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool row_ok = mk[q][h] > 0.f;
            float n[kNt][2];
            bool valid[kNt][2];
            float m_tile = kNegInf;
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                valid[nt][e] = row_ok && v0 + nt * 8 + 2 * tig + e < V;
                n[nt][e] = valid[nt][e] ? (acc[q][nt][2 * h + e] - mu[nt][e]) * istd[nt][e]
                                        : kNegInf;
                m_tile = fmaxf(m_tile, n[nt][e]);
              }
            }
            const float m_new = fmaxf(m_run[q][h], m_tile);
            // Guard fully-masked rows: exp(-1e30 - -1e30) would be 1.
            const float safe = fmaxf(m_new, 0.5f * kNegInf);
            float e_sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (valid[nt][e]) e_sum += expf(n[nt][e] - safe);
              }
            }
            s_run[q][h] = s_run[q][h] * expf(fminf(m_run[q][h] - safe, 0.f)) + e_sum;
            m_run[q][h] = m_new;
          }
        }
      }
      FD_TILE(it, 5);
      __syncthreads();  // the stage is free for the load of tile + S
      FD_TILE(it, 6);
    }
    FD_BLOCK(2);
    // The four lanes of each row merge their (m, s) by a butterfly, then write
    // the block's partial.
#pragma unroll
    for (int q = 0; q < kMt; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float m_o = __shfl_xor_sync(kFullMask, m_run[q][h], o);
          const float s_o = __shfl_xor_sync(kFullMask, s_run[q][h], o);
          const float m_new = fmaxf(m_run[q][h], m_o);
          const float safe = fmaxf(m_new, 0.5f * kNegInf);
          s_run[q][h] = s_run[q][h] * expf(fminf(m_run[q][h] - safe, 0.f)) +
                        s_o * expf(fminf(m_o - safe, 0.f));
          m_run[q][h] = m_new;
        }
        const int r = (warp + q * kTcWarps) * 16 + grp + 8 * h;
        if (tig == 0 && r < B) {
          m_part[(size_t)blockIdx.x * B + r] = m_run[q][h];
          s_part[(size_t)blockIdx.x * B + r] = s_run[q][h];
        }
      }
    }
    FD_BLOCK(3);
  }
}

// ---------------------------------------------------------------------------
// K2: row loss and row-dot partials.
// ---------------------------------------------------------------------------
template <typename TS, int VT, bool kVec16>
__global__ void __launch_bounds__(kTcThreads, 1)
loss_kernel(const float* __restrict__ theta, const TS* __restrict__ beta,
            const TS* __restrict__ x, const float* __restrict__ mean,
            const float* __restrict__ var, const float* __restrict__ m,
            const float* __restrict__ s, float* __restrict__ loss_part,
            float* __restrict__ rd_part, int B, int K, int V, int ld, float eps, float floor_,
            int tiles_per_block) {
  if constexpr (VT == kWideVt) {
    loss_wide(theta, beta, x, mean, var, m, s, loss_part, rd_part, B, K, V, ld, eps, floor_,
              tiles_per_block);
  } else {
    using T = Tile<TS, VT>;
    constexpr int kNt = VT / 8, kMt = T::kMaxMt, Px = T::kPx;
    extern __shared__ __align__(128) unsigned char tc_smem[];
    float* const sm = reinterpret_cast<float*>(tc_smem);
    const FwdLayout L = fwd_layout(kLoss, VT, B, K, T::kBf16);
    const int Kp = L.Kp, Pth = L.Pth;
    uint32_t* th_hi = reinterpret_cast<uint32_t*>(sm + L.th_hi);
    uint32_t* th_lo = reinterpret_cast<uint32_t*>(sm + L.th_lo);
    uint32_t* b_lo = reinterpret_cast<uint32_t*>(sm + L.b_lo);
    float* x_ring = sm + L.x;  // kStages stages of L.x_stage floats, stored as TS
    float* b_ring = sm + L.b;  // and of L.b_stage
    float* mv_ring = sm + L.mv;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int grp = lane >> 2, tig = lane & 3;
    const int n_tiles = (V + VT - 1) / VT;
    const int mt_count = (B + 15) / 16;

    constexpr int S = kStages;

    FD_BLOCK(0);
    load_theta_halves(th_hi, th_lo, theta, B, K, Kp, Pth);
    zero_smem(x_ring, S * L.x_stage);
    zero_smem(b_ring, S * L.b_stage);
    zero_smem(mv_ring, S * 2 * VT);
    // This lane's rows: the softmax max and 1 / denominator (fully-masked rows
    // have the (-1e30, 0) sentinel: forced finite, and their loss left out),
    // and the row's loss and row-dot, accumulated across the block's tiles.
    float sm_r[kMt][2], isl_r[kMt][2], loss_r[kMt][2], rd_r[kMt][2];
    bool ok_r[kMt][2];
#pragma unroll
    for (int q = 0; q < kMt; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp + q * kTcWarps) * 16 + grp + 8 * h;
        const bool ok = r < B && s[r] > 1e-20f;
        sm_r[q][h] = ok ? m[r] : 0.f;
        isl_r[q][h] = 1.f / (ok ? s[r] : 1.f);
        ok_r[q][h] = ok;
        loss_r[q][h] = 0.f;
        rd_r[q][h] = 0.f;
      }
    }
    __syncthreads();
    FD_BLOCK(1);

    const int first = blockIdx.x * tiles_per_block;
    const int last = min(first + tiles_per_block, n_tiles);
    // Tile it of the block goes to stage it % S; S - 1 tiles load ahead.
    auto load = [&](int it) {
      if (first + it < last) {
        const int st = it % S;
        load_tile<TS, VT, kVec16>(reinterpret_cast<TS*>(b_ring + st * L.b_stage),
                                  reinterpret_cast<TS*>(x_ring + st * L.x_stage),
                                  mv_ring + st * 2 * VT, beta, x, mean, var, B, K, V, ld,
                                  (first + it) * VT, 2);
      }
    };
    for (int it = 0; it < S - 1; ++it) {
      load(it);
      cp_async_commit();
    }
    for (int tile = first, it = 0; tile < last; ++tile, ++it) {
      const int st = it % S;
      const int v0 = tile * VT;
      FD_TILE(it, 0);
      load(it + S - 1);
      wait_tile();
      __syncthreads();
      FD_TILE(it, 1);
      const TS* xs = reinterpret_cast<const TS*>(x_ring + st * L.x_stage);
      TS* bs = reinterpret_cast<TS*>(b_ring + st * L.b_stage);
      const float* mvs = mv_ring + st * 2 * VT;
      if constexpr (T::kSplitB) {
        split_beta_tile<VT>(bs, b_lo, Kp);
        __syncthreads();
      }

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

#pragma unroll
      for (int q = 0; q < kMt; ++q) {
        const int mt = warp + q * kTcWarps;
        if (mt < mt_count) {
          const int r_lo = mt * 16 + grp, r_hi = r_lo + 8;
          float acc[kNt][4];
          fwd_tile_product<TS, VT>(acc, th_hi, th_lo, Pth, Kp, bs, b_lo, r_lo, B, grp, tig);
          FD_TILE(it, 2);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = h ? r_hi : r_lo;
            if (r < B) {
#pragma unroll
              for (int nt = 0; nt < kNt; ++nt) {
                const int c = nt * 8 + 2 * tig;
                const float2 xv = pair_f32(xs + r * Px + c);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (v0 + c + e < V) {
                    const float xe = e ? xv.y : xv.x;
                    const float n = (acc[nt][2 * h + e] - mu[nt][e]) * istd[nt][e];
                    const float p = expf(fminf(n - sm_r[q][h], 0.f)) * isl_r[q][h];
                    if (ok_r[q][h]) loss_r[q][h] += xe * __logf(p + floor_);
                    rd_r[q][h] += xe * __fdividef(p, p + floor_);
                  }
                }
              }
            }
          }
        }
      }
      FD_TILE(it, 3);
      __syncthreads();  // the stage is free for the load of tile + S
      FD_TILE(it, 4);
    }
    FD_BLOCK(2);
#pragma unroll
    for (int q = 0; q < kMt; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lv = loss_r[q][h], rv = rd_r[q][h];
        lv += __shfl_xor_sync(kFullMask, lv, 1);
        rv += __shfl_xor_sync(kFullMask, rv, 1);
        lv += __shfl_xor_sync(kFullMask, lv, 2);
        rv += __shfl_xor_sync(kFullMask, rv, 2);
        const int r = (warp + q * kTcWarps) * 16 + grp + 8 * h;
        if (tig == 0 && r < B) {
          loss_part[(size_t)blockIdx.x * B + r] = -lv;
          rd_part[(size_t)blockIdx.x * B + r] = rv;
        }
      }
    }
    FD_BLOCK(3);
  }
}

// ---------------------------------------------------------------------------
// K3: backward — g_beta for the block's columns, g_theta partials.
// ---------------------------------------------------------------------------

// K3's shared memory at tile width vt and storage bf, as offsets in floats:
// theta [B, Pth] (Pth = Kp + 4, 4 mod 8, so theta's A fragments load
// without conflicts), the g_theta accumulator [B, Kp], two ring stages of
// x [B, Px] and beta [Kp, Pb] (rows K..Kp-1 stay zero), stored, and the
// tile's mean and var [2, vt]; gn and then gz, float32 [B, Px]: over the
// stage's x for FP32 storage, in a tile of their own for bf16 (a float32 row
// written over bf16 rows would overwrite rows that other warps have not yet
// read); five row vectors (m, 1/s, rd, g, mask); two [kTcWarps, vt] column
// reductions, the two BN column sums and the count. Rows past B are never
// stored: fragments read them as 0. The bf16 layout is never the larger:
// its x stages and gz tile take the FP32 x stages' bytes, its beta stages
// half the FP32 ones'.
struct GradsLayout {
  int Kp, Pth, Pg;
  size_t th, gth, x, x_stage, b, b_stage, gz, mv, rows, cols, floats;
};

__host__ __device__ inline GradsLayout grads_layout(int vt, int B, int K, bool bf) {
  GradsLayout L;
  L.Kp = round_up(K, 8);
  L.Pth = L.Kp + 4;
  L.Pg = L.Kp;
  L.th = 0;
  L.gth = L.th + up4((size_t)B * L.Pth);
  L.x = L.gth + up4((size_t)B * L.Pg);
  L.x_stage = stored_floats((size_t)B * tile_px(vt), bf);
  L.b = L.x + kStages * L.x_stage;
  L.b_stage = (size_t)L.Kp * tile_pb(vt, bf) / (bf ? 2 : 1);  // Kp % 8 == 0: 16-byte rows
  L.gz = L.b + kStages * L.b_stage;
  L.mv = L.gz + (bf ? up4((size_t)B * tile_px(vt)) : 0);
  L.rows = L.mv + 4 * (size_t)vt;
  L.cols = L.rows + up4(5 * (size_t)B);
  L.floats = L.cols + (size_t)(2 * kTcWarps + 2) * vt + 4;
  return L;
}

template <typename TS, int VT, bool kVec16>
__global__ void __launch_bounds__(kTcThreads, 1)
grads_kernel(const float* __restrict__ theta, const TS* __restrict__ beta,
             const TS* __restrict__ x, const float* __restrict__ mean,
             const float* __restrict__ var, const float* __restrict__ m,
             const float* __restrict__ s, const float* __restrict__ rd,
             const float* __restrict__ g, const float* __restrict__ mask,
             float* __restrict__ gth_part, float* __restrict__ g_beta, int B, int K, int V,
             int ld, int training, float eps, float floor_, int tiles_per_block) {
  using T = Tile<TS, VT>;
  constexpr int kNt = VT / 8;  // 8-column mma tiles per tile
  // Pitches of the stored x and beta tiles, in stored elements; gn and gz
  // take x's pitch in floats.
  constexpr int Px = T::kPx, Pb = T::kPb;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  float* const sm = reinterpret_cast<float*>(tc_smem);
  const GradsLayout L = grads_layout(VT, B, K, T::kBf16);
  const int Kp = L.Kp, Pth = L.Pth, Pg = L.Pg;
  float* th_s = sm + L.th;
  float* gth_s = sm + L.gth;
  float* x_ring = sm + L.x;  // kStages stages of L.x_stage floats, stored as TS
  float* b_ring = sm + L.b;  // and of L.b_stage
  float* gz_tile = sm + L.gz;  // bf16 storage only
  float* mv_ring = sm + L.mv;  // [stage][mean, var][VT]
  float* sm_s = sm + L.rows;
  float* isl_s = sm_s + B;  // 1 / s
  float* rd_s = isl_s + B;
  float* g_s = rd_s + B;
  float* mk_s = g_s + B;
  float* red_s = sm + L.cols;               // [2][kTcWarps][VT]
  float* ab_s = red_s + 2 * kTcWarps * VT;  // [2][VT]: sum(gn*mk)/cnt, sum(gn*n*mk)/cnt
  float* cnt_s = ab_s + 2 * VT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  const int n_tiles = (V + VT - 1) / VT;
  const int mt_count = (B + 15) / 16;

  for (int i = tid; i < B * Kp; i += kTcThreads) {
    const int r = i / Kp, k = i - r * Kp;
    th_s[r * Pth + k] = k < K ? theta[(size_t)r * K + k] : 0.f;
    gth_s[r * Pg + k] = 0.f;
  }
  for (size_t i = tid; i < 2 * L.x_stage; i += kTcThreads) x_ring[i] = 0.f;
  for (size_t i = tid; i < 2 * L.b_stage; i += kTcThreads) b_ring[i] = 0.f;
  for (int i = tid; i < 4 * VT; i += kTcThreads) mv_ring[i] = 0.f;
  for (int r = tid; r < B; r += kTcThreads) {
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
  }
  __syncthreads();
  const float cnt = cnt_s[0];

  const int first = blockIdx.x * tiles_per_block;
  const int last = min(first + tiles_per_block, n_tiles);
  auto load = [&](int st, int v0) {
    load_tile<TS, VT, kVec16>(reinterpret_cast<TS*>(b_ring + st * L.b_stage),
                              reinterpret_cast<TS*>(x_ring + st * L.x_stage),
                              mv_ring + st * 2 * VT, beta, x, mean, var, B, K, V, ld, v0, 2);
  };
  if (first < last) {
    load(0, first * VT);
    cp_async_commit();
  }
  for (int tile = first, it = 0; tile < last; ++tile, ++it) {
    const int st = it & 1;
    const int v0 = tile * VT;
    if (tile + 1 < last) load(st ^ 1, v0 + VT);
    wait_tile();
    __syncthreads();
    float* const x_stage = x_ring + st * L.x_stage;
    const TS* xs = reinterpret_cast<const TS*>(x_stage);
    const TS* bs = reinterpret_cast<const TS*>(b_ring + st * L.b_stage);
    // gn, then gz, in float32: over this stage's x (FP32 storage: each lane
    // reads its x pair before it writes gn there) or in their own tile (bf16).
    float* const gs = T::kBf16 ? gz_tile : x_stage;
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

    // Pass 1: z from the tile product; n and gn on the accumulator
    // fragments; gn goes to shared memory, n stays here.
    float nv[T::kMaxMt][kNt][4];
    float s1[kNt][2], s2[kNt][2];
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;
#pragma unroll
    for (int q = 0; q < T::kMaxMt; ++q) {
      const int mt = warp + q * kTcWarps;
      if (mt < mt_count) {
        const int r_lo = mt * 16 + grp, r_hi = r_lo + 8;
        const bool ok_lo = r_lo < B, ok_hi = r_hi < B;
        float acc[kNt][4];
        // Each storage spelled out: the FP32 branch as the FP32 kernel had it,
        // which ptxas compiles to fewer registers than the same operations
        // written once for both (122 for grads_kernel<32, 4B>, not 123).
        if constexpr (T::kBf16) {
          tile_product<kNt, true>(acc, Kp, ThetaFrag{th_s, Pth, r_lo, r_hi, tig, ok_lo, ok_hi},
                                  beta_frag(bs, Pb, grp, tig));
        } else {
          tile_product(acc, Kp, ThetaFrag{th_s, Pth, r_lo, r_hi, tig, ok_lo, ok_hi},
                       BetaFrag{bs, Pb, grp, tig});
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
            const float2 xv = rok ? pair_f32(xs + r * Px + c) : make_float2(0.f, 0.f);
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
            if (rok) *reinterpret_cast<float2*>(gs + r * Px + c) = make_float2(gn2[0], gn2[1]);
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
            red_s[(kTcWarps + warp) * VT + nt * 8 + 2 * tig + e] = v2;
          }
        }
      }
      __syncthreads();
      if (tid < VT) {
        float t1 = 0.f, t2 = 0.f;
        for (int w = 0; w < kTcWarps; ++w) {
          t1 += red_s[w * VT + tid];
          t2 += red_s[(kTcWarps + w) * VT + tid];
        }
        ab_s[tid] = t1 / cnt;
        ab_s[VT + tid] = t2 / cnt;
      }
      __syncthreads();
    }

    // Pass 2: gz = inv_std * (gn - mk*a - n*mk*b), 0 past V; gz replaces gn.
#pragma unroll
    for (int q = 0; q < T::kMaxMt; ++q) {
      const int mt = warp + q * kTcWarps;
      if (mt < mt_count) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + grp + 8 * h;
          if (r < B) {
            const float mkv = mk_s[r];
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
              const int c = nt * 8 + 2 * tig;
              const float2 v = *reinterpret_cast<const float2*>(gs + r * Px + c);
              float gz[2] = {v.x, v.y};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float a = training ? ab_s[c + e] : 0.f;
                const float b = training ? ab_s[VT + c + e] : 0.f;
                gz[e] = v0 + c + e < V
                            ? istd[nt][e] * (gz[e] - mkv * a - nv[q][nt][2 * h + e] * mkv * b)
                            : 0.f;
              }
              *reinterpret_cast<float2*>(gs + r * Px + c) = make_float2(gz[0], gz[1]);
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
          split_tf32(ok_lo ? gs[r_lo * Px + c] : 0.f, gh[ks][0], gl[ks][0]);
          split_tf32(ok_hi ? gs[r_hi * Px + c] : 0.f, gh[ks][1], gl[ks][1]);
          split_tf32(ok_lo ? gs[r_lo * Px + c + 4] : 0.f, gh[ks][2], gl[ks][2]);
          split_tf32(ok_hi ? gs[r_hi * Px + c + 4] : 0.f, gh[ks][3], gl[ks][3]);
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
                if constexpr (T::kBf16) {  // as in pass 1
                  beta_t_frag(bs + kk * Pb + ks * 8 + tig, bh, bl);
                  mma_ab<T::kBf16>(acc[j], gh[ks], gl[ks], bh, bl);
                } else {
                  split_tf32(bs[kk * Pb + ks * 8 + tig], bh[0], bl[0]);
                  split_tf32(bs[kk * Pb + ks * 8 + tig + 4], bh[1], bl[1]);
                  mma_3xtf32(acc[j], gh[ks], gl[ks], bh, bl);
                }
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
              split_tf32(oa ? gs[ra * Px + n0 + j * 8 + grp] : 0.f, bh[0], bl[0]);
              split_tf32(ob ? gs[rb * Px + n0 + j * 8 + grp] : 0.f, bh[1], bl[1]);
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
  for (int i = tid; i < B * K; i += kTcThreads) {
    const int r = i / K, k = i - r * K;
    gth_part[(size_t)blockIdx.x * B * K + i] = gth_s[r * Pg + k];
  }
}

// ---------------------------------------------------------------------------
// Host side: layouts, grids, launches.
// ---------------------------------------------------------------------------

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

cudaError_t smem_limit(size_t* limit) {
  int dev = 0, value = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *limit = (size_t)value;
  return err;
}

// The tensor-core tile width of a kernel at (B, K) and storage bf under a
// per-block shared-memory limit: for bf16 K1 and K2, 64 (the wide tiles)
// when that layout fits and B <= 256; then 32 when that layout fits and B
// fits the warps' registers, else 16; 0 when none fits. *smem is the chosen
// layout's bytes (the 16-wide one's when none fits).
int tc_vt(int kind, bool bf, int B, int K, size_t limit, size_t* smem) {
  const int widths[3] = {kWideVt, 32, 16};
  for (int vt : widths) {
    if (vt == kWideVt && (!bf || kind == kGrads)) continue;
    *smem = (kind == kGrads ? grads_layout(vt, B, K, bf).floats
                            : fwd_layout(kind, vt, B, K, bf).floats) *
            sizeof(float);
    if (*smem <= limit && B <= tile_rows(vt)) return vt;
  }
  return 0;
}

// A kernel's route at (B, K) and storage bf: the tensor-core tile width (64,
// 32 or 16), 0 for the CUDA-core K1/K2, -1 when nothing fits; with its shared
// memory. The CUDA-core kernels upcast their strip into FP32 shared memory,
// so their footprint does not depend on the storage.
int route_of(int kind, bool bf, int B, int K, size_t limit, size_t* smem) {
  const int vt = tc_vt(kind, bf, B, K, limit, smem);
  if (vt || kind == kGrads) return vt ? vt : -1;
  *smem = simt_smem_floats(kind, B, K) * sizeof(float);
  return *smem <= limit ? 0 : -1;
}

// Grid of the route's kernel for storage TS (the 16-byte-aligned variant's
// occupancy stands for both FP32 ring variants); *grid is 0 when nothing
// fits.
template <typename TS>
cudaError_t plan_route(int kind, int B, int K, int V, int* grid, int* tpb, size_t* smem,
                       int* route) {
  size_t limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  *route = route_of(kind, kIsBf16<TS>, B, K, limit, smem);
  *grid = 0;
  switch (*route) {
    case kWideVt:
      if constexpr (kIsBf16<TS>) {
        if (kind == kStats) {
          return plan(stats_kernel<TS, kWideVt, true>, kTcThreads, *smem, V, kWideVt, grid, tpb);
        }
        return plan(loss_kernel<TS, kWideVt, true>, kTcThreads, *smem, V, kWideVt, grid, tpb);
      }
      return cudaErrorInvalidValue;
    case 32:
      if (kind == kStats) return plan(stats_kernel<TS, 32, true>, kTcThreads, *smem, V, 32, grid, tpb);
      if (kind == kLoss) return plan(loss_kernel<TS, 32, true>, kTcThreads, *smem, V, 32, grid, tpb);
      return plan(grads_kernel<TS, 32, true>, kTcThreads, *smem, V, 32, grid, tpb);
    case 16:
      if (kind == kStats) return plan(stats_kernel<TS, 16, true>, kTcThreads, *smem, V, 16, grid, tpb);
      if (kind == kLoss) return plan(loss_kernel<TS, 16, true>, kTcThreads, *smem, V, 16, grid, tpb);
      return plan(grads_kernel<TS, 16, true>, kTcThreads, *smem, V, 16, grid, tpb);
    case 0:
      if (kind == kStats) return plan(simt_stats_kernel<TS>, kThreads, *smem, V, kStrip, grid, tpb);
      return plan(simt_loss_kernel<TS>, kThreads, *smem, V, kStrip, grid, tpb);
  }
  return cudaSuccess;
}

cudaError_t plan_kind(int kind, int B, int K, int V, int* grid, int* tpb, size_t* smem,
                      int* route) {
  return kind & kBf16Kind
             ? plan_route<bf16>(kind & ~kBf16Kind, B, K, V, grid, tpb, smem, route)
             : plan_route<float>(kind, B, K, V, grid, tpb, smem, route);
}

template <typename KernelT, typename... Args>
cudaError_t launch(KernelT kernel, int grid, int threads, size_t smem, cudaStream_t st,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// The 16-byte-copy ring variant when every row the ring loads starts on 16
// bytes (V % 4 == 0 and aligned base pointers), else the 4-byte cp.async one.
bool vec16_ok(int V, const void* a, const void* b, const void* c, const void* d) {
  return V % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
         (uintptr_t)c % 16 == 0 && (uintptr_t)d % 16 == 0;
}

// bf16 beta and x take the 16-byte ring only: ld a multiple of 8 values (16
// bytes), at least V, and 16-byte aligned rows.
bool bf16_rows_ok(int V, int ld, const void* beta, const void* x) {
  return ld >= V && ld % 8 == 0 && (uintptr_t)beta % 16 == 0 && (uintptr_t)x % 16 == 0;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// K1 + the merge of its softmax partials, beta stored as TS at pitch ld.
template <typename TS>
cudaError_t run_stats(const float* th, const TS* be, const float* mk, const float* rm,
                      const float* rv, float* mo, float* vo, float* mp, float* sp, float* m,
                      float* s, int B, int K, int V, int ld, int training, float eps, int grid,
                      cudaStream_t st) {
  int g = 0, tpb = 0, route = 0;
  size_t smem = 0;
  cudaError_t err = plan_route<TS>(kStats, B, K, V, &g, &tpb, &smem, &route);
  if (err != cudaSuccess) return err;
  if (route < 0 || g != grid) return cudaErrorInvalidValue;
  auto go = [&](auto kernel, int threads) {
    return launch(kernel, grid, threads, smem, st, th, be, mk, rm, rv, mo, vo, mp, sp, B, K, V,
                  ld, training, eps, tpb);
  };
  if (route == 0) {
    err = go(simt_stats_kernel<TS>, kThreads);
  } else if constexpr (kIsBf16<TS>) {
    err = route == kWideVt ? go(stats_kernel<TS, kWideVt, true>, kTcThreads)
          : route == 32    ? go(stats_kernel<TS, 32, true>, kTcThreads)
                           : go(stats_kernel<TS, 16, true>, kTcThreads);
  } else if (vec16_ok(V, be, rm, rv, be)) {
    err = route == 32 ? go(stats_kernel<TS, 32, true>, kTcThreads)
                      : go(stats_kernel<TS, 16, true>, kTcThreads);
  } else {
    err = route == 32 ? go(stats_kernel<TS, 32, false>, kTcThreads)
                      : go(stats_kernel<TS, 16, false>, kTcThreads);
  }
  if (err != cudaSuccess) return err;
  merge_softmax_kernel<<<blocks_for(32 * B), kThreads, 0, st>>>(mp, sp, grid, B, m, s);
  return cudaGetLastError();
}

// K2 + the ordered sum of its partials, beta and x stored as TS at pitch ld.
template <typename TS>
cudaError_t run_loss(const float* th, const TS* be, const TS* xx, const float* mu,
                     const float* va, const float* mm, const float* ss, float* lp, float* rp,
                     float* loss, float* rd, int B, int K, int V, int ld, float eps,
                     float floor_, int grid, cudaStream_t st) {
  int g = 0, tpb = 0, route = 0;
  size_t smem = 0;
  cudaError_t err = plan_route<TS>(kLoss, B, K, V, &g, &tpb, &smem, &route);
  if (err != cudaSuccess) return err;
  if (route < 0 || g != grid) return cudaErrorInvalidValue;
  auto go = [&](auto kernel, int threads) {
    return launch(kernel, grid, threads, smem, st, th, be, xx, mu, va, mm, ss, lp, rp, B, K, V,
                  ld, eps, floor_, tpb);
  };
  if (route == 0) {
    err = go(simt_loss_kernel<TS>, kThreads);
  } else if constexpr (kIsBf16<TS>) {
    err = route == kWideVt ? go(loss_kernel<TS, kWideVt, true>, kTcThreads)
          : route == 32    ? go(loss_kernel<TS, 32, true>, kTcThreads)
                           : go(loss_kernel<TS, 16, true>, kTcThreads);
  } else if (vec16_ok(V, be, xx, mu, va)) {
    err = route == 32 ? go(loss_kernel<TS, 32, true>, kTcThreads)
                      : go(loss_kernel<TS, 16, true>, kTcThreads);
  } else {
    err = route == 32 ? go(loss_kernel<TS, 32, false>, kTcThreads)
                      : go(loss_kernel<TS, 16, false>, kTcThreads);
  }
  if (err != cudaSuccess) return err;
  fold_rows_kernel<<<blocks_for(64 * B), kThreads, 0, st>>>(lp, rp, grid, B, loss, rd);
  return cudaGetLastError();
}

// K3 + the ordered sum of its g_theta partials, beta and x stored as TS at
// pitch ld.
template <typename TS>
cudaError_t run_grads(const float* th, const TS* be, const TS* xx, const float* mu,
                      const float* va, const float* mm, const float* ss, const float* rr,
                      const float* gg, const float* mk, float* gp, float* g_theta, float* gb,
                      int B, int K, int V, int ld, int training, float eps, float floor_,
                      int grid, cudaStream_t st) {
  int gr = 0, tpb = 0, route = 0;
  size_t smem = 0;
  cudaError_t err = plan_route<TS>(kGrads, B, K, V, &gr, &tpb, &smem, &route);
  if (err != cudaSuccess) return err;
  if (route < 0 || gr != grid) return cudaErrorInvalidValue;
  auto go = [&](auto kernel) {
    return launch(kernel, grid, kTcThreads, smem, st, th, be, xx, mu, va, mm, ss, rr, gg, mk,
                  gp, gb, B, K, V, ld, training, eps, floor_, tpb);
  };
  if constexpr (kIsBf16<TS>) {
    err = route == 32 ? go(grads_kernel<TS, 32, true>) : go(grads_kernel<TS, 16, true>);
  } else if (vec16_ok(V, be, xx, mu, va)) {
    err = route == 32 ? go(grads_kernel<TS, 32, true>) : go(grads_kernel<TS, 16, true>);
  } else {
    err = route == 32 ? go(grads_kernel<TS, 32, false>) : go(grads_kernel<TS, 16, false>);
  }
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<blocks_for(B * K), kThreads, 0, st>>>(gp, grid, B * K, g_theta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory each kernel needs at (B, K), the card's per-block limit and
// the grid a launch will use. kind: 0 stats, 1 loss, 2 grads, plus 4 for
// bf16 storage. Returns a cudaError_t; *grid is 0 when the kernel does not
// fit.
int fd_plan(int kind, int B, int K, int V, int* grid, long long* smem_bytes,
            long long* smem_limit_out) {
  size_t limit = 0, smem = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  *smem_limit_out = (long long)limit;
  int tpb = 0, route = 0;
  err = plan_kind(kind, B, K, V, grid, &tpb, &smem, &route);
  *smem_bytes = (long long)smem;
  return (int)err;
}

// A kernel's route at (B, K), by shape alone (kind as in fd_plan): 64, 32
// or 16 for the tensor-core tile width (64: bf16 K1 and K2 alone), 0 for the
// CUDA-core K1 or K2, -1 when nothing fits.
int fd_route(int kind, int B, int K, int* route) {
  size_t limit = 0, smem = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  *route = route_of(kind & ~kBf16Kind, (kind & kBf16Kind) != 0, B, K, limit, &smem);
  return (int)cudaSuccess;
}

int fd_stats(const void* theta, const void* beta, const void* mask, const void* run_mean,
             const void* run_var, void* mean, void* var, void* m_part, void* s_part, void* m,
             void* s, int B, int K, int V, int training, float eps, int grid, void* stream) {
  return (int)run_stats<float>(
      (const float*)theta, (const float*)beta, (const float*)mask, (const float*)run_mean,
      (const float*)run_var, (float*)mean, (float*)var, (float*)m_part, (float*)s_part,
      (float*)m, (float*)s, B, K, V, V, training, eps, grid, (cudaStream_t)stream);
}

int fd_loss(const void* theta, const void* beta, const void* x, const void* mean,
            const void* var, const void* m, const void* s, void* loss_part, void* rd_part,
            void* loss, void* rd, int B, int K, int V, float eps, float floor_, int grid,
            void* stream) {
  return (int)run_loss<float>(
      (const float*)theta, (const float*)beta, (const float*)x, (const float*)mean,
      (const float*)var, (const float*)m, (const float*)s, (float*)loss_part, (float*)rd_part,
      (float*)loss, (float*)rd, B, K, V, V, eps, floor_, grid, (cudaStream_t)stream);
}

int fd_grads(const void* theta, const void* beta, const void* x, const void* mean,
             const void* var, const void* m, const void* s, const void* rd, const void* g,
             const void* mask, void* gth_part, void* g_theta, void* g_beta, int B, int K,
             int V, int training, float eps, float floor_, int grid, void* stream) {
  return (int)run_grads<float>(
      (const float*)theta, (const float*)beta, (const float*)x, (const float*)mean,
      (const float*)var, (const float*)m, (const float*)s, (const float*)rd, (const float*)g,
      (const float*)mask, (float*)gth_part, (float*)g_theta, (float*)g_beta, B, K, V, V,
      training, eps, floor_, grid, (cudaStream_t)stream);
}

// The bf16-storage launches: beta (and x) bf16 at row pitch ld (a multiple of
// 8, 16-byte aligned rows), everything else as in the FP32 entries.
int fd_stats_bf16(const void* theta, const void* beta, const void* mask, const void* run_mean,
                  const void* run_var, void* mean, void* var, void* m_part, void* s_part,
                  void* m, void* s, int B, int K, int V, int ld, int training, float eps,
                  int grid, void* stream) {
  if (!bf16_rows_ok(V, ld, beta, beta)) return (int)cudaErrorInvalidValue;
  return (int)run_stats<bf16>(
      (const float*)theta, (const bf16*)beta, (const float*)mask, (const float*)run_mean,
      (const float*)run_var, (float*)mean, (float*)var, (float*)m_part, (float*)s_part,
      (float*)m, (float*)s, B, K, V, ld, training, eps, grid, (cudaStream_t)stream);
}

int fd_loss_bf16(const void* theta, const void* beta, const void* x, const void* mean,
                 const void* var, const void* m, const void* s, void* loss_part, void* rd_part,
                 void* loss, void* rd, int B, int K, int V, int ld, float eps, float floor_,
                 int grid, void* stream) {
  if (!bf16_rows_ok(V, ld, beta, x)) return (int)cudaErrorInvalidValue;
  return (int)run_loss<bf16>(
      (const float*)theta, (const bf16*)beta, (const bf16*)x, (const float*)mean,
      (const float*)var, (const float*)m, (const float*)s, (float*)loss_part, (float*)rd_part,
      (float*)loss, (float*)rd, B, K, V, ld, eps, floor_, grid, (cudaStream_t)stream);
}

int fd_grads_bf16(const void* theta, const void* beta, const void* x, const void* mean,
                  const void* var, const void* m, const void* s, const void* rd, const void* g,
                  const void* mask, void* gth_part, void* g_theta, void* g_beta, int B, int K,
                  int V, int ld, int training, float eps, float floor_, int grid,
                  void* stream) {
  if (!bf16_rows_ok(V, ld, beta, x)) return (int)cudaErrorInvalidValue;
  return (int)run_grads<bf16>(
      (const float*)theta, (const bf16*)beta, (const bf16*)x, (const float*)mean,
      (const float*)var, (const float*)m, (const float*)s, (const float*)rd, (const float*)g,
      (const float*)mask, (float*)gth_part, (float*)g_theta, (float*)g_beta, B, K, V, ld,
      training, eps, floor_, grid, (cudaStream_t)stream);
}

#ifdef FD_TIMELINE
// The timeline build's buffer: its shape [blocks, tiles + 1, warps, stamps],
// cleared on a stream, and copied to the host (after a synchronize).
int fd_timeline_shape(int* shape) {
  shape[0] = kTlBlocks;
  shape[1] = kTlTiles + 1;
  shape[2] = kTcWarps;
  shape[3] = kTlStamps;
  return (int)cudaSuccess;
}

int fd_timeline_clear(void* stream) {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, fd_tl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemsetAsync(p, 0, sizeof(fd_tl), (cudaStream_t)stream);
}

int fd_timeline_read(void* host) { return (int)cudaMemcpyFromSymbol(host, fd_tl, sizeof(fd_tl)); }
#endif

}  // extern "C"
