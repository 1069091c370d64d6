// Masked multi-head self-attention, forward and backward, for Hopper (sm_90a).
//
// The forward replaces the TPU kernel
// speakingstyle_tpu/ops/pallas_attention.py::_fwd_kernel (launched by
// _pallas_fwd, reached through fused_mha). It computes the same function:
// out = softmax(q k^T * sm_scale + bias) v per (batch, head), with the
// key-padding bias finfo(f32).min / 2, scores and softmax in f32, the
// probabilities rounded to v's dtype before the PV product, and f32
// accumulation. For the backward it can also write each row's log-sum-exp
// lse = m + log(l) (f32, [B, H, L]).
//
// The backward replaces _bwd_kernel (launched by _pallas_bwd, reached
// through the custom_vjp _fused_bwd). From q, k, v, the bias and lse it
// recomputes P in f32, then dV = dO^T P (P rounded to v's dtype),
// dP = dO V^T, dS = P (dP - delta) sm_scale (rounded to q's dtype),
// dQ = dS K, dK = dS^T Q, every product accumulated in f32. The TPU kernel
// takes delta = rowsum(dP o P); here delta_i = rowsum(dO_i o O_i), with O
// the forward's output, which is the same sum reordered (sum_j P_ij dO_i.V_j
// = dO_i . sum_j P_ij V_j) up to the rounding of O: exact in float32 but for
// the order of the sums, one rounding of O in bfloat16. It costs D
// multiply-adds a row instead of a pass over all keys.
//
// Backward design: the TPU kernel holds a whole T x T score tile per
// (b, h); here two passes, no atomics, so the result is deterministic. The
// dK/dV pass has one block per (b, h, 64-key tile) and loops over every
// 64-query tile (query rows cannot be skipped: the cotangent at a padded
// query need not be zero); a key tile wholly past the row's last valid key
// has P = 0 for every query and writes zeros. The dQ pass has one block per
// (b, h, 64-query tile) and loops over the key tiles up to the last valid
// key, as the forward does. A batch row whose keys are all padded has every
// score equal to the bias in f32, so its P is uniform, 1/L, in the forward
// and in both passes (lse cannot carry that: neg + log L rounds to neg).
//
// Forward design. The TPU kernel keeps a whole f32 T x T score tile in VMEM; at
// T = 1024 that is 4 MB, far past an SM's 227 KB of shared memory. Here one
// block owns (b, h, 64 query rows) and streams 64-key tiles of K and V
// through shared memory with an online softmax (running max, running sum,
// rescaled accumulator), so no score ever reaches device memory and shared
// memory use is independent of T. Key tiles past the row's last unpadded
// key are skipped: padding sits at the end, a row with any valid key has
// one in its first tile, and exp(min/2 - m) is exactly 0 in f32, so the
// skip changes no bit of the result.
//
// Bound on the H100: at the model's shapes (T <= 1000, D in {32, 128}) the
// work is ~4 T^2 D flops per (b, h) forward and ~14 T^2 D backward, against
// ~4 T D (forward) and ~9 T D (backward) elements of traffic, so the kernels
// are bound by arithmetic. This first version does the products with FMA on
// the CUDA cores (4 x 4 register tiles fed from padded, transposed
// shared-memory tiles, conflict-free); moving them to mma.sync / wgmma is
// the next step for speed.
//
// C interface (loaded with ctypes): every entry point returns the
// cudaError_t of its launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads per block: 16 x 16
constexpr int TS = BQ + 1;   // padded row stride of the transposed Q / K tiles
constexpr int PS = BK + 1;   // padded row stride of the score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The valid key length of a batch row: one past its last unpadded key (0:
// every key padded). Padding sits at the end of a row. Block-wide; every
// thread gets the value.
__device__ __forceinline__ int block_kv_len(const uint8_t* mb, int L, int* slot) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  int last = 0;
  for (int j = threadIdx.x; j < L; j += NT)
    if (!mb[j]) last = j + 1;
  for (int o = 16; o; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if ((threadIdx.x & 31) == 0) atomicMax(slot, last);
  __syncthreads();
  return *slot;
}

// q, k, v, out: [B, L, H, D] contiguous; mask: [B, L] bytes, nonzero at padding.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse, int L,
    int H, int D, float sm_scale) {
  constexpr int DC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;              // [D][TS], Q transposed
  float* Kt = Qt + D * TS;       // [D][TS], K transposed
  float* Vs = Kt + D * TS;       // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][PS], scores then probabilities
  float* row_m = Ps + BQ * PS;   // [BQ] running max
  float* row_l = row_m + BQ;     // [BQ] running sum
  float* row_a = row_l + BQ;     // [BQ] this tile's rescale factor
  __shared__ int kv_len_s;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;  // stride between sequence positions
  const size_t base = (size_t)b * L * rs + (size_t)h * D;
  const uint8_t* mb = mask + (size_t)b * L;
  const float neg = -1.70141173319264429e+38f;  // finfo(float32).min / 2

  const int kv_len = block_kv_len(mb, L, &kv_len_s);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    Qt[d * TS + r] = qi < L ? to_f(q[base + (size_t)qi * rs + d]) : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  __syncthreads();
  // a fully padded row attends uniformly over all L keys, as the plain
  // version's softmax does; otherwise stop after the last valid key's tile
  const int k_end = kv_len > 0 ? kv_len : L;

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i - c * D;
      const int kj = k0 + c;
      const bool ok = kj < L;
      Kt[d * TS + c] = ok ? to_f(k[base + (size_t)kj * rs + d]) : 0.f;
      Vs[c * D + d] = ok ? to_f(v[base + (size_t)kj * rs + d]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qt[d * TS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * TS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      const bool ok = kj < L;  // keys past L do not exist: -inf, weight 0
      const float bias = ok && mb[kj] ? neg : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = ok ? s[i][j] * sm_scale + bias : -INFINITY;
    }
    __syncthreads();

    // online softmax: four neighbouring threads share a row, 16 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      float* pr = Ps + r * PS + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);  // finite: key k0 is < L
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = to_f(from_f<T>(p));  // P in v's dtype for the PV product
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float a = expf(m_old - m_new);
        row_a[r] = a;
        row_l[r] = row_l[r] * a + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= a;
    }
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < D ? Vs[j * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncthreads();  // the next tile overwrites Kt, Vs and Ps
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= L) continue;
    const float inv = 1.f / row_l[r];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) out[base + (size_t)qi * rs + d] = from_f<T>(acc[i][c] * inv);
    }
  }
  if (lse != nullptr && tid < BQ && q0 + tid < L)
    lse[((size_t)b * H + h) * L + q0 + tid] = row_m[tid] + logf(row_l[tid]);
}

// ---------------------------------------------------------------- backward

// Shared by both backward passes: a 64 x D tile of rows [r0, r0 + 64) of one
// (b, h) slice of x, transposed into dst[D][TS] as f32, zeros past L.
template <typename T>
__device__ __forceinline__ void load_tile_t(float* dst, const T* __restrict__ x, size_t base,
                                            size_t rs, int r0, int L, int D) {
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    dst[d * TS + r] = r0 + r < L ? to_f(x[base + (size_t)(r0 + r) * rs + d]) : 0.f;
  }
}

// The 4 x 4 products a thread owns of A B^T, A and B given transposed
// ([D][TS]): rows ty + 16 i of A, rows tx + 16 j of B. The loop is the
// forward's, so the backward recomputes the forward's scores bit for bit.
__device__ __forceinline__ void tile_products(float (&s)[4][4], const float* At,
                                              const float* Bt, int D, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = At[d * TS + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Bt[d * TS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// Per query row of the tile [q0, q0 + 64): its lse, and delta = dO . O in
// f32 (four neighbouring threads a row); zeros past L.
template <typename T>
__device__ __forceinline__ void row_stats(float* row_lse, float* row_dl, const T* __restrict__ out,
                                          const T* __restrict__ dout, const float* __restrict__ lse,
                                          size_t base, size_t rs, size_t lse_base, int q0, int L,
                                          int D) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qi = q0 + r;
  float dl = 0.f;
  if (qi < L)
    for (int d = part; d < D; d += 4) {
      const size_t o = base + (size_t)qi * rs + d;
      dl = fmaf(to_f(dout[o]), to_f(out[o]), dl);
    }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  if (part == 0) {
    row_dl[r] = dl;
    row_lse[r] = qi < L ? lse[lse_base + qi] : 0.f;
  }
}

// P of the thread's 4 x 4 (query ty + 16 i, key tx + 16 j) entries of the
// tile at (q0, k0), recomputed in f32 from the scores s and the row lse.
__device__ __forceinline__ void tile_probs(float (&p)[4][4], const float (&s)[4][4],
                                           const float* row_lse, const uint8_t* mb, int q0,
                                           int k0, int L, int kv_len, float sm_scale, int tx,
                                           int ty) {
  const float neg = -1.70141173319264429e+38f;  // finfo(float32).min / 2
  const float unif = 1.f / (float)L;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k0 + tx + 16 * j;
    const float bias = kj < L && mb[kj] ? neg : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      if (qi >= L || kj >= L)
        p[i][j] = 0.f;
      else if (kv_len == 0)
        p[i][j] = unif;  // every key padded: uniform, as in the forward
      else
        p[i][j] = expf(s[i][j] * sm_scale + bias - row_lse[ty + 16 * i]);
    }
  }
}

// dK and dV of one (b, h, 64-key tile), looping over every query tile.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) attn_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout, const uint8_t* __restrict__ mask,
    const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv, int L, int H, int D,
    float sm_scale) {
  constexpr int DC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Kt = smem;                // [D][TS]: this block's keys, transposed
  float* Vt = Kt + D * TS;         // [D][TS]
  float* Qt = Vt + D * TS;         // [D][TS]: the current query tile
  float* Gt = Qt + D * TS;         // [D][TS]: dO of the current query tile
  float* Ps = Gt + D * TS;         // [BQ][PS]: P (in v's dtype), then dS
  float* row_lse = Ps + BQ * PS;   // [BQ]
  float* row_dl = row_lse + BQ;    // [BQ]
  __shared__ int kv_len_s;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * L * rs + (size_t)h * D;
  const size_t lse_base = ((size_t)b * H + h) * L;
  const uint8_t* mb = mask + (size_t)b * L;
  const int kv_len = block_kv_len(mb, L, &kv_len_s);

  // rows ty + 16 i of the tile are keys, columns tx + 16 c head dims
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // a tile wholly past the last valid key has P = 0 for every query
  // (exp(min/2 - lse) is 0 in f32), so its dK and dV are zero
  if (kv_len == 0 || k0 < kv_len) {
    load_tile_t(Kt, k, base, rs, k0, L, D);
    load_tile_t(Vt, v, base, rs, k0, L, D);
    for (int q0 = 0; q0 < L; q0 += BQ) {
      __syncthreads();  // the previous tile's readers of Qt, Gt, Ps, row_* are done
      load_tile_t(Qt, q, base, rs, q0, L, D);
      load_tile_t(Gt, dout, base, rs, q0, L, D);
      row_stats(row_lse, row_dl, out, dout, lse, base, rs, lse_base, q0, L, D);
      __syncthreads();

      // P and dP at (query ty + 16 i, key tx + 16 j)
      float s[4][4], p[4][4], dp[4][4];
      tile_products(s, Qt, Kt, D, tx, ty);
      tile_probs(p, s, row_lse, mb, q0, k0, L, kv_len, sm_scale, tx, ty);
      tile_products(dp, Gt, Vt, D, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * i) * PS + tx + 16 * j] = to_f(from_f<T>(p[i][j]));  // P in v's dtype
      __syncthreads();

      // dV[key][d] += sum_i P[i][key] dO[i][d]
      for (int i = 0; i < BQ; ++i) {
        float pk[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pk[r] = Ps[i * PS + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = tx + 16 * c;
          const float g = d < D ? Gt[d * TS + i] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) dv_acc[r][c] = fmaf(pk[r], g, dv_acc[r][c]);
        }
      }
      __syncthreads();  // P is read; the tile now takes dS

      // dS = P (dP - delta) sm_scale, in q's dtype
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dl = row_dl[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * i) * PS + tx + 16 * j] =
              to_f(from_f<T>(p[i][j] * (dp[i][j] - dl) * sm_scale));
      }
      __syncthreads();

      // dK[key][d] += sum_i dS[i][key] Q[i][d]
      for (int i = 0; i < BQ; ++i) {
        float sk[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) sk[r] = Ps[i * PS + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = tx + 16 * c;
          const float qv = d < D ? Qt[d * TS + i] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) dk_acc[r][c] = fmaf(sk[r], qv, dk_acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + ty + 16 * r;
    if (kj >= L) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d >= D) continue;
      dk[base + (size_t)kj * rs + d] = from_f<T>(dk_acc[r][c]);
      dv[base + (size_t)kj * rs + d] = from_f<T>(dv_acc[r][c]);
    }
  }
}

// dQ of one (b, h, 64-query tile), looping over the key tiles up to the
// last valid key (all L keys for a fully padded row).
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout, const uint8_t* __restrict__ mask,
    const float* __restrict__ lse, T* __restrict__ dq, int L, int H, int D, float sm_scale) {
  constexpr int DC = DMAX / 16;
  extern __shared__ float smem[];
  float* Qt = smem;                // [D][TS]: this block's queries, transposed
  float* Gt = Qt + D * TS;         // [D][TS]: their dO
  float* Kt = Gt + D * TS;         // [D][TS]: the current key tile
  float* Vt = Kt + D * TS;         // [D][TS]
  float* Ps = Vt + D * TS;         // [BQ][PS]: dS
  float* row_lse = Ps + BQ * PS;   // [BQ]
  float* row_dl = row_lse + BQ;    // [BQ]
  __shared__ int kv_len_s;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * L * rs + (size_t)h * D;
  const size_t lse_base = ((size_t)b * H + h) * L;
  const uint8_t* mb = mask + (size_t)b * L;
  const int kv_len = block_kv_len(mb, L, &kv_len_s);
  const int k_end = kv_len > 0 ? kv_len : L;

  load_tile_t(Qt, q, base, rs, q0, L, D);
  load_tile_t(Gt, dout, base, rs, q0, L, D);
  row_stats(row_lse, row_dl, out, dout, lse, base, rs, lse_base, q0, L, D);

  // rows ty + 16 i are queries, columns tx + 16 c head dims
  float dq_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers of Kt, Vt, Ps are done
    load_tile_t(Kt, k, base, rs, k0, L, D);
    load_tile_t(Vt, v, base, rs, k0, L, D);
    __syncthreads();

    float s[4][4], p[4][4], dp[4][4];
    tile_products(s, Qt, Kt, D, tx, ty);
    tile_probs(p, s, row_lse, mb, q0, k0, L, kv_len, sm_scale, tx, ty);
    tile_products(dp, Gt, Vt, D, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dl = row_dl[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * PS + tx + 16 * j] =
            to_f(from_f<T>(p[i][j] * (dp[i][j] - dl) * sm_scale));
    }
    __syncthreads();

    // dQ[query][d] += sum_j dS[query][j] K[j][d]
    for (int j = 0; j < BK; ++j) {
      float sq[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) sq[r] = Ps[(ty + 16 * r) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        const float kv = d < D ? Kt[d * TS + j] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) dq_acc[r][c] = fmaf(sq[r], kv, dq_acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= L) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dq[base + (size_t)qi * rs + d] = from_f<T>(dq_acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *mask, *out, *dout;
  void *dst, *lse, *dq, *dk, *dv;  // forward: dst (out) and lse; backward: dq, dk, dv
  int B, L, H, D;
  float sm_scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t opt_in_smem(K kernel, int smem, int& configured) {
  if (smem <= configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) configured = smem;
  return e;
}

template <typename T, int DMAX>
cudaError_t launch_fwd(const Args& a) {
  static int configured = 0;  // dynamic shared memory opted into so far
  const int smem = (2 * a.D * TS + BK * a.D + BQ * PS + 3 * BQ) * (int)sizeof(float);
  cudaError_t e = opt_in_smem(attn_fwd_kernel<T, DMAX>, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.L + BQ - 1) / BQ, a.H, a.B);
  attn_fwd_kernel<T, DMAX><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<T*>(a.dst),
      static_cast<float*>(a.lse), a.L, a.H, a.D, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_bwd(const Args& a) {
  static int conf_kv = 0, conf_q = 0;
  const int smem = (4 * a.D * TS + BQ * PS + 2 * BQ) * (int)sizeof(float);
  cudaError_t e = opt_in_smem(attn_bwd_dkdv_kernel<T, DMAX>, smem, conf_kv);
  if (e == cudaSuccess) e = opt_in_smem(attn_bwd_dq_kernel<T, DMAX>, smem, conf_q);
  if (e != cudaSuccess) return e;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *out = static_cast<const T*>(a.out),
          *dout = static_cast<const T*>(a.dout);
  const uint8_t* mask = static_cast<const uint8_t*>(a.mask);
  const float* lse = static_cast<const float*>(a.lse);
  dim3 grid((a.L + BQ - 1) / BQ, a.H, a.B);  // BQ == BK: key tiles, then query tiles
  attn_bwd_dkdv_kernel<T, DMAX><<<grid, NT, smem, a.stream>>>(
      q, k, v, out, dout, mask, lse, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.L, a.H,
      a.D, a.sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dq_kernel<T, DMAX><<<grid, NT, smem, a.stream>>>(
      q, k, v, out, dout, mask, lse, static_cast<T*>(a.dq), a.L, a.H, a.D, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, bool BWD>
cudaError_t dispatch_d(const Args& a) {
  if (a.D <= 32) return BWD ? launch_bwd<T, 32>(a) : launch_fwd<T, 32>(a);
  if (a.D <= 64) return BWD ? launch_bwd<T, 64>(a) : launch_fwd<T, 64>(a);
  if (a.D <= 128) return BWD ? launch_bwd<T, 128>(a) : launch_fwd<T, 128>(a);
  return cudaErrorInvalidValue;
}

template <bool BWD>
int dispatch(const Args& a, int dtype) {
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float, BWD>(a);
  else if (dtype == 1)
    e = dispatch_d<__nv_bfloat16, BWD>(a);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse ([B, H, L] float32) may be null.
extern "C" int fused_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse, int B, int L,
                                   int H, int D, float sm_scale, int dtype, void* stream) {
  Args a{q, k, v, mask, nullptr, nullptr, out, lse, nullptr, nullptr, nullptr,
         B, L, H, D, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, dtype);
}

// out and lse are the forward's; dout is the cotangent of out. Writes dq,
// dk, dv (all [B, L, H, D] in the dtype of q).
extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* mask, const void* out, const void* lse,
                                   const void* dout, void* dq, void* dk, void* dv, int B,
                                   int L, int H, int D, float sm_scale, int dtype,
                                   void* stream) {
  Args a{q, k, v, mask, out, dout, nullptr, const_cast<void*>(lse), dq, dk, dv,
         B, L, H, D, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, dtype);
}
