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
// recomputes P in f32, then dV = P^T dO (P rounded to v's dtype),
// dP = dO V^T, dS = P (dP - delta) sm_scale (rounded to q's dtype),
// dQ = dS K, dK = dS^T Q, every product accumulated in f32. The TPU kernel
// takes delta = rowsum(dP o P); here delta_i = rowsum(dO_i o O_i), with O
// the forward's output, which is the same sum reordered (sum_j P_ij dO_i.V_j
// = dO_i . sum_j P_ij V_j) up to the rounding of O: exact in float32 but for
// the order of the sums, one rounding of O in bfloat16. A pre-pass kernel
// (attn_bwd_delta_kernel) writes delta once, f32 [B, H, L]; both passes read
// it.
//
// Backward design: the TPU kernel holds a whole T x T score tile per
// (b, h); here two passes, no atomics, so the result is deterministic. The
// dK/dV pass has one block per (b, h, 64-key tile) and loops over every
// query tile (query rows cannot be skipped: the cotangent at a padded query
// need not be zero); a key tile wholly past the row's last valid key has
// P = 0 for every query and writes zeros. The dQ pass has one block per
// (b, h, 64-query tile) and loops over the key tiles up to the last valid
// key, as the forward does. A batch row whose keys are all padded has every
// score equal to the bias in f32, so its P is uniform, 1/L, in the forward
// and in both passes (lse cannot carry that: neg + log L rounds to neg).
//
// What bounds the backward on the H100: at the model's shapes (L <= 1000,
// D in {32, 128}) it does 14 L^2 D flops per (b, h) over ~9 L D elements of
// traffic, so arithmetic bounds it, on the tensor cores in bfloat16 (989
// TFLOP/s). The bfloat16 passes (attn_bwd_dkdv_mma_kernel,
// attn_bwd_dq_mma_kernel) therefore run all seven products (S, dP in each
// pass, dV and dK, dQ) as mma.sync m16n8k16 bf16 -> f32, 4 warps a block,
// each warp owning 16 rows of the block's resident 64-row tile:
// * tiles stay bf16 in shared memory (rows padded to D + 8 elements, which
//   makes every ldmatrix conflict-free); the streamed tiles (queries and dO
//   in the dK/dV pass, keys and V in the dQ pass) come through a ring of
//   cp.async stages (16 bytes a thread), so the next tile's loads overlap
//   this tile's products;
// * the dK/dV pass computes S^T = K Q^T with keys as rows: P^T and dS^T leave
//   the accumulators in the A-fragment layout of dV += P^T dO and
//   dK += dS^T Q, rounded where the contract rounds them, with no trip
//   through shared memory; the dQ pass computes S = Q K^T with queries as
//   rows, likewise. B fragments come by ldmatrix from row-major tiles
//   ([row][d]): plain for the K, V / Q, dO operands of S and dP, .trans for
//   the dO, Q and K operands of dV, dK and dQ;
// * the dK/dV pass streams 64 queries a stage (two stages) and takes each
//   stage in two 32-query halves, so that its two D-wide accumulators stay
//   in registers at D = 128 (242 registers, no spills); the dQ pass streams
//   64 keys a stage (two stages). P is recomputed as exp2 of the scores
//   with sm_scale, the bias and lse taken into log2 units.
// The two passes do 7 products where an atomic dQ would do 5; their time
// splits about evenly (H100, the decoder's train shape).
// Left for later: wgmma and TMA (warpgroup products from shared memory, one
// producer warp), and staging the output tiles for 16-byte stores.
//
// The float32 passes (attn_bwd_dkdv_kernel, attn_bwd_dq_kernel) serve the
// float32 parity checks: they keep full f32 products on the CUDA cores (the
// tensor cores would round their inputs to TF32), with 4 x 4 register tiles
// fed from padded, transposed f32 shared-memory tiles.
//
// Forward design. The TPU kernel keeps a whole f32 T x T score tile in VMEM; at
// T = 1024 that is 4 MB, far past an SM's 227 KB of shared memory. Here one
// block owns (b, h, a tile of query rows) and streams 64-key tiles of K and V
// through shared memory with an online softmax (running max, running sum,
// rescaled accumulator), so no score ever reaches device memory and shared
// memory use is independent of T. Key tiles past the row's last unpadded
// key are skipped: padding sits at the end, a row with any valid key has
// one in its first tile, and exp(min/2 - m) is exactly 0 in f32, so the
// skip changes no bit of the result.
//
// What bounds the forward on the H100: it does 4 D flops per query row and
// valid key against 4 L D elements of traffic per (b, h). At the train
// shapes (L >= 768, H D = 256, ~660 valid keys a row) that is ~2.5e10 flops
// over 75 MB, so operations bound it, on the tensor cores in bfloat16; at
// the serve shapes (a batch of 4, mostly short rows) it is bytes, and below
// ~0.05 ms the wrapper's host time. The bfloat16 kernel
// (attn_fwd_mma_kernel) therefore does both products as mma.sync m16n8k16
// bf16 -> f32, each warp owning 16 query rows, 4 warps a block at D = 128
// (three blocks an SM) and 8 at D <= 64:
// * Q is staged once (rows padded to D + 8 elements, conflict-free
//   ldmatrix) in the ring's last stage and kept in registers as A fragments
//   for the whole key loop;
// * 64-key K and V tiles stream through a ring of two cp.async stages (16
//   bytes a thread, rows past L zero-filled), so the next tile's loads
//   overlap this tile's products; one barrier a tile;
// * the online softmax runs in registers: scores in log2 units (sm_scale
//   and the bias times log2 e, 2^x on the special-function unit), the row
//   max reduced across the quad that holds a row, the row sum kept per
//   thread and added across the quad once at the end; the unnormalised
//   P = 2^(s - m) is rounded to bf16 (l sums it unrounded) and leaves the
//   S accumulators straight in the A fragment layout of O += P V, whose B
//   fragments come by ldmatrix.trans from the row-major V tile;
// * the epilogue normalises by 1 / l, stages O through the warp's own rows
//   of shared memory for 16-byte stores, and writes lse = m + log(l) in
//   natural-log units, which the backward passes convert to log2
//   themselves.
// Measured on the H100 (PERF.md) it still sits well above both bounds:
// its warps wait on the chain of each tile (products, quad shuffles, 2^x,
// products), with 12-16 warps an SM to hide it. Left for later: wgmma with
// a producer warp, and 128-row blocks with two m16 tiles a warp.
// The float32 forward (attn_fwd_kernel) serves the float32 parity checks:
// FMA on the CUDA cores (4 x 4 register tiles fed from padded, transposed
// shared-memory tiles), since the tensor cores would round its inputs to
// TF32.
//
// The bf16 softmax. Both TPU kernels take the softmax dtype as a parameter
// (_softmax_rows, pallas_attention.py:63): with bfloat16 the scores, scaled
// and biased in f32, are rounded to bf16 before the max, the exp and the
// row sum, and P leaves the softmax in bf16. Every kernel above takes it as
// the template flag SM16 (round_bf16): the forward rounds each score in
// natural-log units before it goes to log2 units (rounding s log2(e)
// would round another number); the backward passes round the same scores
// before they subtract the forward's lse, which came from those rounded
// scores, and round P to bf16 before dS as well as before dV. The delta
// pre-pass reads O and dO only and takes no flag. A fully padded row's
// scores are the bias rounded, -2^127, finite, so its P stays uniform.
// SM16 adds one f32 -> bf16 -> f32 round trip per score (and per P in the
// backward) and no memory traffic.
//
// C interface (loaded with ctypes): every entry point returns the
// cudaError_t of its launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads per block: 16 x 16
constexpr int TS = BQ + 1;   // padded row stride of the transposed Q / K tiles
constexpr int PS = BK + 1;   // padded row stride of the score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr float NEG = -1.70141173319264429e+38f;  // the key-padding bias, finfo(f32).min / 2

// The bf16 softmax (SM16 = true) of the TPU kernel's _softmax_rows: a
// score, scaled and biased in f32 in natural-log units, rounded to bf16;
// the max, the exp and the row sum all come from the rounded scores.
// Finite at the bias (-2^127 in bf16), so a fully padded row stays uniform.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}


// The valid key length of a batch row: one past its last unpadded key (0:
// every key padded). Padding sits at the end of a row. Block-wide; every
// thread gets the value.
__device__ __forceinline__ int block_kv_len(const uint8_t* mb, int L, int* slot) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  int last = 0;
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    if (!mb[j]) last = j + 1;
  for (int o = 16; o; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if ((threadIdx.x & 31) == 0) atomicMax(slot, last);
  __syncthreads();
  return *slot;
}

// float32: q, k, v, out: [B, L, H, D] contiguous; mask: [B, L] bytes,
// nonzero at padding.
template <int DMAX, bool SM16>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse, int L,
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

  const int kv_len = block_kv_len(mb, L, &kv_len_s);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    Qt[d * TS + r] = qi < L ? q[base + (size_t)qi * rs + d] : 0.f;
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
      Kt[d * TS + c] = ok ? k[base + (size_t)kj * rs + d] : 0.f;
      Vs[c * D + d] = ok ? v[base + (size_t)kj * rs + d] : 0.f;
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
      const float bias = ok && mb[kj] ? NEG : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[i][j] * sm_scale + bias;
        if constexpr (SM16) x = round_bf16(x);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = ok ? x : -INFINITY;
      }
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
        pr[c] = p;
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
      if (d < D) out[base + (size_t)qi * rs + d] = acc[i][c] * inv;
    }
  }
  if (lse != nullptr && tid < BQ && q0 + tid < L)
    lse[((size_t)b * H + h) * L + q0 + tid] = row_m[tid] + logf(row_l[tid]);
}


// ---------------------------------------------------------------- backward

// delta_i = sum_d dO[i, d] O[i, d] in f32 for every (b, row, h), written to
// delta[b, h, row]. lpr lanes share a row (a power of two, at least the
// row's 16-byte pieces), each reading 16 bytes of out and dout a step, so
// a warp's loads are contiguous.
template <typename T>
__global__ void __launch_bounds__(256) attn_bwd_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta, int L,
    int H, int D, int lpr, long rows) {
  constexpr int EPC = 16 / sizeof(T);  // elements in 16 bytes
  const int lane = threadIdx.x & 31;
  const int sub = lane % lpr;
  const long warp_id = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long r = warp_id * (32 / lpr) + lane / lpr;
  float s = 0.f;
  if (r < rows)
    for (int c = sub * EPC; c < D; c += lpr * EPC) {
      const uint4 ov = *reinterpret_cast<const uint4*>(out + r * D + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + r * D + c);
      const T* o = reinterpret_cast<const T*>(&ov);
      const T* g = reinterpret_cast<const T*>(&gv);
#pragma unroll
      for (int e = 0; e < EPC; ++e) s = fmaf(to_f(g[e]), to_f(o[e]), s);
    }
  for (int o = lpr / 2; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (r < rows && sub == 0) {
    const int h = (int)(r % H);
    const long bl = r / H;
    const int l = (int)(bl % L);
    const long b = bl / L;
    delta[((size_t)b * H + h) * L + l] = s;
  }
}

// Shared by both float32 passes: a 64 x D tile of rows [r0, r0 + 64) of one
// (b, h) slice of x, transposed into dst[D][TS], zeros past L.
__device__ __forceinline__ void load_tile_t(float* dst, const float* __restrict__ x, size_t base,
                                            size_t rs, int r0, int L, int D) {
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    dst[d * TS + r] = r0 + r < L ? x[base + (size_t)(r0 + r) * rs + d] : 0.f;
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

// Per query row of the tile [q0, q0 + 64): its lse and delta; zeros past L.
__device__ __forceinline__ void row_stats(float* row_lse, float* row_dl,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, size_t lse_base,
                                          int q0, int L) {
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    row_lse[threadIdx.x] = qi < L ? lse[lse_base + qi] : 0.f;
    row_dl[threadIdx.x] = qi < L ? delta[lse_base + qi] : 0.f;
  }
}

// P of the thread's 4 x 4 (query ty + 16 i, key tx + 16 j) entries of the
// tile at (q0, k0), recomputed in f32 from the scores s and the row lse;
// with the bf16 softmax from the rounded scores, and rounded to bf16 itself
// as the TPU kernel's softmax output is.
template <bool SM16>
__device__ __forceinline__ void tile_probs(float (&p)[4][4], const float (&s)[4][4],
                                           const float* row_lse, const uint8_t* mb, int q0,
                                           int k0, int L, int kv_len, float sm_scale, int tx,
                                           int ty) {
  const float unif = 1.f / (float)L;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k0 + tx + 16 * j;
    const float bias = kj < L && mb[kj] ? NEG : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      if (qi >= L || kj >= L) {
        p[i][j] = 0.f;
      } else if (kv_len == 0) {
        p[i][j] = unif;  // every key padded: uniform, as in the forward
      } else if constexpr (SM16) {
        p[i][j] = expf(round_bf16(s[i][j] * sm_scale + bias) - row_lse[ty + 16 * i]);
      } else {
        p[i][j] = expf(s[i][j] * sm_scale + bias - row_lse[ty + 16 * i]);
      }
      if constexpr (SM16) p[i][j] = round_bf16(p[i][j]);
    }
  }
}

// float32: dK and dV of one (b, h, 64-key tile), looping over every query tile.
template <int DMAX, bool SM16>
__global__ void __launch_bounds__(NT) attn_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const uint8_t* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int L, int H, int D, float sm_scale) {
  constexpr int DC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Kt = smem;                // [D][TS]: this block's keys, transposed
  float* Vt = Kt + D * TS;         // [D][TS]
  float* Qt = Vt + D * TS;         // [D][TS]: the current query tile
  float* Gt = Qt + D * TS;         // [D][TS]: dO of the current query tile
  float* Ps = Gt + D * TS;         // [BQ][PS]: P, then dS
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
      row_stats(row_lse, row_dl, lse, delta, lse_base, q0, L);
      __syncthreads();

      // P and dP at (query ty + 16 i, key tx + 16 j)
      float s[4][4], p[4][4], dp[4][4];
      tile_products(s, Qt, Kt, D, tx, ty);
      tile_probs<SM16>(p, s, row_lse, mb, q0, k0, L, kv_len, sm_scale, tx, ty);
      tile_products(dp, Gt, Vt, D, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j];
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

      // dS = P (dP - delta) sm_scale
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dl = row_dl[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j] * (dp[i][j] - dl) * sm_scale;
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
      dk[base + (size_t)kj * rs + d] = dk_acc[r][c];
      dv[base + (size_t)kj * rs + d] = dv_acc[r][c];
    }
  }
}

// float32: dQ of one (b, h, 64-query tile), looping over the key tiles up
// to the last valid key (all L keys for a fully padded row).
template <int DMAX, bool SM16>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const uint8_t* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int L, int H, int D, float sm_scale) {
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
  row_stats(row_lse, row_dl, lse, delta, lse_base, q0, L);

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
    tile_probs<SM16>(p, s, row_lse, mb, q0, k0, L, kv_len, sm_scale, tx, ty);
    tile_products(dp, Gt, Vt, D, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dl = row_dl[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j] * (dp[i][j] - dl) * sm_scale;
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
      if (d < D) dq[base + (size_t)qi * rs + d] = dq_acc[r][c];
    }
  }
}

// ---------------------------------------------------------------- backward, bfloat16, tensor cores

constexpr int MW = 4;             // warps of a tensor-core backward block
constexpr int MR = MW * 16;       // resident rows of a block: 16 a warp
constexpr int MNT = MW * 32;      // threads of a block
constexpr int KV_NS = 64, KV_STAGES = 2;  // dK/dV pass: queries a stage, stages
constexpr int KV_SUB = 32;                // dK/dV pass: queries a product step
constexpr int Q_NS = 64, Q_STAGES = 2;    // dQ pass: keys a stage, stages
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = NEG * LOG2E;  // the key-padding bias, in log2 units

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of a 16 x 16 tile of a row-major [rows][ld] bf16 tile at (r0, c0)
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* t, int ld, int r0, int c0,
                                       int lane) {
  ldsm_x4(a, t + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two neighbouring 8-column n-tiles (b[0..1] for n0, b[2..3]
// for n0 + 8) of a k16 step at k0, where B[k][n] = t[n][k] (n-major tile:
// the K / Q / V / dO rows of S = . K^T and dP = . V^T)
__device__ __forceinline__ void ldsm_b_nmajor(uint32_t (&b)[4], const bf16* t, int ld, int n0,
                                              int k0, int lane) {
  ldsm_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// the same where B[k][n] = t[k][n] (k-major tile: the dO / Q / K rows of
// dV = P^T dO, dK = dS^T Q and dQ = dS K), transposed by ldmatrix
__device__ __forceinline__ void ldsm_b_kmajor(uint32_t (&b)[4], const bf16* t, int ld, int k0,
                                              int n0, int lane) {
  ldsm_x4_t(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// Rows [r0, r0 + n) of one (b, h) slice (row stride rs elements) into
// dst[n][DMAX + 8] by cp.async, zeros past L, by a block of NT threads.
// Columns D .. DMAX stay at the zeros the kernel wrote first.
template <int DMAX, int NT = MNT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, size_t base,
                                          size_t rs, int r0, int n, int L, int D) {
  const int cpr = D / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < n * cpr; i += NT) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * (DMAX + 8) + c, src + base + (size_t)(ok ? r0 + r : 0) * rs + c, ok);
  }
}

// n f32 row values [r0, r0 + n) of one (b, h) row of lse or delta; zeros past L
__device__ __forceinline__ void load_row_vals(float* dst, const float* __restrict__ src, int r0,
                                              int n, int L) {
  for (int i = threadIdx.x; i < n; i += MNT) {
    const bool ok = r0 + i < L;
    cp_async4(dst + i, src + (ok ? r0 + i : 0), ok);
  }
}

template <int NT = MNT>
__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += NT)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Stores a warp's 16 x DMAX accumulator rows (row0 + g, row0 + g + 8) of one
// (b, h) slice, columns below D, as bf16 pairs.
template <int DN>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[DN][4],
                                           size_t base, size_t rs, int row0, int L, int D,
                                           int g, int tq) {
#pragma unroll
  for (int nt = 0; nt < DN; ++nt) {
    const int d = nt * 8 + 2 * tq;
    if (d >= D) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + g + 8 * hh;
      if (r < L)
        *reinterpret_cast<__nv_bfloat162*>(dst + base + (size_t)r * rs + d) =
            __floats2bfloat162_rn(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
    }
  }
}

// bfloat16: dK and dV of one (b, h, 64-key tile), streaming every query tile
// of KV_NS rows. Warp w owns keys k0 + 16 w .. + 15.
template <int DMAX, bool SM16>
__global__ void __launch_bounds__(MNT) attn_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const uint8_t* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int L, int H, int D, float sm_scale) {
  constexpr int LDS = DMAX + 8;
  constexpr int KT = DMAX / 16;  // k16 steps over the head dim
  constexpr int DN = DMAX / 8;   // 8-column n-tiles over the head dim
  constexpr int SN = KV_SUB / 8;  // 8-column n-tiles over a half stage's queries
  constexpr int TILE = KV_NS * LDS;
  constexpr int SMEM = (2 * MR * LDS + 2 * KV_STAGES * TILE) * 2 + 2 * KV_STAGES * KV_NS * 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [MR][LDS]
  bf16* Vs = Ks + MR * LDS;                       // [MR][LDS]
  bf16* Qs = Vs + MR * LDS;                       // [KV_STAGES][KV_NS][LDS]
  bf16* Gs = Qs + KV_STAGES * TILE;               // [KV_STAGES][KV_NS][LDS]: dO
  float* lse_s = reinterpret_cast<float*>(Gs + KV_STAGES * TILE);  // [KV_STAGES][KV_NS]
  float* dl_s = lse_s + KV_STAGES * KV_NS;                          // [KV_STAGES][KV_NS]
  __shared__ int kv_len_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * MR;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * L * rs + (size_t)h * D;
  const size_t lse_base = ((size_t)b * H + h) * L;
  const uint8_t* mb = mask + (size_t)b * L;
  const int kv_len = block_kv_len(mb, L, &kv_len_s);

  if (kv_len > 0 && k0 >= kv_len) {
    // wholly past the last valid key: P = 0 for every query, dK = dV = 0
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < MR * D; i += MNT) {
      const int r = i / D, d = i - r * D;
      if (k0 + r < L) {
        dk[base + (size_t)(k0 + r) * rs + d] = zero;
        dv[base + (size_t)(k0 + r) * rs + d] = zero;
      }
    }
    return;
  }

  zero_smem(smem_raw, SMEM);
  __syncthreads();
  load_rows<DMAX>(Ks, k, base, rs, k0, MR, L, D);
  load_rows<DMAX>(Vs, v, base, rs, k0, MR, L, D);
  const int n_tiles = (L + KV_NS - 1) / KV_NS;
  auto issue = [&](int t) {  // one cp.async group a tile (empty past the end)
    if (t < n_tiles) {
      const int s = t % KV_STAGES, q0 = t * KV_NS;
      load_rows<DMAX>(Qs + s * TILE, q, base, rs, q0, KV_NS, L, D);
      load_rows<DMAX>(Gs + s * TILE, dout, base, rs, q0, KV_NS, L, D);
      load_row_vals(lse_s + s * KV_NS, lse + lse_base, q0, KV_NS, L);
      load_row_vals(dl_s + s * KV_NS, delta + lse_base, q0, KV_NS, L);
    }
    cp_async_commit();
  };
  for (int t = 0; t < KV_STAGES - 1; ++t) issue(t);  // K and V ride in the first group

  const int kr = warp * 16;  // this warp's rows of the key tile
  const float unif = 1.f / (float)L;
  const float scale2 = sm_scale * LOG2E;  // P = 2^(s scale2 + bias2 - lse2)
  bool key_ok[2];
  float key_bias[2], key_bias2[2];  // natural-log and log2 units
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = k0 + kr + g + 8 * hh;
    key_ok[hh] = kj < L;
    key_bias[hh] = kj < L && mb[kj] ? NEG : 0.f;
    key_bias2[hh] = key_bias[hh] * LOG2E;
  }

  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int nt = 0; nt < DN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<KV_STAGES - 2>();
    __syncthreads();  // tile t has landed; every reader of the slot refilled next is done
    issue(t + KV_STAGES - 1);
    const int s = t % KV_STAGES, q0 = t * KV_NS;
    const bf16* Qt = Qs + s * TILE;
    const bf16* Gt = Gs + s * TILE;
    const float* ls = lse_s + s * KV_NS;
    const float* dls = dl_s + s * KV_NS;

    // the stage in halves of KV_SUB queries (the registers of S^T and dP^T)
#pragma unroll 1
    for (int qs = 0; qs < KV_NS; qs += KV_SUB) {
      const bf16* Qh = Qt + qs * LDS;
      const bf16* Gh = Gt + qs * LDS;
      const float* lh = ls + qs;
      const float* dlh = dls + qs;
      const int qh0 = q0 + qs;

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x KV_SUB queries
      float st[SN][4], dpt[SN][4];
#pragma unroll
      for (int nt = 0; nt < SN; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_a(ak, Ks, LDS, kr, kk * 16, lane);
        ldsm_a(av, Vs, LDS, kr, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t bq[4], bg[4];
          ldsm_b_nmajor(bq, Qh, LDS, np * 16, kk * 16, lane);
          ldsm_b_nmajor(bg, Gh, LDS, np * 16, kk * 16, lane);
          mma_bf16(st[2 * np], ak, bq[0], bq[1]);
          mma_bf16(st[2 * np + 1], ak, bq[2], bq[3]);
          mma_bf16(dpt[2 * np], av, bg[0], bg[1]);
          mma_bf16(dpt[2 * np + 1], av, bg[2], bg[3]);
        }
      }

      // P^T (rounded to v's dtype) and dS^T = P^T (dP^T - delta) sm_scale
      // (rounded to q's dtype), packed straight into A fragments: k16 step j
      // over the queries takes n-tiles 2j (regs 0, 1) and 2j + 1 (regs 2, 3)
      uint32_t pa[KV_SUB / 16][4], sa[KV_SUB / 16][4];
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
        const int c0 = nt * 8 + 2 * tq;  // this thread's two queries, within the tile
        const float2 lq = *reinterpret_cast<const float2*>(lh + c0);
        const float2 dq2 = *reinterpret_cast<const float2*>(dlh + c0);
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hh = i >> 1;
          const float lse_c = (i & 1) ? lq.y : lq.x, dl_c = (i & 1) ? dq2.y : dq2.x;
          float pv;
          if (qh0 + c0 + (i & 1) >= L || !key_ok[hh]) {
            pv = 0.f;
          } else if (kv_len == 0) {
            pv = unif;  // every key padded: uniform, as in the forward
          } else if constexpr (SM16) {
            pv = exp2f(round_bf16(fmaf(st[nt][i], sm_scale, key_bias[hh])) * LOG2E -
                       lse_c * LOG2E);
          } else {
            pv = exp2f(fmaf(st[nt][i], scale2, key_bias2[hh] - lse_c * LOG2E));
          }
          if constexpr (SM16) pv = round_bf16(pv);  // dS from the bf16 P too
          p[i] = pv;
          ds[i] = pv * (dpt[nt][i] - dl_c) * sm_scale;
        }
        const int j = nt >> 1, o = (nt & 1) * 2;
        pa[j][o] = pack_bf16(p[0], p[1]);
        pa[j][o + 1] = pack_bf16(p[2], p[3]);
        sa[j][o] = pack_bf16(ds[0], ds[1]);
        sa[j][o + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int j = 0; j < KV_SUB / 16; ++j)
#pragma unroll
        for (int np = 0; np < DN / 2; ++np) {
          uint32_t bg[4], bq[4];
          ldsm_b_kmajor(bg, Gh, LDS, j * 16, np * 16, lane);
          ldsm_b_kmajor(bq, Qh, LDS, j * 16, np * 16, lane);
          mma_bf16(dv_acc[2 * np], pa[j], bg[0], bg[1]);
          mma_bf16(dv_acc[2 * np + 1], pa[j], bg[2], bg[3]);
          mma_bf16(dk_acc[2 * np], sa[j], bq[0], bq[1]);
          mma_bf16(dk_acc[2 * np + 1], sa[j], bq[2], bq[3]);
        }
    }
  }
  cp_async_wait<0>();

  store_rows<DN>(dk, dk_acc, base, rs, k0 + kr, L, D, g, tq);
  store_rows<DN>(dv, dv_acc, base, rs, k0 + kr, L, D, g, tq);
}

// bfloat16: dQ of one (b, h, 64-query tile), streaming the key tiles of
// Q_NS keys up to the last valid key (all L keys for a fully padded row).
// Warp w owns queries q0 + 16 w .. + 15.
template <int DMAX, bool SM16>
__global__ void __launch_bounds__(MNT) attn_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const uint8_t* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    int L, int H, int D, float sm_scale) {
  constexpr int LDS = DMAX + 8;
  constexpr int KT = DMAX / 16;
  constexpr int DN = DMAX / 8;
  constexpr int SN = Q_NS / 8;  // 8-column n-tiles over a stage's keys
  constexpr int TILE = Q_NS * LDS;
  constexpr int SMEM = (2 * MR * LDS + 2 * Q_STAGES * TILE) * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [MR][LDS]
  bf16* Gs = Qs + MR * LDS;                       // [MR][LDS]: dO
  bf16* Ks = Gs + MR * LDS;                       // [Q_STAGES][Q_NS][LDS]
  bf16* Vs = Ks + Q_STAGES * TILE;                // [Q_STAGES][Q_NS][LDS]
  __shared__ int kv_len_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * MR;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * L * rs + (size_t)h * D;
  const size_t lse_base = ((size_t)b * H + h) * L;
  const uint8_t* mb = mask + (size_t)b * L;
  const int kv_len = block_kv_len(mb, L, &kv_len_s);
  const int k_end = kv_len > 0 ? kv_len : L;

  zero_smem(smem_raw, SMEM);
  __syncthreads();
  load_rows<DMAX>(Qs, q, base, rs, q0, MR, L, D);
  load_rows<DMAX>(Gs, dout, base, rs, q0, MR, L, D);
  const int n_tiles = (k_end + Q_NS - 1) / Q_NS;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int s = t % Q_STAGES, kt0 = t * Q_NS;
      load_rows<DMAX>(Ks + s * TILE, k, base, rs, kt0, Q_NS, L, D);
      load_rows<DMAX>(Vs + s * TILE, v, base, rs, kt0, Q_NS, L, D);
    }
    cp_async_commit();
  };
  for (int t = 0; t < Q_STAGES - 1; ++t) issue(t);  // Q and dO ride in the first group

  const int qr = warp * 16;  // this warp's rows of the query tile
  const float unif = 1.f / (float)L;
  const float scale2 = sm_scale * LOG2E;
  bool q_ok[2];
  float row_lse2[2], row_dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + qr + g + 8 * hh;
    q_ok[hh] = qi < L;
    row_lse2[hh] = qi < L ? lse[lse_base + qi] * LOG2E : 0.f;
    row_dl[hh] = qi < L ? delta[lse_base + qi] : 0.f;
  }

  float dq_acc[DN][4];
#pragma unroll
  for (int nt = 0; nt < DN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq_acc[nt][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<Q_STAGES - 2>();
    __syncthreads();
    issue(t + Q_STAGES - 1);
    const int s = t % Q_STAGES, kt0 = t * Q_NS;
    const bf16* Kt = Ks + s * TILE;
    const bf16* Vt = Vs + s * TILE;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x Q_NS keys
    float sc[SN][4], dp[SN][4];
#pragma unroll
    for (int nt = 0; nt < SN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t aq[4], ag[4];
      ldsm_a(aq, Qs, LDS, qr, kk * 16, lane);
      ldsm_a(ag, Gs, LDS, qr, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_b_nmajor(bk, Kt, LDS, np * 16, kk * 16, lane);
        ldsm_b_nmajor(bv, Vt, LDS, np * 16, kk * 16, lane);
        mma_bf16(sc[2 * np], aq, bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ag, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ag, bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta) sm_scale, rounded to q's dtype, packed into A fragments
    uint32_t sa[Q_NS / 16][4];
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = kt0 + nt * 8 + 2 * tq + (i & 1);
        const int hh = i >> 1;
        float pv;
        if (!q_ok[hh] || kj >= L) {
          pv = 0.f;
        } else if (kv_len == 0) {
          pv = unif;
        } else if constexpr (SM16) {
          pv = exp2f(round_bf16(fmaf(sc[nt][i], sm_scale, mb[kj] ? NEG : 0.f)) * LOG2E -
                     row_lse2[hh]);
        } else {
          pv = exp2f(fmaf(sc[nt][i], scale2, (mb[kj] ? NEG2 : 0.f) - row_lse2[hh]));
        }
        if constexpr (SM16) pv = round_bf16(pv);
        ds[i] = pv * (dp[nt][i] - row_dl[hh]) * sm_scale;
      }
      const int j = nt >> 1, o = (nt & 1) * 2;
      sa[j][o] = pack_bf16(ds[0], ds[1]);
      sa[j][o + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K
#pragma unroll
    for (int j = 0; j < Q_NS / 16; ++j)
#pragma unroll
      for (int np = 0; np < DN / 2; ++np) {
        uint32_t bk[4];
        ldsm_b_kmajor(bk, Kt, LDS, j * 16, np * 16, lane);
        mma_bf16(dq_acc[2 * np], sa[j], bk[0], bk[1]);
        mma_bf16(dq_acc[2 * np + 1], sa[j], bk[2], bk[3]);
      }
  }
  cp_async_wait<0>();

  store_rows<DN>(dq, dq_acc, base, rs, q0 + qr, L, D, g, tq);
}

// ---------------------------------------------------------------- forward, bfloat16, tensor cores

constexpr int F_NS = 64, F_STAGES = 2;  // forward: keys a stage, stages
constexpr float LN2 = 0.6931471805599453f;

// warps a forward block, 16 query rows each: 8 where the head dim is small
// (a block's fixed costs weigh most there), else 4, so that three blocks
// fit on an SM (168 registers a thread, 70 KB of shared memory at D = 128)
constexpr int fwd_warps(int dmax) { return dmax <= 64 ? 8 : 4; }

// 2^x by the special-function unit alone: a few f32 ulps of error, far
// below the bf16 rounding of P; flushes results below 2^-126 to 0, weights
// that no row sum of at least 1 can feel
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bfloat16: out (and lse) of one (b, h, tile of 16 NW queries), streaming
// the key tiles of F_NS keys up to the last valid key (all L keys for a
// fully padded row). Warp w owns queries q0 + 16 w .. + 15; its Q fragments
// stay in registers, and P goes from the S accumulators into the A
// fragments of O += P V without a trip through shared memory. Q is staged
// in the ring's last stage, which the first tiles leave free.
template <int DMAX, bool SM16, int NW = fwd_warps(DMAX)>
__global__ void __launch_bounds__(NW * 32, NW == 4 ? 3 : 1) attn_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ mask, bf16* __restrict__ out, float* __restrict__ lse, int L,
    int H, int D, float sm_scale) {
  constexpr int F_MR = NW * 16;  // query rows a block
  constexpr int F_NT = NW * 32;  // threads a block
  constexpr int LDS = DMAX + 8;
  constexpr int KT = DMAX / 16;  // k16 steps over the head dim
  constexpr int DN = DMAX / 8;   // 8-column n-tiles over the head dim
  constexpr int SN = F_NS / 8;   // 8-column n-tiles over a stage's keys
  constexpr int TILE = F_NS * LDS;
  constexpr int SMEM = 2 * F_STAGES * TILE * 2;
  static_assert(F_MR <= 2 * F_NS, "Q fits in one stage");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [F_STAGES][2][F_NS][LDS]: K, V
  bf16* Qs = Ks + (F_STAGES - 1) * 2 * TILE;     // Q in the last stage, O on the way out
  __shared__ int kv_len_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * F_MR;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * L * rs + (size_t)h * D;
  const uint8_t* mb = mask + (size_t)b * L;
  const int kv_len = block_kv_len(mb, L, &kv_len_s);
  const int k_end = kv_len > 0 ? kv_len : L;

  if (D < DMAX) {  // head dims past D stay zero in every tile
    zero_smem<F_NT>(smem_raw, SMEM);
    __syncthreads();
  }
  load_rows<DMAX, F_NT>(Qs, q, base, rs, q0, F_MR, L, D);
  const int n_tiles = (k_end + F_NS - 1) / F_NS;
  auto issue = [&](int t) {  // one cp.async group a tile (empty past the end)
    if (t < n_tiles) {
      const int s = t % F_STAGES, k0 = t * F_NS;
      load_rows<DMAX, F_NT>(Ks + s * 2 * TILE, k, base, rs, k0, F_NS, L, D);
      load_rows<DMAX, F_NT>(Ks + s * 2 * TILE + TILE, v, base, rs, k0, F_NS, L, D);
    }
    cp_async_commit();
  };
  for (int t = 0; t < F_STAGES - 1; ++t) issue(t);  // Q rides in the first group

  const int qr = warp * 16;  // this warp's rows of the query tile
  cp_async_wait<F_STAGES - 2>();
  __syncthreads();
  uint32_t aq[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) ldsm_a(aq[kk], Qs, LDS, qr, kk * 16, lane);

  // rows g (hh = 0) and g + 8 (hh = 1) of the warp's 16: the running max in
  // log2 units, and this thread's share of the running sum (its quad's four
  // shares are added at the end)
  const float scale2 = sm_scale * LOG2E;
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DN][4];
#pragma unroll
  for (int nt = 0; nt < DN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();  // tile t has landed; every reader of the slot refilled next is done
    issue(t + F_STAGES - 1);
    const int s = t % F_STAGES, k0 = t * F_NS;
    const bf16* Kt = Ks + s * 2 * TILE;
    const bf16* Vt = Kt + TILE;

    // S = Q K^T: this warp's 16 queries x F_NS keys
    float sc[SN][4];
#pragma unroll
    for (int nt = 0; nt < SN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t bk[4];
        ldsm_b_nmajor(bk, Kt, LDS, np * 16, kk * 16, lane);
        mma_bf16(sc[2 * np], aq[kk], bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], aq[kk], bk[2], bk[3]);
      }

    // scores in log2 units with the key-padding bias (with the bf16
    // softmax, rounded in natural-log units first); keys past L do not
    // exist (weight 0); each row's tile max across its quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < SN; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + nt * 8 + 2 * tq + e;
        const float bias = kj >= L ? -INFINITY : (mb[kj] ? NEG2 : 0.f);
        const float bias_e = kj < L ? (mb[kj] ? NEG : 0.f) : -INFINITY;  // natural log
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float x;
          if constexpr (SM16)
            x = round_bf16(fmaf(sc[nt][2 * hh + e], sm_scale, bias_e)) * LOG2E;
          else
            x = fmaf(sc[nt][2 * hh + e], scale2, bias);
          sc[nt][2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      m_new[hh] = fmaxf(m2[hh], mx[hh]);  // finite: key k0 is < L
      alpha[hh] = ex2(m2[hh] - m_new[hh]);
      m2[hh] = m_new[hh];
      l[hh] *= alpha[hh];
    }

    // P = 2^(s - m) in f32 for the row sums, rounded to bf16 for P V,
    // packed straight into A fragments: k16 step j over the keys takes
    // n-tiles 2j (regs 0, 1) and 2j + 1 (regs 2, 3)
    uint32_t pa[F_NS / 16][4];
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ex2(sc[nt][i] - m_new[i >> 1]);
        l[i >> 1] += p[i];
      }
      const int j = nt >> 1, o2 = (nt & 1) * 2;
      pa[j][o2] = pack_bf16(p[0], p[1]);
      pa[j][o2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O = O alpha + P V
#pragma unroll
    for (int nt = 0; nt < DN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nt][i] *= alpha[i >> 1];
#pragma unroll
    for (int j = 0; j < F_NS / 16; ++j)
#pragma unroll
      for (int np = 0; np < DN / 2; ++np) {
        uint32_t bv[4];
        ldsm_b_kmajor(bv, Vt, LDS, j * 16, np * 16, lane);
        mma_bf16(o[2 * np], pa[j], bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], pa[j], bv[2], bv[3]);
      }
  }
  cp_async_wait<0>();

  // O / l, through this warp's own rows of Qs, out in 16-byte pieces; lse
  // in natural-log units (the backward passes convert it themselves)
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    inv[hh] = 1.f / l[hh];
  }
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int nt = 0; nt < DN; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<__nv_bfloat162*>(Qs + (qr + g + 8 * hh) * LDS + nt * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[nt][2 * hh] * inv[hh], o[nt][2 * hh + 1] * inv[hh]);
  __syncwarp();
  const int cpr = D / 8;  // 16-byte pieces a row
  for (int i = lane; i < 16 * cpr; i += 32) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    const int qi = q0 + qr + r;
    if (qi < L)
      *reinterpret_cast<uint4*>(out + base + (size_t)qi * rs + c) =
          *reinterpret_cast<const uint4*>(Qs + (qr + r) * LDS + c);
  }
  if (lse != nullptr && tq == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = q0 + qr + g + 8 * hh;
      if (qi < L) lse[((size_t)b * H + h) * L + qi] = m2[hh] * LN2 + logf(l[hh]);
    }
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *mask, *delta, *dout;
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

template <int DMAX, bool SM16>
cudaError_t launch_fwd_f32(const Args& a) {
  static int configured = 0;  // dynamic shared memory opted into so far
  const int smem = (2 * a.D * TS + BK * a.D + BQ * PS + 3 * BQ) * (int)sizeof(float);
  cudaError_t e = opt_in_smem(attn_fwd_kernel<DMAX, SM16>, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.L + BQ - 1) / BQ, a.H, a.B);
  attn_fwd_kernel<DMAX, SM16><<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<float*>(a.dst), static_cast<float*>(a.lse), a.L, a.H, a.D, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX, bool SM16>
cudaError_t launch_fwd_mma(const Args& a) {
  constexpr int smem = 2 * F_STAGES * F_NS * (DMAX + 8) * 2;
  static int configured = 0;
  cudaError_t e = opt_in_smem(attn_fwd_mma_kernel<DMAX, SM16>, smem, configured);
  if (e != cudaSuccess) return e;
  constexpr int F_MR = fwd_warps(DMAX) * 16;
  dim3 grid((a.L + F_MR - 1) / F_MR, a.H, a.B);
  attn_fwd_mma_kernel<DMAX, SM16><<<grid, fwd_warps(DMAX) * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<bf16*>(a.dst), static_cast<float*>(a.lse), a.L, a.H, a.D, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX, bool SM16>
cudaError_t launch_bwd_f32(const Args& a) {
  static int conf_kv = 0, conf_q = 0;
  const int smem = (4 * a.D * TS + BQ * PS + 2 * BQ) * (int)sizeof(float);
  cudaError_t e = opt_in_smem(attn_bwd_dkdv_kernel<DMAX, SM16>, smem, conf_kv);
  if (e == cudaSuccess) e = opt_in_smem(attn_bwd_dq_kernel<DMAX, SM16>, smem, conf_q);
  if (e != cudaSuccess) return e;
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout),
              *lse = static_cast<const float*>(a.lse), *delta = static_cast<const float*>(a.delta);
  const uint8_t* mask = static_cast<const uint8_t*>(a.mask);
  dim3 grid((a.L + BQ - 1) / BQ, a.H, a.B);  // BQ == BK: key tiles, then query tiles
  attn_bwd_dkdv_kernel<DMAX, SM16><<<grid, NT, smem, a.stream>>>(
      q, k, v, dout, mask, lse, delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.L, a.H, a.D, a.sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dq_kernel<DMAX, SM16><<<grid, NT, smem, a.stream>>>(
      q, k, v, dout, mask, lse, delta, static_cast<float*>(a.dq), a.L, a.H, a.D, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX, bool SM16>
cudaError_t launch_bwd_mma(const Args& a) {
  constexpr int LDS = DMAX + 8;
  constexpr int smem_kv = (2 * MR * LDS + 2 * KV_STAGES * KV_NS * LDS) * 2 + 2 * KV_STAGES * KV_NS * 4;
  constexpr int smem_q = (2 * MR * LDS + 2 * Q_STAGES * Q_NS * LDS) * 2;
  static int conf_kv = 0, conf_q = 0;
  cudaError_t e = opt_in_smem(attn_bwd_dkdv_mma_kernel<DMAX, SM16>, smem_kv, conf_kv);
  if (e == cudaSuccess) e = opt_in_smem(attn_bwd_dq_mma_kernel<DMAX, SM16>, smem_q, conf_q);
  if (e != cudaSuccess) return e;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *dout = static_cast<const bf16*>(a.dout);
  const float *lse = static_cast<const float*>(a.lse), *delta = static_cast<const float*>(a.delta);
  const uint8_t* mask = static_cast<const uint8_t*>(a.mask);
  dim3 grid((a.L + MR - 1) / MR, a.H, a.B);
  attn_bwd_dkdv_mma_kernel<DMAX, SM16><<<grid, MNT, smem_kv, a.stream>>>(
      q, k, v, dout, mask, lse, delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.L,
      a.H, a.D, a.sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dq_mma_kernel<DMAX, SM16><<<grid, MNT, smem_q, a.stream>>>(
      q, k, v, dout, mask, lse, delta, static_cast<bf16*>(a.dq), a.L, a.H, a.D, a.sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_delta(const void* out, const void* dout, void* delta, int B, int L, int H,
                         int D, cudaStream_t stream) {
  const int pieces = D / (16 / (int)sizeof(T));  // 16-byte pieces a row
  int lpr = 1;
  while (lpr < pieces && lpr < 32) lpr *= 2;
  const long rows = (long)B * L * H;
  const long warps = (rows + 32 / lpr - 1) / (32 / lpr);
  const long blocks = (warps + 7) / 8;
  attn_bwd_delta_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<float*>(delta), L,
      H, D, lpr, rows);
  return cudaGetLastError();
}

// float32 on the CUDA cores, bfloat16 on the tensor cores
template <bool SM16>
cudaError_t dispatch_fwd(const Args& a, int dtype) {
  if (a.D > 128 || a.D % 8 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if (a.D <= 32) return dtype == 0 ? launch_fwd_f32<32, SM16>(a) : launch_fwd_mma<32, SM16>(a);
  if (a.D <= 64) return dtype == 0 ? launch_fwd_f32<64, SM16>(a) : launch_fwd_mma<64, SM16>(a);
  return dtype == 0 ? launch_fwd_f32<128, SM16>(a) : launch_fwd_mma<128, SM16>(a);
}

// float32 on the CUDA cores, bfloat16 on the tensor cores
template <bool SM16>
cudaError_t dispatch_bwd(const Args& a, int dtype) {
  if (a.D > 128 || a.D % 8 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if (a.D <= 32) return dtype == 0 ? launch_bwd_f32<32, SM16>(a) : launch_bwd_mma<32, SM16>(a);
  if (a.D <= 64) return dtype == 0 ? launch_bwd_f32<64, SM16>(a) : launch_bwd_mma<64, SM16>(a);
  return dtype == 0 ? launch_bwd_f32<128, SM16>(a) : launch_bwd_mma<128, SM16>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; softmax_bf16: 1 = the bf16 softmax.
// lse ([B, H, L] float32) may be null.
extern "C" int fused_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse, int B, int L,
                                   int H, int D, float sm_scale, int dtype, int softmax_bf16,
                                   void* stream) {
  Args a{q, k, v, mask, nullptr, nullptr, out, lse, nullptr, nullptr, nullptr,
         B, L, H, D, sm_scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(softmax_bf16 ? dispatch_fwd<true>(a, dtype)
                                       : dispatch_fwd<false>(a, dtype));
}

// delta[b, h, l] = sum_d dout[b, l, h, d] out[b, l, h, d] in f32; out and
// dout [B, L, H, D] (rows 16-byte aligned), delta [B, H, L] float32.
extern "C" int fused_attention_bwd_delta(const void* out, const void* dout, void* delta, int B,
                                         int L, int H, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D % 8 || D > 128)
    e = cudaErrorInvalidValue;
  else if (dtype == 0)
    e = launch_delta<float>(out, dout, delta, B, L, H, D, s);
  else if (dtype == 1)
    e = launch_delta<__nv_bfloat16>(out, dout, delta, B, L, H, D, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// lse is the forward's (of the same softmax_bf16), delta the pre-pass's;
// dout is the cotangent of out. Writes dq, dk, dv (all [B, L, H, D] in the
// dtype of q).
extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* mask, const void* delta, const void* lse,
                                   const void* dout, void* dq, void* dk, void* dv, int B,
                                   int L, int H, int D, float sm_scale, int dtype,
                                   int softmax_bf16, void* stream) {
  Args a{q, k, v, mask, delta, dout, nullptr, const_cast<void*>(lse), dq, dk, dv,
         B, L, H, D, sm_scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(softmax_bf16 ? dispatch_bwd<true>(a, dtype)
                                       : dispatch_bwd<false>(a, dtype));
}
