// Fused SAME-padded conv1d (+bias, +ReLU, +channel LayerNorm) forward for
// Hopper (sm_90a).
//
// Replaces the TPU kernel speakingstyle_tpu/ops/pallas_conv.py::_kernel
// (launched by _fused_fwd_pallas, reached through fused_conv1d and
// fused_conv_relu_ln). It computes the same function:
//   y[t, o] = bias[o] + sum_j sum_c x[t + j*dil - pad_lo, c] * w[j, c, o]
// accumulated in f32 (x zero outside [0, T)), then ReLU if asked, then, with
// LayerNorm, the activation rounded to the storage dtype first and mean /
// variance (eps 1e-5, the variance about the mean in a second pass) taken
// over all Cout channels of each time step before the affine; one write of
// the result in the storage dtype. With LayerNorm it can also write that
// rounded post-ReLU, pre-LN activation (`act`, the TPU kernel's second
// output under want_act), which the analytic backward reads
// (ops/fused_conv.py).
//
// Design: an implicit GEMM, M = time steps, N = Cout, reduction over the K
// taps and Cin; the im2col matrix is never formed. What bounds it on the
// H100: at the model's shapes (Cin, Cout up to 1024, K up to 9, B*T in the
// thousands) a conv does 2*B*T*K*Cin*Cout flops on a few MB, so arithmetic
// bounds it. Two kernels, chosen by the storage dtype:
//
// * bfloat16 (the model's compute dtype), conv_fwd_mma_kernel: the products
//   run on the tensor cores, mma.sync m16n8k16 bf16 -> f32. A block of 8
//   warps (2 along steps x 4 along channels) owns BM time steps (128, or 64
//   / 32 where 128-step tiles would leave SMs idle) x 128 output channels
//   of one batch row. The reduction walks (Cin chunk of 64, tap) pairs
//   through a ring of 3 shared-memory stages filled by cp.async (16 bytes a
//   thread, zero-filled at the edges), so two pairs of loads are in flight
//   behind the products. A chunk's input rows, the block's steps and their
//   (K-1)*dil-step halo, are staged once, with its first tap, and all K
//   taps read them shifted by j*dil rows; each pair brings its tap's
//   [64 Cin x 128 Cout] weight tile, row-major as it lies in w. A fragments
//   come by ldmatrix, B fragments by ldmatrix.trans straight from the
//   row-major weight tile; rows are padded to 72 / 136 elements, which
//   makes both conflict-free. Where Cin or Cout is not a multiple of 8 (or
//   a pointer is not 16-byte aligned) that operand is staged by plain loads
//   instead. At 64 input channels a stage each warp does 64 mma between two
//   barriers (32 channels measured ~20 % slower on the H100).
//   LayerNorm needs each time step's statistics over all of Cout, so the
//   LN variant splits Cout across a thread-block cluster of at most 8
//   blocks (the portable maximum; 8 x 128 at Cout = 1024), launched with
//   cudaLaunchKernelEx and a cluster-dimension attribute: of the n =
//   ceil(Cout / 128) channel tiles each block owns tiles = ceil(n / 8) in
//   a row, over its BM steps, and the cluster has ceil(n / tiles) blocks.
//   A block computes its tiles one after another; every tile but its last
//   parks the rounded pre-LN activation in the output buffer (exact: the
//   values are already bf16) and reads it back for both statistics passes
//   and the final affine. Each block sums both passes' per-step partials
//   (the mean, then the variance about it) over its tiles, and the blocks
//   exchange them through distributed shared memory (map_shared_rank),
//   summed in rank order so that every block of the cluster gets the same
//   bits. (One block owning 16 steps x all of Cout would re-read the whole
//   6 MB weight per 16 steps.)
// * float32, conv_fwd_kernel: f32 FMA on the CUDA cores, which keeps full
//   f32 products (the tensor cores would round the inputs to TF32) for the
//   float32 parity checks. A block owns 16 steps and 256 * CPT channels,
//   one thread per channel, 16 x CPT accumulators each. With LayerNorm one
//   block covers all of Cout: past 1024 channels in groups of 1024, one
//   after another, every group but the last parked in the output buffer
//   until the statistics are known.
//
// Left for later: wgmma and TMA (warpgroup products from shared memory fed
// by one producer warp), larger tiles (each weight tile is read once per
// 128 steps, each input chunk once per 128 channels), and 16-byte output
// stores.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float LN_EPS = 1e-5f;

// ---------------------------------------------------------------- float32, CUDA cores

constexpr int BT = 16;    // output time steps per block
constexpr int NT = 256;   // threads per block
constexpr int BCI = 32;   // input channels per staged halo chunk (multiple of 4)

// Sums part[r] over the block for every row r; returns the sums in stat[].
__device__ __forceinline__ void block_row_sums(float (&part)[BT], float* stat,
                                               float (*red)[BT]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int o = 16; o; o >>= 1) part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < BT; ++r) red[warp][r] = part[r];
  __syncthreads();
  if (threadIdx.x < BT) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red[w][threadIdx.x];
    stat[threadIdx.x] = s;
  }
  __syncthreads();
}

// Stores a block's BT x (NT * CPT) tile of rows t0.. of batch row b.
template <int CPT>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[BT][CPT],
                                           const int (&co)[CPT], const bool (&co_ok)[CPT],
                                           int T_len, int Cout, int b, int t0) {
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int t = t0 + r;
    if (t >= T_len) break;
    float* row = dst + ((size_t)b * T_len + t) * Cout;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (co_ok[c]) row[co[c]] = acc[r][c];
  }
}

// x: [B, T, Cin]; w: [K, Cin, Cout]; bias, ln_scale, ln_shift: [Cout] (bias
// may be null); out and act (null unless wanted): [B, T, Cout]. All
// contiguous float32.
template <int CPT, bool LN>
__global__ void __launch_bounds__(NT) conv_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_shift,
    float* __restrict__ out, float* __restrict__ act, int T_len, int Cin, int Cout, int K,
    int dil, int pad_lo, int relu) {
  extern __shared__ float4 halo4[];  // [rows][BCI / 4]
  float* halo = reinterpret_cast<float*>(halo4);
  __shared__ float red[NT / 32][BT];
  __shared__ float stat[BT];

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT;
  const int b = blockIdx.z;
  const int rows = BT + (K - 1) * dil;
  const float* xb = x + (size_t)b * T_len * Cin;
  // with LN one block covers all of Cout, in groups of NT * CPT channels
  // computed one after another; every group but the last parks its pre-LN
  // values in out until the statistics are known
  const int n_groups = LN ? (Cout + NT * CPT - 1) / (NT * CPT) : 1;

  int co[CPT];
  bool co_ok[CPT];
  float acc[BT][CPT];
  float part[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) part[r] = 0.f;
  auto group_channels = [&](int gi) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      co[c] = (LN ? gi : blockIdx.y) * (NT * CPT) + tid + NT * c;
      co_ok[c] = co[c] < Cout;
    }
  };

  for (int gi = 0; gi < n_groups; ++gi) {
    group_channels(gi);
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

    for (int ci0 = 0; ci0 < Cin; ci0 += BCI) {
      __syncthreads();  // the previous chunk's readers are done
      for (int i = tid; i < rows * BCI; i += NT) {
        const int r = i / BCI, c = i - r * BCI;
        const int t = t0 - pad_lo + r, ci = ci0 + c;
        halo[i] = (t >= 0 && t < T_len && ci < Cin) ? xb[(size_t)t * Cin + ci] : 0.f;
      }
      __syncthreads();
      const int nci = min(BCI, Cin - ci0);
      for (int j = 0; j < K; ++j) {
        const float4* hx = halo4 + (j * dil) * (BCI / 4);
        const float* wj = w + ((size_t)j * Cin + ci0) * Cout;
        for (int c4 = 0; c4 * 4 < nci; ++c4) {
          float wv[4][CPT];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int ci = c4 * 4 + u;
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              wv[u][c] = (ci < nci && co_ok[c]) ? wj[(size_t)ci * Cout + co[c]] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float4 xv = hx[r * (BCI / 4) + c4];
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              float a = acc[r][c];
              a = fmaf(xv.x, wv[0][c], a);
              a = fmaf(xv.y, wv[1][c], a);
              a = fmaf(xv.z, wv[2][c], a);
              a = fmaf(xv.w, wv[3][c], a);
              acc[r][c] = a;
            }
          }
        }
      }
    }

    // epilogue: bias, ReLU, then (LN) the per-row sums of the mean (rounding
    // the activation to the storage dtype first is the identity in float32)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float bc = (bias != nullptr && co_ok[c]) ? bias[co[c]] : 0.f;
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        float v = acc[r][c] + bc;
        if (relu) v = v < 0.f ? 0.f : v;  // not fmaxf: NaN passes on, as in jnp.maximum
        acc[r][c] = v;
      }
    }
    if (act != nullptr) store_rows<CPT>(act, acc, co, co_ok, T_len, Cout, b, t0);
    if (LN) {
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) part[r] += co_ok[c] ? acc[r][c] : 0.f;
      if (gi + 1 < n_groups) store_rows<CPT>(out, acc, co, co_ok, T_len, Cout, b, t0);
    }
  }
  if (LN) {
    // a parked group's value of row r, channel c (this thread wrote it)
    auto parked = [&](int r, int c) {
      const int t = t0 + r;
      return (t < T_len && co_ok[c]) ? out[((size_t)b * T_len + t) * Cout + co[c]] : 0.f;
    };
    const float inv_n = 1.f / (float)Cout;
    block_row_sums(part, stat, red);
    float mean[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) mean[r] = stat[r] * inv_n;
#pragma unroll
    for (int r = 0; r < BT; ++r) part[r] = 0.f;
    for (int gi = 0; gi + 1 < n_groups; ++gi) {
      group_channels(gi);
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float d = parked(r, c) - mean[r];
          part[r] += co_ok[c] ? d * d : 0.f;
        }
    }
    group_channels(n_groups - 1);
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float d = acc[r][c] - mean[r];
        part[r] += co_ok[c] ? d * d : 0.f;
      }
    block_row_sums(part, stat, red);
    float rstd[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) rstd[r] = 1.f / sqrtf(stat[r] * inv_n + LN_EPS);
    for (int gi = 0; gi + 1 < n_groups; ++gi) {
      group_channels(gi);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float gm = co_ok[c] ? ln_scale[co[c]] : 0.f;
        const float sh = co_ok[c] ? ln_shift[co[c]] : 0.f;
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const int t = t0 + r;
          if (t < T_len && co_ok[c])
            out[((size_t)b * T_len + t) * Cout + co[c]] =
                (parked(r, c) - mean[r]) * rstd[r] * gm + sh;
        }
      }
    }
    group_channels(n_groups - 1);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float g = co_ok[c] ? ln_scale[co[c]] : 0.f;
        const float s = co_ok[c] ? ln_shift[co[c]] : 0.f;
        acc[r][c] = (acc[r][c] - mean[r]) * rstd[r] * g + s;
      }
    }
  }
  store_rows<CPT>(out, acc, co, co_ok, T_len, Cout, b, t0);
}

template <int CPT, bool LN>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* ln_scale,
                   const void* ln_shift, void* out, void* act, int B, int T_len, int Cin,
                   int Cout, int K, int dil, int relu, cudaStream_t stream) {
  static int configured = 48 * 1024;  // default dynamic shared memory limit
  const int span = (K - 1) * dil + 1;
  const int smem = (BT + span - 1) * BCI * (int)sizeof(float);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(conv_fwd_kernel<CPT, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((T_len + BT - 1) / BT, LN ? 1 : (Cout + NT * CPT - 1) / (NT * CPT), B);
  conv_fwd_kernel<CPT, LN><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_shift), static_cast<float*>(out), static_cast<float*>(act),
      T_len, Cin, Cout, K, dil, (span - 1) / 2, relu);
  return cudaGetLastError();
}

template <bool LN>
cudaError_t dispatch_cpt(const void* x, const void* w, const void* bias,
                         const void* ln_scale, const void* ln_shift, void* out, void* act,
                         int B, int T_len, int Cin, int Cout, int K, int dil, int relu,
                         cudaStream_t s) {
  // channels per thread: one block covers Cout up to 1024 in one group
  // (with LN, wider Cout in groups of 1024, conv_fwd_kernel)
  const int cpt = min(4, (Cout + NT - 1) / NT);
  switch (cpt) {
    case 1: return launch<1, LN>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, s);
    case 2: return launch<2, LN>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, s);
    case 3: return launch<3, LN>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, s);
    default: return launch<4, LN>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, s);
  }
}

// ---------------------------------------------------------------- bfloat16, tensor cores

namespace cg = cooperative_groups;
constexpr int CONV_BK = 64;        // input channels a stage: four k16 steps
constexpr int CONV_BN = 128;       // output channels a block
constexpr int CONV_STAGES = 3;     // cp.async ring
constexpr int CONV_WM = 2, CONV_WN = 4;  // warps along steps, along channels
constexpr int CONV_NTH = CONV_WM * CONV_WN * 32;
constexpr int CONV_NT8 = CONV_BN / CONV_WN / 8;  // 8-channel mma tiles a warp
constexpr int A_LD = CONV_BK + 8;  // 144-byte rows: ldmatrix conflict-free
constexpr int B_LD = CONV_BN + 8;  // 272-byte rows
constexpr int MAX_CLUSTER = 8;     // LayerNorm: blocks sharing Cout (the portable maximum)

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 8 elements into shared memory, the first n_ok of them from src, the rest
// zeros: one 16-byte cp.async where vec (then n_ok is 0 or 8, and safe is
// any readable address for the zero fill), plain loads otherwise
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, const bf16* safe, int n_ok,
                                      bool vec) {
  if (vec) {
    cp_async16(dst, n_ok > 0 ? src : safe, n_ok > 0);
  } else {
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = e < n_ok ? src[e] : zero;
  }
}

// Stores a warp's MT x NT8 mma accumulator tiles, rows t0.. and columns c0..
// of batch row b: acc[mt][nt][i] is row mt*16 + g + 8*(i >> 1), column
// nt*8 + 2*q + (i & 1). Pairs go out as one 32-bit store where Cout is even.
template <int MT, int NT8>
__device__ __forceinline__ void store_mma_tile(bf16* dst, const float (&acc)[MT][NT8][4],
                                               int T_len, int Cout, int b, int t0, int c0,
                                               int g, int q) {
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + mt * 16 + g + 8 * h;
      if (t >= T_len) continue;
      bf16* row = dst + ((size_t)b * T_len + t) * Cout;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        const int co = c0 + nt * 8 + 2 * q;
        if (co >= Cout) continue;
        if (pairs)
          *reinterpret_cast<__nv_bfloat162*>(row + co) =
              __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        else {
          row[co] = __float2bfloat16(acc[mt][nt][2 * h]);
          if (co + 1 < Cout) row[co + 1] = __float2bfloat16(acc[mt][nt][2 * h + 1]);
        }
      }
    }
}

// The same contract as conv_fwd_kernel, for bfloat16 tensors. A block owns
// BM = CONV_WM * MT * 16 steps (t0 = blockIdx.y * BM of batch row blockIdx.z)
// and `tiles` tiles of CONV_BN channels, the first at n0 = blockIdx.x *
// tiles * CONV_BN, computed one after another; each warp MT 16-row x
// CONV_NT8 8-column mma tiles of each. Without LN a block has one tile.
// With LN the launch makes blockIdx.x's axis one cluster (gridDim.x = its
// size), which together covers Cout; every tile but a block's last parks
// its pre-LN activation (already rounded to bf16, so exactly) in out until
// the statistics are known, and is read back from there.
template <int MT, bool LN>
__global__ void __launch_bounds__(CONV_NTH, 2) conv_fwd_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    const bf16* __restrict__ ln_scale, const bf16* __restrict__ ln_shift,
    bf16* __restrict__ out, bf16* __restrict__ act, int T_len, int Cin, int Cout, int K,
    int dil, int pad_lo, int relu, int vec_x, int vec_w, int tiles) {
  constexpr int BM = CONV_WM * MT * 16;
  constexpr int NT8 = CONV_NT8;
  constexpr int B_ELEMS = CONV_BK * B_LD;
  const int A_ELEMS = (BM + (K - 1) * dil) * A_LD;  // a chunk's rows: the steps and their halo
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [CONV_STAGES][rows][A_LD]: x, one chunk
  bf16* Bs = As + CONV_STAGES * A_ELEMS;          // [CONV_STAGES][CONV_BK][B_LD]: w, row-major
  __shared__ float red[CONV_WN][BM];
  __shared__ float stat[BM];
  __shared__ float part[2][BM];  // LN: this block's per-step sums of both passes, read cluster-wide

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / CONV_WN, wn = warp % CONV_WN;
  const int g = lane >> 2, q = lane & 3;  // the mma fragment's row group / column pair
  const int t0 = blockIdx.y * BM, b = blockIdx.z;
  // this block's tiles: at least one (the launch sizes the cluster so)
  const int n_tiles = min(tiles, (Cout + CONV_BN - 1) / CONV_BN - (int)blockIdx.x * tiles);
  int n0 = blockIdx.x * tiles * CONV_BN;
  const bf16* xb = x + (size_t)b * T_len * Cin;
  const int n_chunks = (Cin + CONV_BK - 1) / CONV_BK;
  const int n_iter = n_chunks * K;  // (chunk, tap) pairs, taps fastest

  // one cp.async group per pair (empty past the end). The weights go to
  // slot it % CONV_STAGES; a chunk's input rows, with the chunk's first
  // tap, to slot chunk % CONV_STAGES, where all K taps read them. That slot
  // is refilled with pair (chunk + CONV_STAGES) * K, issued at iteration
  // (chunk + CONV_STAGES) * K - CONV_STAGES + 1: after the chunk's last
  // reader, iteration chunk * K + K - 1, for every K >= 1.
  auto issue = [&](int it) {
    if (it < n_iter) {
      const int j = it % K, ci0 = (it / K) * CONV_BK;
      if (j == 0) {
        // row r of the chunk is x[t0 - pad_lo + r]: tap j of step t0 + m reads row m + j*dil
        bf16* as = As + ((it / K) % CONV_STAGES) * A_ELEMS;
        for (int i = tid; i < A_ELEMS / A_LD * (CONV_BK / 8); i += CONV_NTH) {
          const int r = i / (CONV_BK / 8), c = (i % (CONV_BK / 8)) * 8;
          const int t = t0 - pad_lo + r;
          const bool row_ok = t >= 0 && t < T_len;
          const int n_ok = row_ok ? max(0, min(8, Cin - ci0 - c)) : 0;
          copy8(as + r * A_LD + c, xb + (size_t)(row_ok ? t : 0) * Cin + ci0 + c, x, n_ok, vec_x);
        }
      }
      bf16* bs = Bs + (it % CONV_STAGES) * B_ELEMS;
      // tap j's weights, input channels ci0.. x output channels n0.., as in w
      const int w_rows = min(CONV_BK, Cin - ci0);
      const bf16* wj = w + ((size_t)j * Cin + ci0) * Cout + n0;
      for (int i = tid; i < CONV_BK * (CONV_BN / 8); i += CONV_NTH) {
        const int r = i / (CONV_BN / 8), c = (i % (CONV_BN / 8)) * 8;
        const int n_ok = r < w_rows ? max(0, min(8, Cout - n0 - c)) : 0;
        copy8(bs + r * B_LD + c, wj + (size_t)r * Cout + c, w, n_ok, vec_w);
      }
    }
    cp_async_commit();
  };

  float acc[MT][NT8][4];
  const int r0 = wm * MT * 16;  // this warp's rows of the block's tile
  int c0 = 0;                   // and its first channel, of the tile in acc
  for (int ti = 0; ti < n_tiles; ++ti) {
    n0 = (blockIdx.x * tiles + ti) * CONV_BN;
    c0 = n0 + wn * NT8 * 8;
    if (ti > 0) __syncthreads();  // the last tile's readers of the ring are done
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    for (int it = 0; it < CONV_STAGES - 1; ++it) issue(it);
    for (int it = 0; it < n_iter; ++it) {
      cp_async_wait<CONV_STAGES - 2>();
      __syncthreads();  // pair it has landed; every reader of the slot refilled next is done
      issue(it + CONV_STAGES - 1);
      // tap it % K's rows of the chunk it / K
      const bf16* as = As + ((it / K) % CONV_STAGES) * A_ELEMS + (it % K) * dil * A_LD;
      const bf16* bs = Bs + (it % CONV_STAGES) * B_ELEMS;
#pragma unroll
      for (int kk = 0; kk < CONV_BK; kk += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(a[mt], as + (wm * MT * 16 + mt * 16 + (lane & 15)) * A_LD + kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT8 / 2; ++np) {
          // B[k][n] = w rows: .trans gives b0, b1 of n-tile 2np (regs 0, 1) and 2np + 1 (2, 3)
          uint32_t bb[4];
          ldsm_x4_t(bb, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * B_LD + wn * NT8 * 8 +
                            np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bb[0], bb[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
          }
        }
      }
    }
    cp_async_wait<0>();

    // epilogue. acc[mt][nt][i] is row wm*MT*16 + mt*16 + g + 8*(i >> 1),
    // column wn*NT8*8 + nt*8 + 2*q + (i & 1) of the block's tile
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = n0 + wn * NT8 * 8 + nt * 8 + 2 * q + e;
        const float bc = (bias != nullptr && co < Cout) ? __bfloat162float(bias[co]) : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = acc[mt][nt][2 * h + e] + bc;
            if (relu) v = v < 0.f ? 0.f : v;  // not fmaxf: NaN passes on, as in jnp.maximum
            if (LN) v = __bfloat162float(__float2bfloat16(v));
            acc[mt][nt][2 * h + e] = v;
          }
      }
    if (act != nullptr) store_mma_tile(act, acc, T_len, Cout, b, t0 + r0, c0, g, q);
    if (LN && ti + 1 < n_tiles) store_mma_tile(out, acc, T_len, Cout, b, t0 + r0, c0, g, q);
  }  // tiles
  if (LN) {
    // the value a parked tile (first channel cp of this warp's columns)
    // holds at fragment (mt, h, nt, e); this thread wrote it
    auto parked = [&](int cp, int mt, int h, int nt, int e) {
      const int t = t0 + r0 + mt * 16 + g + 8 * h, co = cp + nt * 8 + 2 * q + e;
      return (t < T_len && co < Cout)
                 ? __bfloat162float(out[((size_t)b * T_len + t) * Cout + co]) : 0.f;
    };
    const int c_first = blockIdx.x * tiles * CONV_BN + wn * NT8 * 8;
    // per-step sums over all Cout: in-thread, over the 4 threads of a row
    // group (shuffles), over the CONV_WN warps along Cout (shared memory),
    // then over the cluster's blocks (distributed shared memory)
    cg::cluster_group cluster = cg::this_cluster();
    const int ncl = gridDim.x;  // the cluster spans the grid's x axis
    const float inv_n = 1.f / (float)Cout;
    float mean[MT][2], rstd[MT][2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // this pass's term of one value of row (mt, h)
          auto term = [&](float v) {
            const float d = pass == 0 ? v : v - mean[mt][h];
            return pass == 0 ? d : d * d;
          };
          float s = 0.f;
          // the parked tiles' terms, then the tile in registers
          for (int ti = 0; ti + 1 < n_tiles; ++ti)
#pragma unroll
            for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int cp = c_first + ti * CONV_BN;
                s += cp + nt * 8 + 2 * q + e < Cout ? term(parked(cp, mt, h, nt, e)) : 0.f;
              }
#pragma unroll
          for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int co = c0 + nt * 8 + 2 * q + e;
              s += co < Cout ? term(acc[mt][nt][2 * h + e]) : 0.f;
            }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          if (q == 0) red[wn][r0 + mt * 16 + g + 8 * h] = s;
        }
      __syncthreads();
      if (tid < BM) {
        float s = 0.f;
        for (int k = 0; k < CONV_WN; ++k) s += red[k][tid];
        part[pass][tid] = s;
      }
      cluster.sync();  // every block's sums of this pass are written
      if (tid < BM) {
        float s = 0.f;
        for (int rank = 0; rank < ncl; ++rank) s += cluster.map_shared_rank(part[pass], rank)[tid];
        stat[tid] = s;
      }
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float st = stat[r0 + mt * 16 + g + 8 * h] * inv_n;
          if (pass == 0) mean[mt][h] = st;
          else rstd[mt][h] = 1.f / sqrtf(st + LN_EPS);
        }
      __syncthreads();  // stat and red are rewritten by the next pass
    }
    cluster.sync();  // no block exits (freeing its part[]) while another reads it
    for (int ti = 0; ti + 1 < n_tiles; ++ti) {
      const int cp = c_first + ti * CONV_BN;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = cp + nt * 8 + 2 * q + e;
          if (co >= Cout) continue;
          const float gm = __bfloat162float(ln_scale[co]), sh = __bfloat162float(ln_shift[co]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = t0 + r0 + mt * 16 + g + 8 * h;
              if (t >= T_len) continue;
              const float v = parked(cp, mt, h, nt, e);
              out[((size_t)b * T_len + t) * Cout + co] =
                  __float2bfloat16((v - mean[mt][h]) * rstd[mt][h] * gm + sh);
            }
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = c0 + nt * 8 + 2 * q + e;
        const float gm = co < Cout ? __bfloat162float(ln_scale[co]) : 0.f;
        const float sh = co < Cout ? __bfloat162float(ln_shift[co]) : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& v = acc[mt][nt][2 * h + e];
            v = (v - mean[mt][h]) * rstd[mt][h] * gm + sh;
          }
      }
  }
  store_mma_tile(out, acc, T_len, Cout, b, t0 + r0, c0, g, q);
}

template <int MT, bool LN>
cudaError_t launch_mma(const void* x, const void* w, const void* bias, const void* ln_scale,
                       const void* ln_shift, void* out, void* act, int B, int T_len, int Cin,
                       int Cout, int K, int dil, int relu, int cluster, int tiles,
                       cudaStream_t stream) {
  constexpr int BM = CONV_WM * MT * 16;
  static int configured = 48 * 1024;  // default dynamic shared memory limit
  const int span = (K - 1) * dil + 1;
  const int smem = CONV_STAGES * ((BM + span - 1) * A_LD + CONV_BK * B_LD) * (int)sizeof(bf16);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(conv_fwd_mma_kernel<MT, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(LN ? cluster : (Cout + CONV_BN - 1) / CONV_BN, (T_len + BM - 1) / BM, B);
  cfg.blockDim = dim3(CONV_NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = LN ? cluster : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec_x = Cin % 8 == 0 && aligned16(x), vec_w = Cout % 8 == 0 && aligned16(w);
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, conv_fwd_mma_kernel<MT, LN>, static_cast<const bf16*>(x),
      static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(ln_scale), static_cast<const bf16*>(ln_shift),
      static_cast<bf16*>(out), static_cast<bf16*>(act), T_len, Cin, Cout, K, dil,
      (span - 1) / 2, relu, vec_x, vec_w, LN ? tiles : 1);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// bm: the block's time steps (128, 64 or 32); cluster: with LayerNorm, the
// blocks that share Cout: each takes tiles = ceil(n / 8) of the n =
// ceil(Cout / 128) channel tiles, and the cluster is ceil(n / tiles) <= 8.
// Both are chosen by the caller (ops/fused_conv.py::conv_plan).
cudaError_t dispatch_mma(const void* x, const void* w, const void* bias, const void* ln_scale,
                         const void* ln_shift, void* out, void* act, int B, int T_len,
                         int Cin, int Cout, int K, int dil, int relu, int bm, int cluster,
                         cudaStream_t s) {
  const bool ln = ln_scale != nullptr;
  const int n = (Cout + CONV_BN - 1) / CONV_BN, tiles = (n + MAX_CLUSTER - 1) / MAX_CLUSTER;
  if (ln && cluster != (n + tiles - 1) / tiles) return cudaErrorInvalidValue;
  switch (bm * 2 + (ln ? 1 : 0)) {
    case 256: return launch_mma<4, false>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, cluster, tiles, s);
    case 257: return launch_mma<4, true>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, cluster, tiles, s);
    case 128: return launch_mma<2, false>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, cluster, tiles, s);
    case 129: return launch_mma<2, true>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, cluster, tiles, s);
    case 64: return launch_mma<1, false>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, cluster, tiles, s);
    case 65: return launch_mma<1, true>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, cluster, tiles, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias may be null; ln_scale / ln_shift
// null means no LayerNorm. act (null unless wanted) takes the rounded
// post-ReLU, pre-LN activation, and is taken only with LayerNorm. bm and
// cluster shape the bfloat16 launch (see dispatch_mma); float32 ignores them.
extern "C" int fused_conv1d_fwd(const void* x, const void* w, const void* bias,
                                const void* ln_scale, const void* ln_shift, void* out,
                                void* act, int B, int T_len, int Cin, int Cout, int K,
                                int dil, int relu, int bm, int cluster, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = ln_scale != nullptr;
  if (act != nullptr && !ln) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0)
    e = ln ? dispatch_cpt<true>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, s)
           : dispatch_cpt<false>(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, s);
  else if (dtype == 1)
    e = dispatch_mma(x, w, bias, ln_scale, ln_shift, out, act, B, T_len, Cin, Cout, K, dil, relu, bm, cluster, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
