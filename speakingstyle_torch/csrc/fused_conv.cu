// Fused SAME-padded conv1d (+bias, +ReLU, +channel LayerNorm) forward for
// Hopper (sm_90a).
//
// Replaces the TPU kernel speakingstyle_tpu/ops/pallas_conv.py::_kernel
// (launched by _fused_fwd_pallas, reached through fused_conv1d and
// fused_conv_relu_ln). It computes the same function:
//   y[t, o] = bias[o] + sum_j sum_c x[t + j*dil - pad_lo, c] * w[j, c, o]
// accumulated in f32 (x zero outside [0, T)), then ReLU if asked, then, with
// LayerNorm, the activation rounded to the storage dtype first and mean /
// variance (eps 1e-5) taken over all Cout channels of each time step before
// the affine; one write of the result in the storage dtype.
//
// Design: an implicit GEMM, M = time steps, N = Cout, reduction over the K
// taps and Cin. A block owns a tile of time steps of one batch row and a
// range of output channels. The input halo of its steps,
// [rows + (K-1)*dil, 32-channel chunk], is staged in shared memory once per
// channel chunk and read by all K taps from there (tap j reads the halo
// shifted by j*dil rows), so the im2col matrix is never formed. The
// LayerNorm variant needs a block to own whole Cout rows (Cout <= 1024), and
// the mean / variance are block reductions in the epilogue, before the
// single store.
//
// Bound on the H100: at the model's shapes (Cin, Cout up to 1024, K up to 9,
// B*T in the thousands) a conv does 2*B*T*K*Cin*Cout flops on a few MB, so it
// is bound by arithmetic. Two kernels, chosen by the storage dtype:
//
// * bfloat16 (the model's compute dtype): the products run on the tensor
//   cores, mma.sync m16n8k16 with f32 accumulators in registers. Each tap's
//   [32 Cin x block Cout] weight tile is staged in shared memory transposed
//   (Cout-major, Cin contiguous) so that every A and B fragment is a 32-bit
//   shared-memory load; row strides are padded to 40 elements, which makes
//   those loads free of bank conflicts. Without LayerNorm a block is
//   64 steps x 128 channels (8 warps, 32 x 32 each), or 32 x 128 where
//   64-step tiles would leave SMs idle; with LayerNorm it is 16 steps x all
//   Cout channels (8 warps side by side along Cout). Halo and weights are
//   staged with 16-byte loads where Cin (halo) or Cout (weights) is a
//   multiple of 8.
// * float32: f32 FMA on the CUDA cores, which keeps full f32 products (the
//   tensor cores would round the inputs to TF32). A block owns 16 steps and
//   256 * CPT channels, one thread per channel, 16 x CPT accumulators each.
//
// Neither pipelines its loads (cp.async / TMA) nor uses wgmma yet: those are
// the next steps for speed.
//
// C interface (loaded with ctypes): returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// x: [B, T, Cin]; w: [K, Cin, Cout]; bias, ln_scale, ln_shift: [Cout] (bias
// may be null); out: [B, T, Cout]. All contiguous float32.
template <int CPT, bool LN>
__global__ void __launch_bounds__(NT) conv_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_shift,
    float* __restrict__ out, int T_len, int Cin, int Cout, int K, int dil, int pad_lo, int relu) {
  extern __shared__ float4 halo4[];  // [rows][BCI / 4]
  float* halo = reinterpret_cast<float*>(halo4);
  __shared__ float red[NT / 32][BT];
  __shared__ float stat[BT];

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT;
  const int b = blockIdx.z;
  const int rows = BT + (K - 1) * dil;
  const float* xb = x + (size_t)b * T_len * Cin;

  int co[CPT];
  bool co_ok[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    co[c] = blockIdx.y * (NT * CPT) + tid + NT * c;
    co_ok[c] = co[c] < Cout;
  }
  float acc[BT][CPT];
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

  // epilogue: bias, ReLU, then (LN) stats and affine (rounding the
  // activation to the storage dtype first is the identity in float32)
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const float bc = (bias != nullptr && co_ok[c]) ? bias[co[c]] : 0.f;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      float v = acc[r][c] + bc;
      if (relu) v = fmaxf(v, 0.f);
      acc[r][c] = v;
    }
  }
  if (LN) {
    const float inv_n = 1.f / (float)Cout;
    float part[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      part[r] = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) part[r] += co_ok[c] ? acc[r][c] : 0.f;
    }
    block_row_sums(part, stat, red);
    float mean[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) mean[r] = stat[r] * inv_n;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      part[r] = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float d = acc[r][c] - mean[r];
        part[r] += co_ok[c] ? d * d : 0.f;
      }
    }
    block_row_sums(part, stat, red);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float rstd = 1.f / sqrtf(stat[r] * inv_n + LN_EPS);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float g = co_ok[c] ? ln_scale[co[c]] : 0.f;
        const float s = co_ok[c] ? ln_shift[co[c]] : 0.f;
        acc[r][c] = (acc[r][c] - mean[r]) * rstd * g + s;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int t = t0 + r;
    if (t >= T_len) break;
    float* orow = out + ((size_t)b * T_len + t) * Cout;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (co_ok[c]) orow[co[c]] = acc[r][c];
  }
}

template <int CPT, bool LN>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* ln_scale,
                   const void* ln_shift, void* out, int B, int T_len, int Cin, int Cout,
                   int K, int dil, int relu, cudaStream_t stream) {
  static int configured = 48 * 1024;  // default dynamic shared memory limit
  const int span = (K - 1) * dil + 1;
  const int smem = (BT + span - 1) * BCI * (int)sizeof(float);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(conv_fwd_kernel<CPT, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((T_len + BT - 1) / BT, (Cout + NT * CPT - 1) / (NT * CPT), B);
  conv_fwd_kernel<CPT, LN><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_shift), static_cast<float*>(out), T_len, Cin, Cout, K, dil, (span - 1) / 2, relu);
  return cudaGetLastError();
}

template <bool LN>
cudaError_t dispatch_cpt(const void* x, const void* w, const void* bias,
                         const void* ln_scale, const void* ln_shift, void* out, int B,
                         int T_len, int Cin, int Cout, int K, int dil, int relu,
                         cudaStream_t s) {
  // channels per thread: enough for one block to cover Cout up to 1024
  const int cpt = min(4, (Cout + NT - 1) / NT);
  if (LN && Cout > NT * 4) return cudaErrorInvalidValue;
  switch (cpt) {
    case 1: return launch<1, LN>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
    case 2: return launch<2, LN>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
    case 3: return launch<3, LN>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
    default: return launch<4, LN>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
  }
}

// ---------------------------------------------------------------- bfloat16, tensor cores

using bf16 = __nv_bfloat16;
constexpr int MMA_BK = 32;            // input channels per staged chunk: two k16 steps
constexpr int MMA_LD = MMA_BK + 8;    // padded row stride (elements) of both smem tiles
constexpr int MMA_WARPS = 8;

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);  // p[0] in the low half
}

// c += a (16x16, row-major) * b (16x8, col-major); bf16 inputs, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same contract as conv_fwd_kernel, for bfloat16 tensors. Warps form a
// WM x WN grid; each owns MT 16-row and NT8 8-column mma tiles, so a block
// covers BM = WM*MT*16 steps and BN = WN*NT8*8 channels. With LN the block
// must cover all of Cout (gridDim.y == 1).
template <int WM, int WN, int MT, int NT8, bool LN>
__global__ void __launch_bounds__(WM * WN * 32) conv_fwd_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    const bf16* __restrict__ ln_scale, const bf16* __restrict__ ln_shift,
    bf16* __restrict__ out, int T_len, int Cin, int Cout, int K, int dil, int pad_lo,
    int relu, int vec_x, int vec_w) {
  constexpr int NTH = WM * WN * 32;
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT8 * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = BM + (K - 1) * dil;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [rows][MMA_LD]: the halo chunk
  bf16* ws = xs + rows * MMA_LD;                  // [BN][MMA_LD]: one tap's weights, Cout-major
  __shared__ float red[WN][BM];
  __shared__ float stat[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, q = lane & 3;  // the mma fragment's row group / column pair
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const bf16* xb = x + (size_t)b * T_len * Cin;
  const bf16 zero = __float2bfloat16(0.f);

  float acc[MT][NT8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += MMA_BK) {
    __syncthreads();  // the previous chunk's readers are done
    if (vec_x) {  // 16-byte loads and stores: 8 channels of one step
      for (int i = tid; i < rows * (MMA_BK / 8); i += NTH) {
        const int r = i / (MMA_BK / 8), c = (i % (MMA_BK / 8)) * 8;
        const int t = t0 - pad_lo + r, ci = ci0 + c;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (t >= 0 && t < T_len && ci < Cin)
          v = *reinterpret_cast<const uint4*>(xb + (size_t)t * Cin + ci);
        *reinterpret_cast<uint4*>(xs + r * MMA_LD + c) = v;
      }
    } else {
      for (int i = tid; i < rows * MMA_BK; i += NTH) {
        const int r = i / MMA_BK, c = i % MMA_BK;
        const int t = t0 - pad_lo + r, ci = ci0 + c;
        xs[r * MMA_LD + c] = (t >= 0 && t < T_len && ci < Cin) ? xb[(size_t)t * Cin + ci] : zero;
      }
    }
    for (int j = 0; j < K; ++j) {
      if (j > 0) __syncthreads();  // the previous tap's readers of ws are done
      const bf16* wj = w + ((size_t)j * Cin + ci0) * Cout + n0;
      if (vec_w) {
        // a thread takes input channels (2p, 2p+1) x 8 output channels: two
        // 16-byte loads, eight 32-bit transposed stores. p runs fastest, so
        // a warp's stores land in distinct banks (2-way at worst) and each
        // weight row's 32-byte sector is read whole.
        for (int i = tid; i < (MMA_BK / 2) * (BN / 8); i += NTH) {
          const int p = i % (MMA_BK / 2), n = (i / (MMA_BK / 2)) * 8;
          const int k = 2 * p;
          uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
          if (n0 + n < Cout) {
            if (ci0 + k < Cin) lo = *reinterpret_cast<const uint4*>(wj + (size_t)k * Cout + n);
            if (ci0 + k + 1 < Cin)
              hi = *reinterpret_cast<const uint4*>(wj + (size_t)(k + 1) * Cout + n);
          }
          const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w}, h[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            // channel n+2u from the low halves, n+2u+1 from the high halves
            *reinterpret_cast<uint32_t*>(ws + (n + 2 * u) * MMA_LD + k) =
                (l[u] & 0xffffu) | (h[u] << 16);
            *reinterpret_cast<uint32_t*>(ws + (n + 2 * u + 1) * MMA_LD + k) =
                (l[u] >> 16) | (h[u] & 0xffff0000u);
          }
        }
      } else {
        for (int i = tid; i < MMA_BK * BN; i += NTH) {
          const int k = i / BN, n = i % BN;  // n fastest: coalesced reads along Cout
          ws[n * MMA_LD + k] =
              (ci0 + k < Cin && n0 + n < Cout) ? wj[(size_t)k * Cout + n] : zero;
        }
      }
      __syncthreads();
      const bf16* xa = xs + j * dil * MMA_LD;  // tap j's rows of the halo
#pragma unroll
      for (int kk = 0; kk < MMA_BK; kk += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const bf16* pa = xa + (wm * MT * 16 + mt * 16 + g) * MMA_LD + kk + 2 * q;
          a[mt][0] = ld_pair(pa);
          a[mt][1] = ld_pair(pa + 8 * MMA_LD);
          a[mt][2] = ld_pair(pa + 8);
          a[mt][3] = ld_pair(pa + 8 * MMA_LD + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          const bf16* pb = ws + (wn * NT8 * 8 + nt * 8 + g) * MMA_LD + kk + 2 * q;
          const uint32_t b0 = ld_pair(pb), b1 = ld_pair(pb + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
        }
      }
    }
  }

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
          if (relu) v = fmaxf(v, 0.f);
          if (LN) v = __bfloat162float(__float2bfloat16(v));
          acc[mt][nt][2 * h + e] = v;
        }
    }
  if (LN) {
    // per-row sums over all Cout: in-thread, over the 4 threads of a row
    // group (shuffles), then over the WN warps along Cout (shared memory)
    const float inv_n = 1.f / (float)Cout;
    float mean[MT][2], rstd[MT][2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int co = n0 + wn * NT8 * 8 + nt * 8 + 2 * q + e;
              const float v = acc[mt][nt][2 * h + e];
              const float d = pass == 0 ? v : v - mean[mt][h];
              s += co < Cout ? (pass == 0 ? d : d * d) : 0.f;
            }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          if (q == 0) red[wn][wm * MT * 16 + mt * 16 + g + 8 * h] = s;
        }
      __syncthreads();
      if (tid < BM) {
        float s = 0.f;
        for (int k = 0; k < WN; ++k) s += red[k][tid];
        stat[tid] = s;
      }
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float st = stat[wm * MT * 16 + mt * 16 + g + 8 * h] * inv_n;
          if (pass == 0) mean[mt][h] = st;
          else rstd[mt][h] = 1.f / sqrtf(st + LN_EPS);
        }
      __syncthreads();  // stat and red are rewritten by the next pass
    }
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = n0 + wn * NT8 * 8 + nt * 8 + 2 * q + e;
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
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm * MT * 16 + mt * 16 + g + 8 * h;
      if (t >= T_len) continue;
      bf16* orow = out + ((size_t)b * T_len + t) * Cout;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn * NT8 * 8 + nt * 8 + 2 * q + e;
          if (co < Cout) orow[co] = __float2bfloat16(acc[mt][nt][2 * h + e]);
        }
    }
}

template <int WM, int WN, int MT, int NT8, bool LN>
cudaError_t launch_mma(const void* x, const void* w, const void* bias, const void* ln_scale,
                       const void* ln_shift, void* out, int B, int T_len, int Cin, int Cout,
                       int K, int dil, int relu, cudaStream_t stream) {
  constexpr int BM = WM * MT * 16, BN = WN * NT8 * 8;
  static int configured = 48 * 1024;  // default dynamic shared memory limit
  const int span = (K - 1) * dil + 1;
  const int smem = (BM + span - 1 + BN) * MMA_LD * (int)sizeof(bf16);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(conv_fwd_mma_kernel<WM, WN, MT, NT8, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((T_len + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  conv_fwd_mma_kernel<WM, WN, MT, NT8, LN><<<grid, WM * WN * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(ln_scale), static_cast<const bf16*>(ln_shift),
      static_cast<bf16*>(out), T_len, Cin, Cout, K, dil, (span - 1) / 2, relu,
      Cin % 8 == 0 && aligned16(x), Cout % 8 == 0 && aligned16(w));
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* x, const void* w, const void* bias, const void* ln_scale,
                         const void* ln_shift, void* out, int B, int T_len, int Cin,
                         int Cout, int K, int dil, int relu, cudaStream_t s) {
  if (ln_scale == nullptr) {
    // 64 steps x 128 channels (2 x 4 warps of 32 x 32); where that leaves
    // SMs idle, 32 steps x 128 channels (2 x 4 warps of 16 x 32)
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
    }
    const long tiles64 = (long)((T_len + 63) / 64) * ((Cout + 127) / 128) * B;
    if (tiles64 >= sms)
      return launch_mma<2, 4, 2, 4, false>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
    return launch_mma<2, 4, 1, 4, false>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
  }
  // LayerNorm: 16 steps x all Cout, the 8 warps side by side along Cout
  if (Cout <= 128)
    return launch_mma<1, MMA_WARPS, 1, 2, true>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
  if (Cout <= 256)
    return launch_mma<1, MMA_WARPS, 1, 4, true>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
  if (Cout <= 512)
    return launch_mma<1, MMA_WARPS, 1, 8, true>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
  if (Cout <= 1024)
    return launch_mma<1, MMA_WARPS, 1, 16, true>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias may be null; ln_scale / ln_shift
// null means no LayerNorm.
extern "C" int fused_conv1d_fwd(const void* x, const void* w, const void* bias,
                                const void* ln_scale, const void* ln_shift, void* out,
                                int B, int T_len, int Cin, int Cout, int K, int dil,
                                int relu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = ln_scale != nullptr;
  cudaError_t e;
  if (dtype == 0)
    e = ln ? dispatch_cpt<true>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s)
           : dispatch_cpt<false>(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
  else if (dtype == 1)
    e = dispatch_mma(x, w, bias, ln_scale, ln_shift, out, B, T_len, Cin, Cout, K, dil, relu, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
