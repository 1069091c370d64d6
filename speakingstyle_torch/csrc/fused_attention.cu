// Masked multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel speakingstyle_tpu/ops/pallas_attention.py::_fwd_kernel
// (launched by _pallas_fwd, reached through fused_mha). It computes the same
// function: out = softmax(q k^T * sm_scale + bias) v per (batch, head), with
// the key-padding bias finfo(f32).min / 2, scores and softmax in f32, the
// probabilities rounded to v's dtype before the PV product, and f32
// accumulation.
//
// Design. The TPU kernel keeps a whole f32 T x T score tile in VMEM; at
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
// work is ~4 T^2 D flops per (b, h) against ~4 T D elements of traffic, so
// the kernel is bound by arithmetic. This first version does the products
// with FMA on the CUDA cores (4 x 4 register tiles fed from padded,
// transposed shared-memory tiles, conflict-free); moving them to mma.sync /
// wgmma is the next step for speed.
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

// q, k, v, out: [B, L, H, D] contiguous; mask: [B, L] bytes, nonzero at padding.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, T* __restrict__ out, int L, int H, int D,
    float sm_scale) {
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

  // valid key length: one past the last unpadded key (0: every key padded)
  if (tid == 0) kv_len_s = 0;
  __syncthreads();
  int last = 0;
  for (int j = tid; j < L; j += NT)
    if (!mb[j]) last = j + 1;
  for (int o = 16; o; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if ((tid & 31) == 0) atomicMax(&kv_len_s, last);

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
  const int k_end = kv_len_s > 0 ? kv_len_s : L;

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
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* out, int B, int L, int H, int D, float sm_scale,
                   cudaStream_t stream) {
  static int configured = 0;  // dynamic shared memory opted into so far
  const int smem = (2 * D * TS + BK * D + BQ * PS + 3 * BQ) * (int)sizeof(float);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((L + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<T, DMAX><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), L, H, D, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* mask,
                       void* out, int B, int L, int H, int D, float sm_scale,
                       cudaStream_t stream) {
  if (D <= 32) return launch<T, 32>(q, k, v, mask, out, B, L, H, D, sm_scale, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, mask, out, B, L, H, D, sm_scale, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, mask, out, B, L, H, D, sm_scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int fused_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int B, int L, int H,
                                   int D, float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float>(q, k, v, mask, out, B, L, H, D, sm_scale, s);
  else if (dtype == 1)
    e = dispatch_d<__nv_bfloat16>(q, k, v, mask, out, B, L, H, D, sm_scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
