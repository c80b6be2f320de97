// flash_attention on the CUDA cores: blocked online-softmax attention with
// native GQA, for f32 and for bf16 at head widths other than 64, 128, 160
// and 256.
//
// Replaces the Pallas kernel flash_attention (src/repro/kernels/
// flash_attention/kernel.py:73), whose grid walks (head, q block, k block)
// in order and carries the softmax state in VMEM scratch between k steps.
// The wrapper (kernels/flash_attention/kernel.py, route()) sends bf16 at
// D 64, 128, 160 and 256 to the tensor-core kernel of
// flash_attention_mma.cuh and everything else here.  One thread block owns
// one (query head, 64-row Q tile) and walks the K/V tiles itself; blocks
// run in any order.
//
//   q [BH, S, D], k/v [BHkv, S, D] (float or bf16), o [BH, S, D] in q's type.
//   The KV head of query head bh is bh / group: K and V are never repeated.
//
// Layout: 4 threads per query row (FA_P), 64 rows per block (FA_BQ), 256
// threads.  A thread holds its row's q and f32 accumulator for the float4
// chunks part, part+4, part+8, ... of the head (DMAX / 16 chunks), so the
// four threads of a row read four neighbouring float4s of a shared-memory
// K/V row (no bank conflict).  A score is the sum of the four partial dots
// (two xor shuffles).  K/V tiles of 64 keys are staged in shared memory as
// f32 (2 * 64 * DMAX * 4 bytes, dynamic).  The running max m, denominator
// l and accumulator stay in f32 registers; the state is rescaled once per
// chunk of 16 keys.
//
// Semantics kept from the TPU kernel: masked scores are -1e30 (not -inf),
// the output is acc / max(l, 1e-30), cast to q's type.  Keys beyond S (the
// ragged last tile) are -inf and add exactly nothing.  Under `causal` the
// K tiles wholly above the diagonal are skipped: there p would be 0 and
// alpha 1, since key 0 is always visible and m is finite from the first
// tile on.
//
// Bound on the H100: operations.  S^2 * D * 4 flops per head (half under
// causal) against q/k/v/o read once.  The dots run as f32 fmaf on the CUDA
// cores (67 TFLOP/s in f32), so this kernel stays far above the bf16
// tensor-core bound; it serves the route's other dtypes and widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FA_NEG_INF (-1e30f)
#define FA_BQ 64
#define FA_BK 64
#define FA_P 4
#define FA_CHUNK 16
#define FA_THREADS (FA_BQ * FA_P)

__device__ __forceinline__ float fa_to_f(float x) { return x; }
__device__ __forceinline__ float fa_to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T fa_from_f(float x);
template <> __device__ __forceinline__ float fa_from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
fa_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// fmaf by name: the units build with --fmad=false (cuda_build.py), which
// stops nvcc from fusing a*b+c on its own but leaves an explicit fmaf one
// instruction.  The plain version's sums round differently anyway; the
// two are compared at the output's rounding.
__device__ __forceinline__ float fa_dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(FA_THREADS)
flare_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int S, int d,
                   int group, int causal, float scale) {
  constexpr int C4 = DMAX / 4;          // float4 chunks per head row
  constexpr int NC = C4 / FA_P;         // chunks per thread
  extern __shared__ float4 fa_smem[];
  float4* ks = fa_smem;                 // [FA_BK][C4]
  float4* vs = fa_smem + FA_BK * C4;    // [FA_BK][C4]

  const int bh = blockIdx.y;
  // heavy (late) causal tiles first: they take the longest
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const int row = threadIdx.x / FA_P, part = threadIdx.x % FA_P;
  const int qi = q0 + row;
  const long long kv_base = (long long)(bh / group) * S;

  float4 qr[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d0 = (part + FA_P * c) * 4;
    float t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      t[e] = (qi < S && d0 + e < d)
                 ? fa_to_f(q[((long long)bh * S + qi) * d + d0 + e])
                 : 0.f;
    qr[c] = make_float4(t[0], t[1], t[2], t[3]);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = FA_NEG_INF, l = 0.f;

  const int k_end = causal ? min(S, q0 + FA_BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();
    float* kf = reinterpret_cast<float*>(ks);
    float* vf = reinterpret_cast<float*>(vs);
    for (int idx = threadIdx.x; idx < FA_BK * DMAX; idx += FA_THREADS) {
      const int r = idx / DMAX, col = idx % DMAX, kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < S && col < d) {
        const long long off = (kv_base + kp) * d + col;
        kv = fa_to_f(k[off]);
        vv = fa_to_f(v[off]);
      }
      kf[idx] = kv;
      vf[idx] = vv;
    }
    __syncthreads();
    for (int j0 = 0; j0 < FA_BK; j0 += FA_CHUNK) {
      float s[FA_CHUNK];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < FA_CHUNK; ++jj) {
        const float4* kr = ks + (j0 + jj) * C4;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) dot = fa_dot4(qr[c], kr[part + FA_P * c], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int kp = k0 + j0 + jj;
        float sv = dot * scale;
        if (kp >= S) sv = -INFINITY;
        else if (causal && kp > qi) sv = FA_NEG_INF;
        s[jj] = sv;
        cmax = fmaxf(cmax, sv);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[c].x *= alpha; acc[c].y *= alpha;
        acc[c].z *= alpha; acc[c].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < FA_CHUNK; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float4* vr = vs + (j0 + jj) * C4;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = vr[part + FA_P * c];
          acc[c].x = fmaf(p, vv.x, acc[c].x);
          acc[c].y = fmaf(p, vv.y, acc[c].y);
          acc[c].z = fmaf(p, vv.z, acc[c].z);
          acc[c].w = fmaf(p, vv.w, acc[c].w);
        }
      }
      m = m_new;
    }
  }
  if (qi >= S) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d0 = (part + FA_P * c) * 4;
    const float t[4] = {acc[c].x, acc[c].y, acc[c].z, acc[c].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d0 + e < d)
        o[((long long)bh * S + qi) * d + d0 + e] = fa_from_f<T>(t[e] / denom);
  }
}

template <typename T, int DMAX>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     int bh, int S, int d, int group, int causal, float scale,
                     cudaStream_t s) {
  const size_t smem = 2 * (size_t)FA_BK * DMAX * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flare_flash_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + FA_BQ - 1) / FA_BQ, bh);
  flare_flash_kernel<T, DMAX><<<grid, FA_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, d, group, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int fa_dispatch(const void* q, const void* k, const void* v, void* o,
                       int bh, int S, int d, int group, int causal,
                       float scale, cudaStream_t s) {
  if (d <= 16) return fa_launch<T, 16>(q, k, v, o, bh, S, d, group, causal, scale, s);
  if (d <= 32) return fa_launch<T, 32>(q, k, v, o, bh, S, d, group, causal, scale, s);
  if (d <= 64) return fa_launch<T, 64>(q, k, v, o, bh, S, d, group, causal, scale, s);
  if (d <= 128) return fa_launch<T, 128>(q, k, v, o, bh, S, d, group, causal, scale, s);
  if (d <= 256) return fa_launch<T, 256>(q, k, v, o, bh, S, d, group, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16.  bh query heads, bhkv KV heads.
extern "C" int flare_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh, int bhkv,
                                     int S, int d, int causal, float scale,
                                     int dtype, void* stream) {
  if (bh <= 0 || bhkv <= 0 || bh % bhkv != 0 || S <= 0 || d < 1 || d > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = bh / bhkv;
  if (dtype == 0)
    return fa_dispatch<float>(q, k, v, o, bh, S, d, group, causal, scale, s);
  if (dtype == 1)
    return fa_dispatch<__nv_bfloat16>(q, k, v, o, bh, S, d, group, causal,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
