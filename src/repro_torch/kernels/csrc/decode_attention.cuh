// decode_attention: one new query token per sequence against its KV cache.
//
// Replaces the Pallas kernel decode_attention (src/repro/kernels/
// decode_attention/kernel.py), whose grid walks (batch * kv head, k block)
// in order and carries the softmax state for the group's packed query
// heads in VMEM.  On the H100 the op is bound by the cache stream (bytes),
// and batch * kv heads (64 at the serving shapes) is fewer than the 132
// SMs, so the cache is split over warps instead (flash-decoding):
//
//   pass 1: each warp owns `keys_per_part` consecutive keys of one
//           (sequence, kv head) and all `group` query heads that share it;
//           it writes its partial (m, l, acc[group][D]) in f32;
//   pass 2: one block per (sequence, kv head) folds the parts:
//           M = max m_p, L = sum l_p e^(m_p - M), A = sum acc_p e^(m_p - M),
//           out = A / max(L, 1e-30), cast to q's type.
//
// In pass 1 a lane owns one key of each 32-key step for the scores (it
// reads the key's row with 16-byte loads; the queries sit in shared memory
// as f32), and one or more head dims for P.V (lane-wide rows of V, one
// coalesced load per key; p is broadcast by shuffle).
//
//   q [BHkv, group, D], k/v [BHkv, S, D] (float or bf16), lengths [B] int32
//   (the same length for the hkv heads of a sequence), o [BHkv, group, D].
//
// Masking follows the TPU kernel: position pos is valid iff pos < length,
// and an invalid score is -1e30.  With length >= 1 the keys at or beyond
// length add exactly 0 (e^(-1e30 - m) underflows once m is finite), so a
// warp reads only keys below min(length, S); a warp with none writes
// m = -inf, l = 0, which pass 2 weighs by exactly 0.  With length 0 every
// score is -1e30 and every key has p = 1: the output is the mean of V over
// all S, as in the TPU kernel and the reference; then all keys are read.
//
// The dots and P.V call fmaf by name: the unit builds with --fmad=false
// (cuda_build.py), which leaves an explicit fmaf one instruction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define DA_NEG_INF (-1e30f)
#define DA_WARPS 4

__device__ __forceinline__ float da_to_f(float x) { return x; }
__device__ __forceinline__ float da_to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T da_from_f(float x);
template <> __device__ __forceinline__ float da_from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
da_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// unpack one 16-byte vector of a key row into f32
__device__ __forceinline__ void da_unpack(const uint4& u, float* f,
                                          const float*) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void da_unpack(const uint4& u, float* f,
                                          const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float da_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float da_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int G, int DMAX>
__global__ void __launch_bounds__(DA_WARPS * 32)
flare_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ lengths, int hkv, int group,
                     int S, int d, float scale, int keys_per_part,
                     int n_parts, float* __restrict__ part_m,
                     float* __restrict__ part_l,
                     float* __restrict__ part_acc) {
  constexpr int DPL = DMAX / 32;               // head dims per lane
  constexpr int EPV = 16 / sizeof(T);          // elements per 16-byte load
  __shared__ float qs[G][DMAX];
  const int bkv = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < G * DMAX; i += blockDim.x) {
    const int g = i / DMAX, c = i % DMAX;
    qs[g][c] = (g < group && c < d)
                   ? da_to_f(q[((long long)bkv * group + g) * d + c])
                   : 0.f;
  }
  __syncthreads();

  const int part = blockIdx.x * DA_WARPS + warp;
  if (part >= n_parts) return;
  int len = lengths[bkv / hkv];
  len = min(max(len, 0), S);
  const bool none_valid = (len == 0);
  const int start = part * keys_per_part;
  const int end = min(start + keys_per_part, none_valid ? S : len);

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = (start < end) ? DA_NEG_INF : -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }
  const long long base = (long long)bkv * S;
  const int n_vec = d / EPV;
  for (int k0 = start; k0 < end; k0 += 32) {
    const int key = k0 + lane;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (key < end) {
      const uint4* row = reinterpret_cast<const uint4*>(k + (base + key) * d);
      for (int c = 0; c < n_vec; ++c) {
        float f[EPV];
        da_unpack(__ldg(row + c), f, (const T*)nullptr);
#pragma unroll
        for (int e = 0; e < EPV; ++e)
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] = fmaf(qs[g][c * EPV + e], f[e], s[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = none_valid ? DA_NEG_INF : s[g] * scale;
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = -INFINITY;
    }
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= group) continue;
      const float m_new = fmaxf(m[g], da_warp_max(s[g]));
      const float alpha = expf(m[g] - m_new);
      p[g] = expf(s[g] - m_new);
      l[g] = l[g] * alpha + da_warp_sum(p[g]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
      m[g] = m_new;
    }
    const int n_keys = min(32, end - k0);
    for (int j = 0; j < n_keys; ++j) {
      const T* vrow = v + (base + k0 + j) * d;
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        vv[i] = c < d ? da_to_f(vrow[c]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= group) continue;
        const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pj, vv[i], acc[g][i]);
      }
    }
  }
  const long long slot = (long long)bkv * n_parts + part;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= group) continue;
    if (lane == 0) {
      part_m[slot * group + g] = m[g];
      part_l[slot * group + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      if (c < d) part_acc[(slot * group + g) * d + c] = acc[g][i];
    }
  }
}

template <typename T>
__global__ void flare_decode_combine(const float* __restrict__ part_m,
                                     const float* __restrict__ part_l,
                                     const float* __restrict__ part_acc,
                                     int group, int d, int n_parts,
                                     T* __restrict__ o) {
  const int bkv = blockIdx.x;
  for (int i = threadIdx.x; i < group * d; i += blockDim.x) {
    const int g = i / d, c = i % d;
    float M = -INFINITY;
    for (int p = 0; p < n_parts; ++p)
      M = fmaxf(M, part_m[((long long)bkv * n_parts + p) * group + g]);
    float L = 0.f, A = 0.f;
    for (int p = 0; p < n_parts; ++p) {
      const long long slot = ((long long)bkv * n_parts + p) * group + g;
      const float w = expf(part_m[slot] - M);
      L += part_l[slot] * w;
      A += part_acc[slot * d + c] * w;
    }
    o[((long long)bkv * group + g) * d + c] = da_from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int G, int DMAX>
static int da_launch(const void* q, const void* k, const void* v,
                     const int* lengths, void* o, int bhkv, int hkv,
                     int group, int S, int d, float scale, int keys_per_part,
                     float* part_m, float* part_l, float* part_acc,
                     cudaStream_t s) {
  const int n_parts = (S + keys_per_part - 1) / keys_per_part;
  dim3 grid((n_parts + DA_WARPS - 1) / DA_WARPS, bhkv);
  flare_decode_partial<T, G, DMAX><<<grid, DA_WARPS * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, hkv, group, S, d, scale,
      keys_per_part, n_parts, part_m, part_l, part_acc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flare_decode_combine<T><<<bhkv, 256, 0, s>>>(part_m, part_l, part_acc,
                                                group, d, n_parts,
                                                static_cast<T*>(o));
  return (int)cudaGetLastError();
}

template <typename T, int G>
static int da_by_d(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int bhkv, int hkv, int group,
                   int S, int d, float scale, int kpp, float* pm, float* pl,
                   float* pa, cudaStream_t s) {
  if (d <= 64) return da_launch<T, G, 64>(q, k, v, lengths, o, bhkv, hkv, group, S, d, scale, kpp, pm, pl, pa, s);
  if (d <= 128) return da_launch<T, G, 128>(q, k, v, lengths, o, bhkv, hkv, group, S, d, scale, kpp, pm, pl, pa, s);
  if (d <= 256) return da_launch<T, G, 256>(q, k, v, lengths, o, bhkv, hkv, group, S, d, scale, kpp, pm, pl, pa, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int da_by_group(const void* q, const void* k, const void* v,
                       const int* lengths, void* o, int bhkv, int hkv,
                       int group, int S, int d, float scale, int kpp,
                       float* pm, float* pl, float* pa, cudaStream_t s) {
  if (group <= 1) return da_by_d<T, 1>(q, k, v, lengths, o, bhkv, hkv, group, S, d, scale, kpp, pm, pl, pa, s);
  if (group <= 2) return da_by_d<T, 2>(q, k, v, lengths, o, bhkv, hkv, group, S, d, scale, kpp, pm, pl, pa, s);
  if (group <= 4) return da_by_d<T, 4>(q, k, v, lengths, o, bhkv, hkv, group, S, d, scale, kpp, pm, pl, pa, s);
  if (group <= 8) return da_by_d<T, 8>(q, k, v, lengths, o, bhkv, hkv, group, S, d, scale, kpp, pm, pl, pa, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16.  keys_per_part: a multiple of 32.
// part_m/part_l: [bhkv * n_parts * group] f32, part_acc: that times d.
extern "C" int flare_decode_attention(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* o, int bhkv, int hkv, int group,
                                      int S, int d, float scale, int dtype,
                                      int keys_per_part, void* part_m,
                                      void* part_l, void* part_acc,
                                      void* stream) {
  if (bhkv <= 0 || hkv <= 0 || bhkv % hkv != 0 || group < 1 || group > 8 ||
      S <= 0 || d < 1 || d > 256 || keys_per_part <= 0 ||
      keys_per_part % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return da_by_group<float>(q, k, v, lens, o, bhkv, hkv, group, S, d, scale, keys_per_part, pm, pl, pa, s);
  if (dtype == 1)
    return da_by_group<__nv_bfloat16>(q, k, v, lens, o, bhkv, hkv, group, S, d, scale, keys_per_part, pm, pl, pa, s);
  return (int)cudaErrorInvalidValue;
}
