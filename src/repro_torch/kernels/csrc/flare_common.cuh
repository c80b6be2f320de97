// Shared pieces of the Flare native kernels, compiled for sm_90a.
//
// Every kernel unit is assembled from: this header, a prologue written by
// the kernel's Python wrapper (FLARE_N_OUT and the per-slot accumulate op
// and fill), flare_grouped.cuh, the per-fragment body generated from the
// query's expression tree (repro_torch.native.patterns.ExprCompiler), and
// the kernel's hand-written skeleton.  The unit exports plain C entry
// points that the wrapper calls through ctypes on PyTorch's current stream.
#include <cuda_runtime.h>
#include <stdint.h>

#define FLARE_THREADS 256
#define FLARE_WARPS (FLARE_THREADS / 32)
#define FLARE_MAX_COLS 24

// Column pointers travel by value in the kernel's parameter space: no
// device-side pointer table to allocate or copy per launch.
struct FlareCols {
  const void* p[FLARE_MAX_COLS];
};

static inline FlareCols flare_cols(const void* const* ptrs, int n) {
  FlareCols c;
  for (int k = 0; k < FLARE_MAX_COLS; ++k) c.p[k] = k < n ? ptrs[k] : nullptr;
  return c;
}

// Columns stream in their device dtype and become f32 in registers, so an
// int32 date or code column needs no separate cast pass.
__device__ __forceinline__ float flare_ld_f32(const void* p, long long i) {
  return __ldg(static_cast<const float*>(p) + i);
}
__device__ __forceinline__ float flare_ld_i32(const void* p, long long i) {
  return static_cast<float>(__ldg(static_cast<const int*>(p) + i));
}
__device__ __forceinline__ float flare_ld_u8(const void* p, long long i) {
  return static_cast<float>(__ldg(static_cast<const unsigned char*>(p) + i));
}

__device__ __forceinline__ bool flare_valid(const unsigned char* valid,
                                            long long i) {
  return valid == nullptr || __ldg(valid + i) != 0;
}

// Float max by integer ordering: non-negative floats order as signed
// ints, negative floats in reverse as unsigned ints.
__device__ __forceinline__ void flare_atomic_max(float* addr, float v) {
  if (v >= 0.0f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// Block-wide sum of N per-thread values; thread 0 of warp 0 writes out[j].
template <int N>
__device__ __forceinline__ void flare_block_sum(const float (&acc)[N],
                                                float* __restrict__ out) {
  __shared__ float part[FLARE_WARPS][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float v = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) part[warp][j] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float v = lane < FLARE_WARPS ? part[lane][j] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) out[j] = v;
    }
  }
}

// Second pass of the keyless kernels: one thread per output slot sums the
// per-block partials in block order, in double.  Fixed order and fixed
// grid make the result the same from run to run.
__global__ void flare_sum_partials(const float* __restrict__ partials,
                                   int n_blocks, int n_out,
                                   float* __restrict__ out) {
  const int j = threadIdx.x;
  if (j >= n_out) return;
  double s = 0.0;
  for (int b = 0; b < n_blocks; ++b) s += partials[(long long)b * n_out + j];
  out[j] = static_cast<float>(s);
}
