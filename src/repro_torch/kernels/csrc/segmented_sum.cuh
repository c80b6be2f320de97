// segmented_sum: out[g] = sum of values[i] over the rows with codes[i] == g.
//
// Replaces the Pallas kernel segmented_sum (src/repro/kernels/
// segmented_reduce/kernel.py), which turns the scatter into a one-hot
// matmul on the TPU's matrix unit.  On the H100 it is a histogram in
// shared memory: flare_grouped.cuh's accumulator with one output row
// (FLARE_N_OUT 1, a sum), `reps` copies per block -- one per thread when
// they fit the 48 KB budget (G <= 48), updated without atomics; else lane
// copies, updated with shared atomics (G = 512: 16 copies of 2 KB, lane l
// on copy l % 16, so a warp's 32 random codes meet at most two to a bank;
// one copy per warp put them on 4 banks) -- and per-block partials that
// flare_group_final folds in block order.
//
// Bound on the H100 by bytes: 8 per row (f32 value, int32 code) over
// 3.35 TB/s.  Values and codes stream with 16-byte loads (float4, int4);
// a scalar loop takes the tail, and every row when either pointer is not
// 16-byte aligned.  Codes outside [0, G) contribute nothing, as they match
// no one-hot column in the reference.

__device__ __forceinline__ void flare_segsum_add(float* acc, int reps,
                                                 int copy, long long G,
                                                 int g, float v) {
  if (g >= 0 && g < G) {
    const float one[1] = {v};
    flare_acc_add(acc, reps, copy, G, g, one);
  }
}

__global__ void __launch_bounds__(FLARE_THREADS)
flare_segsum_partial(const float* __restrict__ values,
                     const int* __restrict__ codes, long long n, long long G,
                     int reps, int vec, float* __restrict__ partials) {
  extern __shared__ float acc[];
  flare_acc_init(acc, reps, G);
  __syncthreads();
  const int copy = flare_copy(reps);
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long tail = 0;
  if (vec) {
    const long long quads = n >> 2;
    const float4* v4 = reinterpret_cast<const float4*>(values);
    const int4* c4 = reinterpret_cast<const int4*>(codes);
    for (long long i = tid; i < quads; i += stride) {
      const float4 v = __ldg(v4 + i);
      const int4 c = __ldg(c4 + i);
      flare_segsum_add(acc, reps, copy, G, c.x, v.x);
      flare_segsum_add(acc, reps, copy, G, c.y, v.y);
      flare_segsum_add(acc, reps, copy, G, c.z, v.z);
      flare_segsum_add(acc, reps, copy, G, c.w, v.w);
    }
    tail = quads << 2;
  }
  for (long long i = tail + tid; i < n; i += stride)
    flare_segsum_add(acc, reps, copy, G, __ldg(codes + i), __ldg(values + i));
  __syncthreads();
  flare_acc_flush(acc, reps, G, partials + blockIdx.x * G);
}

extern "C" int flare_segmented_sum(const void* values, const void* codes,
                                   long long n, long long G, int reps,
                                   void* partials, void* out, int n_blocks,
                                   void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(values) |
                         reinterpret_cast<uintptr_t>(codes);
  const int vec = (bits & 15u) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)reps * G * sizeof(float);
  flare_segsum_partial<<<n_blocks, FLARE_THREADS, smem, s>>>(
      static_cast<const float*>(values), static_cast<const int*>(codes), n,
      G, reps, vec, static_cast<float*>(partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flare_group_final<<<(unsigned)((G + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partials), n_blocks, G,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
