// segmented_multi_sum: grouped multi-aggregate out[j, g] in one pass.
//
// Replaces the Pallas kernel segmented_multi_sum (src/repro/kernels/
// segmented_reduce/kernel.py), which scatters through a one-hot matmul on
// the TPU's matrix unit.  Here each block keeps `reps` copies of the
// [FLARE_N_OUT, G] accumulator in shared memory (flare_grouped.cuh: one per
// thread when they fit, updated without atomics; else up to 32 lane
// copies, with shared atomics); blocks write per-block partials that
// flare_group_final folds.  Bound by the streamed column bytes; what the
// design spends beyond that is shared-memory update throughput, which the
// copies spread over more addresses when G is small.  Codes outside
// [0, G) contribute nothing, as they match no one-hot column in the
// reference; rows the predicate drops skip the atomics (they would add 0
// or the max fill).

__global__ void __launch_bounds__(FLARE_THREADS)
flare_segmented_partial(FlareCols c, const unsigned char* __restrict__ valid,
                        const int* __restrict__ codes, long long n,
                        long long G, int reps, const float* __restrict__ scal,
                        float* __restrict__ partials) {
  extern __shared__ float acc[];
  const long long size = FLARE_N_OUT * G;
  flare_acc_init(acc, reps, G);
  __syncthreads();
  const int copy = flare_copy(reps);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v[FLARE_N_OUT];
    const bool pred = flare_row(c, i, flare_valid(valid, i), scal, v);
    const int g = __ldg(codes + i);
    if (pred && g >= 0 && g < G) flare_acc_add(acc, reps, copy, G, g, v);
  }
  __syncthreads();
  flare_acc_flush(acc, reps, G, partials + blockIdx.x * size);
}

extern "C" int flare_segmented(const void* const* cols, int n_cols,
                               const void* valid, const void* codes,
                               long long n, long long G, int reps,
                               const void* scal, void* partials, void* out,
                               int n_blocks, void* stream) {
  if (n_cols > FLARE_MAX_COLS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)reps * FLARE_N_OUT * G * sizeof(float);
  flare_segmented_partial<<<n_blocks, FLARE_THREADS, smem, s>>>(
      flare_cols(cols, n_cols), static_cast<const unsigned char*>(valid),
      static_cast<const int*>(codes), n, G, reps,
      static_cast<const float*>(scal), static_cast<float*>(partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long size = FLARE_N_OUT * G;
  flare_group_final<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partials), n_blocks, G,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
