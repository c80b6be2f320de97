// filter_agg_general: fused filter + FLARE_N_OUT masked sums in one pass.
//
// Replaces the Pallas kernel filter_agg_general (src/repro/kernels/
// filter_agg/kernel.py).  The generated body flare_row(c, i, ok, scal, v)
// evaluates the fragment's predicate and values for row i; `ok` is the
// stream's validity.  Bound on the H100 by the bytes of the streamed
// columns: each thread walks a grid-stride loop with FLARE_N_OUT register
// accumulators, so every column byte is read once and nothing else goes to
// device memory except one partial per block and slot.  The [rows, 128]
// padding of the TPU layout is gone; the loop stops at n.

__global__ void __launch_bounds__(FLARE_THREADS)
flare_filter_agg_partial(FlareCols c, const unsigned char* __restrict__ valid,
                         long long n, const float* __restrict__ scal,
                         float* __restrict__ partials) {
  float acc[FLARE_N_OUT];
#pragma unroll
  for (int j = 0; j < FLARE_N_OUT; ++j) acc[j] = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v[FLARE_N_OUT];
    flare_row(c, i, flare_valid(valid, i), scal, v);
#pragma unroll
    for (int j = 0; j < FLARE_N_OUT; ++j) acc[j] += v[j];
  }
  flare_block_sum<FLARE_N_OUT>(acc, partials + (long long)blockIdx.x * FLARE_N_OUT);
}

extern "C" int flare_filter_agg(const void* const* cols, int n_cols,
                                const void* valid, long long n,
                                const void* scal, void* partials, void* out,
                                int n_blocks, void* stream) {
  if (n_cols > FLARE_MAX_COLS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flare_filter_agg_partial<<<n_blocks, FLARE_THREADS, 0, s>>>(
      flare_cols(cols, n_cols), static_cast<const unsigned char*>(valid), n,
      static_cast<const float*>(scal), static_cast<float*>(partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flare_sum_partials<<<1, 32, 0, s>>>(static_cast<const float*>(partials),
                                      n_blocks, FLARE_N_OUT,
                                      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
