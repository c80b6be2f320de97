// join_probe_agg: fused N:1 join probe + payload gather + residual
// predicate + aggregate, in one pass over the probe stream.
//
// Replaces the Pallas kernel join_probe_agg (src/repro/kernels/join_probe/
// kernel.py).  The build side is the cached join index (sorted int32 keys
// plus the permutation to base-table rows) and the unsorted base-table
// payload columns, all read in place from device memory: the TPU kernel's
// VMEM residency and paged build slabs have no counterpart.  Per probe row:
// the generated flare_probe_key builds the combined key (f32, exact below
// 2^24), a lower-bound binary search finds its position (clipped to the
// last key, as probe_sorted does), the hit test and the optional build-mask
// check decide the match, and the generated flare_row evaluates predicate,
// values and group code with the payload read at perm[pos].  Bound by the
// probe column bytes; the search costs log2(nb) dependent loads per row,
// which the build side's residency in the 50 MB L2 keeps cheap for the
// small TPC-H build tables.
//
// FLARE_ACCUM selects the accumulation: 0 keyless (register sums, block
// reduce, per-block partials), 1 grouped in shared memory (as in
// segmented_reduce.cuh), 2 grouped by global atomics into the [FLARE_N_OUT,
// G] output the wrapper allocated and filled; the order of those atomics
// changes from run to run.

__device__ __forceinline__ bool flare_probe(const int* __restrict__ keys,
                                            long long nb, float kp,
                                            long long* pos) {
  long long lo = 0, hi = nb;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (static_cast<float>(__ldg(keys + mid)) < kp)
      lo = mid + 1;
    else
      hi = mid;
  }
  const long long idx = lo < nb ? lo : nb - 1;
  *pos = idx;
  return static_cast<float>(__ldg(keys + idx)) == kp;
}

__global__ void __launch_bounds__(FLARE_THREADS)
flare_join_probe_kernel(FlareCols pc, FlareCols bc,
                        const unsigned char* __restrict__ pvalid, long long n,
                        const int* __restrict__ keys,
                        const int* __restrict__ perm,
                        const unsigned char* __restrict__ bmask, long long nb,
                        long long G, int reps,
                        const float* __restrict__ scal,
                        float* __restrict__ dst) {
#if FLARE_ACCUM == 0
  float sums[FLARE_N_OUT];
#pragma unroll
  for (int j = 0; j < FLARE_N_OUT; ++j) sums[j] = 0.0f;
#elif FLARE_ACCUM == 1
  extern __shared__ float acc[];
  const long long size = FLARE_N_OUT * G;
  flare_acc_init(acc, reps, G);
  __syncthreads();
  const int copy = flare_copy(reps);
#else
  float* acc = dst;  // reps == 1: one copy, global atomics
  const int copy = 0;
#endif
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long row = 0;
    bool matched = false;
    if (flare_valid(pvalid, i)) {
      long long pos;
      matched = flare_probe(keys, nb, flare_probe_key(pc, i), &pos);
      row = __ldg(perm + pos);
      if (bmask != nullptr) matched = matched && __ldg(bmask + row) != 0;
    }
    float v[FLARE_N_OUT];
    int g = 0;
    const bool pred = flare_row(pc, bc, i, row, matched, scal, v, &g);
#if FLARE_ACCUM == 0
    (void)pred;
#pragma unroll
    for (int j = 0; j < FLARE_N_OUT; ++j) sums[j] += v[j];
#else
    if (pred && g >= 0 && g < G) flare_acc_add(acc, reps, copy, G, g, v);
#endif
  }
#if FLARE_ACCUM == 0
  flare_block_sum<FLARE_N_OUT>(sums, dst + (long long)blockIdx.x * FLARE_N_OUT);
#elif FLARE_ACCUM == 1
  __syncthreads();
  flare_acc_flush(acc, reps, G, dst + blockIdx.x * size);
#endif
}

extern "C" int flare_join_probe(const void* const* pcols, int n_pcols,
                                const void* const* bcols, int n_bcols,
                                const void* pvalid, long long n,
                                const void* keys, const void* perm,
                                const void* bmask, long long nb, long long G,
                                int reps, const void* scal, void* partials,
                                void* out, int n_blocks, void* stream) {
  if (n_pcols > FLARE_MAX_COLS || n_bcols > FLARE_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      FLARE_ACCUM == 1 ? (size_t)reps * FLARE_N_OUT * G * sizeof(float) : 0;
  flare_join_probe_kernel<<<n_blocks, FLARE_THREADS, smem, s>>>(
      flare_cols(pcols, n_pcols), flare_cols(bcols, n_bcols),
      static_cast<const unsigned char*>(pvalid), n,
      static_cast<const int*>(keys), static_cast<const int*>(perm),
      static_cast<const unsigned char*>(bmask), nb, G, reps,
      static_cast<const float*>(scal),
      static_cast<float*>(FLARE_ACCUM == 2 ? out : partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
#if FLARE_ACCUM == 0
  flare_sum_partials<<<1, 32, 0, s>>>(static_cast<const float*>(partials),
                                      n_blocks, FLARE_N_OUT,
                                      static_cast<float*>(out));
#elif FLARE_ACCUM == 1
  const long long size = FLARE_N_OUT * G;
  flare_group_final<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partials), n_blocks, G,
      static_cast<float*>(out));
#endif
  return (int)cudaGetLastError();
}
