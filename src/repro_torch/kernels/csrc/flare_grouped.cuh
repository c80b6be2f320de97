// Grouped accumulation shared by segmented_multi_sum and join_probe_agg.
// Needs the prologue's FLARE_N_OUT, flare_op_max[] and flare_fill[].
//
// A block accumulates into `reps` copies of an [FLARE_N_OUT, G] array in
// shared memory, interleaved: copy k of entry t lives at t * reps + k.
// With reps == FLARE_THREADS every thread owns a copy, the 32 lanes of a
// warp touch 32 consecutive words (32 banks), and updates are plain
// read-modify-writes; otherwise warp w uses copy w % reps and updates are
// atomics (sum slots atomicAdd, max slots -- the FD any_ carry-along --
// flare_atomic_max).  With few groups a single copy would have every
// thread of the block contend for the same few addresses.

__device__ __forceinline__ int flare_copy(int reps) {
  return reps == FLARE_THREADS ? threadIdx.x : (threadIdx.x >> 5) % reps;
}

__device__ __forceinline__ void flare_acc_init(float* acc, int reps,
                                               long long G) {
  const long long total = FLARE_N_OUT * G * reps;
  for (long long t = threadIdx.x; t < total; t += blockDim.x)
    acc[t] = flare_fill[(t / reps) / G];
}

__device__ __forceinline__ void flare_acc_add(float* acc, int reps, int copy,
                                              long long G, int g,
                                              const float (&v)[FLARE_N_OUT]) {
#pragma unroll
  for (int j = 0; j < FLARE_N_OUT; ++j) {
    float* a = acc + (j * G + g) * reps + copy;
    if (reps == FLARE_THREADS)
      *a = flare_op_max[j] ? fmaxf(*a, v[j]) : *a + v[j];
    else if (flare_op_max[j])
      flare_atomic_max(a, v[j]);
    else
      atomicAdd(a, v[j]);
  }
}

// Fold the copies and write this block's [FLARE_N_OUT, G] partial.
__device__ __forceinline__ void flare_acc_flush(const float* acc, int reps,
                                                long long G,
                                                float* __restrict__ dst) {
  const long long size = FLARE_N_OUT * G;
  for (long long t = threadIdx.x; t < size; t += blockDim.x) {
    const bool is_max = flare_op_max[t / G];
    const float* c = acc + t * reps;
    float r = c[0];
    for (int k = 1; k < reps; ++k) r = is_max ? fmaxf(r, c[k]) : r + c[k];
    dst[t] = r;
  }
}

// Second pass: one thread per (slot, group) folds the block partials in
// block order (sums in double).
__global__ void flare_group_final(const float* __restrict__ partials,
                                  int n_blocks, long long G,
                                  float* __restrict__ out) {
  const long long size = FLARE_N_OUT * G;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= size) return;
  const int j = static_cast<int>(t / G);
  if (flare_op_max[j]) {
    float m = flare_fill[j];
    for (int b = 0; b < n_blocks; ++b) m = fmaxf(m, partials[b * size + t]);
    out[t] = m;
  } else {
    double s = 0.0;
    for (int b = 0; b < n_blocks; ++b) s += partials[b * size + t];
    out[t] = static_cast<float>(s);
  }
}
