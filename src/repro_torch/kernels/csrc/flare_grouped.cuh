// Grouped accumulation shared by segmented_multi_sum, segmented_sum and
// join_probe_agg.  Needs the prologue's FLARE_N_OUT, flare_op_max[] and
// flare_fill[].
//
// A block accumulates into `reps` copies of an [FLARE_N_OUT, G] array in
// shared memory, interleaved: copy k of entry t lives at t * reps + k.
// Two layouts share that formula:
// - reps == FLARE_THREADS: every thread owns a copy, the 32 lanes of a
//   warp touch 32 consecutive words (32 banks), and updates are plain
//   read-modify-writes;
// - reps a power of two up to 32 (the wrapper's replicas()): lane l of
//   every warp uses copy l % reps, and updates are atomics (sum slots
//   atomicAdd, max slots -- the FD any_ carry-along -- flare_atomic_max).
//   Entry t of lane l is word t * reps + l % reps, in bank
//   (t * reps + l % reps) % 32: with 32 copies each lane has a bank of its
//   own, whatever the codes, and with 16 at most two lanes share a bank.
//   (One copy per warp, at word t * reps + warp, put a warp's 32 codes
//   on 32 / reps banks.)

__device__ __forceinline__ int flare_copy(int reps) {
  return reps == FLARE_THREADS ? threadIdx.x : (threadIdx.x & 31) & (reps - 1);
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
  if (reps == FLARE_THREADS) {
    for (long long t = threadIdx.x; t < size; t += blockDim.x) {
      const bool is_max = flare_op_max[t / G];
      const float* c = acc + t * reps;
      float r = c[0];
      for (int k = 1; k < reps; ++k) r = is_max ? fmaxf(r, c[k]) : r + c[k];
      dst[t] = r;
    }
    return;
  }
  // lane copies: a warp reads 32 consecutive words (no bank conflict),
  // 32 / reps entries with all their copies, and folds each aligned run
  // of reps lanes with shuffles; the loop bound is warp-uniform
  const long long total = size * reps;
  const int lane = threadIdx.x & 31;
  for (long long w0 = threadIdx.x & ~31; w0 < total; w0 += blockDim.x) {
    const long long w = w0 + lane;
    const bool in = w < total;
    const long long t = w / reps;
    const bool is_max = in && flare_op_max[t / G];
    float r = in ? acc[w] : 0.0f;
    for (int o = 1; o < reps; o <<= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, r, o);
      r = is_max ? fmaxf(r, y) : r + y;
    }
    if (in && (lane & (reps - 1)) == 0) dst[t] = r;
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
