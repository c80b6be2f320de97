// join_probe_agg: fused N:1 join probe + payload gather + residual
// predicate + aggregate, in one pass over the probe stream.
//
// Replaces the Pallas kernel join_probe_agg (src/repro/kernels/join_probe/
// kernel.py).  The build side is the cached join index (sorted int32 keys,
// the permutation to base-table rows, and `meta`, what the index build
// learned about the keys) and the unsorted base-table payload columns, all
// read in place from device memory: the TPU kernel's VMEM residency and
// paged build slabs have no counterpart.
//
// Bound on the H100 by bytes, and only the bytes the work needs: the probe
// mask, the sectors of the probe columns that hold a valid row, the build
// rows that match.  The design:
// - Warp tiles of 32 x FLARE_PROBE_ROWS rows.  Each lane reads the mask of
//   its FLARE_PROBE_ROWS rows with 16-byte loads (the next tile's mask is
//   loaded before this one is worked), and the warp compacts the valid
//   rows, in row order, into a list in shared memory (a full tile skips
//   the list).  A masked row
//   loads no key, no probe column and no payload; it added 0 (keyless) or
//   nothing (grouped), so skipping it changes no result.
// - The list is worked FLARE_PROBE_UNROLL rows a lane at a time: the
//   independent key loads of those rows are issued together, then the
//   probes, then the dependent perm and build-mask loads.  flare_row (the
//   generated predicate, values and group code, reading the probe columns
//   at i and the payload at the base-table row) runs for matched rows only:
//   an unmatched row adds what a masked one adds.
// - The probe position.  On a dense index (unique keys filling
//   [base, base + nb), f32-exact) the lower bound clipped to the last key
//   -- what probe_sorted returns -- is computed: NaN, -inf and keys at or
//   below base go to 0, keys above the last to nb - 1, the rest to
//   ceil(kp) - base; the hit test needs no load.  On an identity index
//   (keys stored sorted) the base-table row is the position, with no perm
//   load.  Any other index (meta null, or not dense) binary-searches the
//   sorted keys, log2(nb) dependent loads.  Both routes give the same
//   position, so the keyless sums are bit-identical between them.
//
// FLARE_ACCUM selects the accumulation: 0 keyless (register sums, block
// reduce, per-block partials), 1 grouped in shared memory (lane copies or
// per-thread copies, flare_grouped.cuh), 2 grouped by global atomics into
// the [FLARE_N_OUT, G] output, which flare_probe_fill first sets to the
// slots' fills.  In mode 2 the lanes of a warp that hold the same group
// code in neighbouring lanes (lineitem arrives grouped by its order key)
// fold their slots with a segmented shuffle scan, and one lane per run
// issues the atomics.  The order of those atomics changes from run to run.

// Rows of a lane's mask, two 16-byte loads.  The wrapper reads this define
// (join_probe.kernel.TILE_ROWS is 32 times it).
#define FLARE_PROBE_ROWS 32
#define FLARE_PROBE_TILE (32 * FLARE_PROBE_ROWS)     // rows of a warp tile
#define FLARE_PROBE_UNROLL 4                         // list rows a lane
#define FLARE_FULL 0xffffffffu

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

// The same position and hit on a dense index: keys base .. base + nb - 1,
// each exact in f32.  `!(kp > lo)` also takes NaN.
__device__ __forceinline__ bool flare_probe_dense(int base, long long nb,
                                                  float kp, long long* pos) {
  const float lo = static_cast<float>(base);
  const float hi = static_cast<float>(base + nb - 1);
  long long p;
  if (!(kp > lo))
    p = 0;
  else if (kp > hi)
    p = nb - 1;
  else
    p = static_cast<long long>(ceilf(kp)) - base;
  *pos = p;
  return static_cast<float>(base + p) == kp;
}

// Bit b set when byte b of w is not 0.
__device__ __forceinline__ unsigned flare_nonzero4(unsigned w) {
  const unsigned r = __vcmpne4(w, 0u);
  return ((r >> 7) & 1u) | ((r >> 14) & 2u) | ((r >> 21) & 4u) |
         ((r >> 28) & 8u);
}

// Valid rows among first .. first + FLARE_PROBE_ROWS - 1 as bits (0 past n).
__device__ __forceinline__ unsigned flare_mask_bits(
    const unsigned char* __restrict__ valid, long long first, long long n) {
  if (first >= n) return 0u;
  const long long left = n - first;
  if (valid == nullptr)
    return left >= FLARE_PROBE_ROWS ? 0xffffffffu : (1u << left) - 1u;
  const unsigned char* p = valid + first;
  if (left >= FLARE_PROBE_ROWS && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    return flare_nonzero4(a.x) | flare_nonzero4(a.y) << 4 |
           flare_nonzero4(a.z) << 8 | flare_nonzero4(a.w) << 12 |
           flare_nonzero4(b.x) << 16 | flare_nonzero4(b.y) << 20 |
           flare_nonzero4(b.z) << 24 | flare_nonzero4(b.w) << 28;
  }
  unsigned bits = 0u;
  for (int b = 0; b < FLARE_PROBE_ROWS && b < left; ++b)
    bits |= static_cast<unsigned>(__ldg(p + b) != 0) << b;
  return bits;
}

#if FLARE_ACCUM == 2
// Lanes in runs of equal code g fold their slots (inclusive segmented
// scan), and the last lane of each run adds them to dst.  Code -1 adds
// nothing.  Every lane of the warp calls this.
__device__ __forceinline__ void flare_warp_add(float* __restrict__ dst,
                                               long long G, int g,
                                               float (&v)[FLARE_N_OUT]) {
  if (__ballot_sync(FLARE_FULL, g >= 0) == 0u) return;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(FLARE_FULL, g, 1);
  const int next = __shfl_down_sync(FLARE_FULL, g, 1);
  const unsigned heads = __ballot_sync(FLARE_FULL, lane == 0 || prev != g);
  // first lane of this lane's run: the highest head at or below it
  const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < FLARE_N_OUT; ++j) {
      const float y = __shfl_up_sync(FLARE_FULL, v[j], o);
      if (lane - o >= start) v[j] = flare_op_max[j] ? fmaxf(v[j], y) : v[j] + y;
    }
  }
  if (g >= 0 && (lane == 31 || next != g)) {
#pragma unroll
    for (int j = 0; j < FLARE_N_OUT; ++j) {
      float* a = dst + j * G + g;
      if (flare_op_max[j])
        flare_atomic_max(a, v[j]);
      else
        atomicAdd(a, v[j]);
    }
  }
}

__global__ void flare_probe_fill(float* __restrict__ out, long long G) {
  const long long size = FLARE_N_OUT * G;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < size; t += (long long)gridDim.x * blockDim.x)
    out[t] = flare_fill[t / G];
}
#endif

__global__ void __launch_bounds__(FLARE_THREADS)
flare_join_probe_kernel(FlareCols pc, FlareCols bc,
                        const unsigned char* __restrict__ pvalid, long long n,
                        const int* __restrict__ keys,
                        const int* __restrict__ perm,
                        const int* __restrict__ meta,
                        const unsigned char* __restrict__ bmask, long long nb,
                        long long G, int reps,
                        const float* __restrict__ scal,
                        float* __restrict__ dst) {
  __shared__ unsigned short lists[FLARE_WARPS][FLARE_PROBE_TILE];
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
#endif
  // the index facts, read once per thread (one broadcast load a warp)
  const bool dense = meta != nullptr && __ldg(meta) != 0;
  const int base_key = meta != nullptr ? __ldg(meta + 1) : 0;
  const bool identity = meta != nullptr && __ldg(meta + 2) != 0;

  const int lane = threadIdx.x & 31;
  unsigned short* lst = lists[threadIdx.x >> 5];
  const long long warps = (long long)gridDim.x * FLARE_WARPS;
  long long tile = blockIdx.x * (long long)FLARE_WARPS + (threadIdx.x >> 5);
  unsigned bits = flare_mask_bits(
      pvalid, tile * FLARE_PROBE_TILE + lane * FLARE_PROBE_ROWS, n);
  for (; tile * FLARE_PROBE_TILE < n; tile += warps) {
    const long long first = tile * FLARE_PROBE_TILE;
    const unsigned next = flare_mask_bits(
        pvalid, (tile + warps) * FLARE_PROBE_TILE + lane * FLARE_PROBE_ROWS,
        n);
    // compact the valid rows of the tile, in row order
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FLARE_FULL, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(FLARE_FULL, incl, 31);
    const bool full = total == FLARE_PROBE_TILE;
    if (!full) {
      int at = incl - cnt;
      for (unsigned b = bits; b != 0u; b &= b - 1u)
        lst[at++] = static_cast<unsigned short>(lane * FLARE_PROBE_ROWS +
                                                __ffs(b) - 1);
      __syncwarp();
    }
    // the trip count is the same for every lane of the warp
    for (int r = 0; r < total; r += 32 * FLARE_PROBE_UNROLL) {
      // row offsets in the tile and build rows fit 32 bits (nb < 2^31)
      int off[FLARE_PROBE_UNROLL], row[FLARE_PROBE_UNROLL];
      bool hit[FLARE_PROBE_UNROLL];
      float kp[FLARE_PROBE_UNROLL];
#pragma unroll
      for (int u = 0; u < FLARE_PROBE_UNROLL; ++u) {
        const int k = r + 32 * u + lane;
        hit[u] = k < total;
        off[u] = hit[u] ? (full ? k : lst[k]) : 0;
        row[u] = 0;
      }
#pragma unroll
      for (int u = 0; u < FLARE_PROBE_UNROLL; ++u)
        kp[u] = hit[u] ? flare_probe_key(pc, first + off[u]) : 0.0f;
#pragma unroll
      for (int u = 0; u < FLARE_PROBE_UNROLL; ++u) {
        if (!hit[u]) continue;
        long long pos;
        hit[u] = dense ? flare_probe_dense(base_key, nb, kp[u], &pos)
                       : flare_probe(keys, nb, kp[u], &pos);
        row[u] = identity ? static_cast<int>(pos) : __ldg(perm + pos);
      }
      if (bmask != nullptr) {
#pragma unroll
        for (int u = 0; u < FLARE_PROBE_UNROLL; ++u)
          if (hit[u]) hit[u] = __ldg(bmask + row[u]) != 0;
      }
#pragma unroll
      for (int u = 0; u < FLARE_PROBE_UNROLL; ++u) {
        float v[FLARE_N_OUT];
#pragma unroll
        for (int j = 0; j < FLARE_N_OUT; ++j) v[j] = 0.0f;
        int g = -1;
        if (hit[u]) {
          int code = 0;
          const bool pred =
              flare_row(pc, bc, first + off[u], row[u], true, scal, v, &code);
#if FLARE_ACCUM == 0
          (void)pred;
          (void)code;
#pragma unroll
          for (int j = 0; j < FLARE_N_OUT; ++j) sums[j] += v[j];
#else
          if (pred && code >= 0 && code < G) g = code;
#endif
        }
#if FLARE_ACCUM == 1
        if (g >= 0) flare_acc_add(acc, reps, copy, G, g, v);
#elif FLARE_ACCUM == 2
        flare_warp_add(dst, G, g, v);
#else
        (void)g;
#endif
      }
    }
    __syncwarp();  // the list is rewritten by the next tile
    bits = next;
  }
#if FLARE_ACCUM == 0
  flare_block_sum<FLARE_N_OUT>(sums, dst + (long long)blockIdx.x * FLARE_N_OUT);
#elif FLARE_ACCUM == 1
  __syncthreads();
  flare_acc_flush(acc, reps, G, dst + blockIdx.x * size);
#endif
}

// The tile lists take 16 KB of static shared memory: an accumulator
// beyond the rest of 48 KB needs the dynamic limit raised (once per size).
static cudaError_t flare_probe_optin(size_t smem) {
  static size_t opted = 0;
  const size_t list_bytes =
      sizeof(unsigned short) * FLARE_WARPS * FLARE_PROBE_TILE;
  if (smem + list_bytes <= 48 * 1024 || smem <= opted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      flare_join_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess) opted = smem;
  return e;
}

// out: registers and local (spill) bytes per thread, static shared bytes,
// and resident blocks per SM with `smem` dynamic shared bytes.
extern "C" int flare_join_probe_attrs(long long smem, int* out) {
  cudaError_t e = flare_probe_optin((size_t)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, flare_join_probe_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flare_join_probe_kernel, FLARE_THREADS, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}

extern "C" int flare_join_probe(const void* const* pcols, int n_pcols,
                                const void* const* bcols, int n_bcols,
                                const void* pvalid, long long n,
                                const void* keys, const void* perm,
                                const void* meta, const void* bmask,
                                long long nb, long long G, int reps,
                                const void* scal, void* partials, void* out,
                                int n_blocks, void* stream) {
  if (n_pcols > FLARE_MAX_COLS || n_bcols > FLARE_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      FLARE_ACCUM == 1 ? (size_t)reps * FLARE_N_OUT * G * sizeof(float) : 0;
#if FLARE_ACCUM == 1
  {
    const cudaError_t e = flare_probe_optin(smem);
    if (e != cudaSuccess) return (int)e;
  }
#elif FLARE_ACCUM == 2
  {
    const long long size = FLARE_N_OUT * G;
    const long long want = (size + 255) / 256;
    flare_probe_fill<<<(unsigned)(want < 4096 ? want : 4096), 256, 0, s>>>(
        static_cast<float*>(out), G);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
#endif
  flare_join_probe_kernel<<<n_blocks, FLARE_THREADS, smem, s>>>(
      flare_cols(pcols, n_pcols), flare_cols(bcols, n_bcols),
      static_cast<const unsigned char*>(pvalid), n,
      static_cast<const int*>(keys), static_cast<const int*>(perm),
      static_cast<const int*>(meta), static_cast<const unsigned char*>(bmask),
      nb, G, reps, static_cast<const float*>(scal),
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
