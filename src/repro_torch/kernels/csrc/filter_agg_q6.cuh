// filter_agg_q6: the paper's hand-written Q6 loop (Fig. 3), predicated.
//
// Replaces the Pallas kernel filter_agg_q6 (src/repro/kernels/filter_agg/
// kernel.py), which scans [rows, 128] blocks with the query constants
// baked into its body.  Here the constants are macros of the unit's
// prologue (FLARE_Q6_*: the f32 thresholds as exact hex literals, the
// dates as int32), so each set of constants is one unit.
//
// Bound on the H100 by bytes: 16 per row (three f32 columns and one int32
// column, each read once) over 3.35 TB/s.  Each thread walks a grid-stride
// loop of 16-byte loads (float4 and int4: four rows of every column per
// iteration) with one f32 register accumulator; a scalar loop takes the
// tail, and every row when a column's pointer is not 16-byte aligned (a
// slice of a column can start anywhere).  flare_block_sum writes one
// partial per block and flare_sum_partials folds them in block order, so
// the result is the same from run to run.

__device__ __forceinline__ float flare_q6_row(float qty, float price,
                                              float disc, int date) {
  const bool pass = date >= FLARE_Q6_DATE_LO && date < FLARE_Q6_DATE_HI &&
                    disc >= FLARE_Q6_DISC_LO && disc <= FLARE_Q6_DISC_HI &&
                    qty < FLARE_Q6_QTY_HI;
  return pass ? price * disc : 0.0f;
}

__global__ void __launch_bounds__(FLARE_THREADS)
flare_q6_partial(const float* __restrict__ qty,
                 const float* __restrict__ price,
                 const float* __restrict__ disc, const int* __restrict__ date,
                 long long n, int vec, float* __restrict__ partials) {
  float acc[1] = {0.0f};
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long tail = 0;
  if (vec) {
    const long long quads = n >> 2;
    const float4* q4 = reinterpret_cast<const float4*>(qty);
    const float4* p4 = reinterpret_cast<const float4*>(price);
    const float4* c4 = reinterpret_cast<const float4*>(disc);
    const int4* d4 = reinterpret_cast<const int4*>(date);
    for (long long i = tid; i < quads; i += stride) {
      const float4 q = __ldg(q4 + i), p = __ldg(p4 + i), c = __ldg(c4 + i);
      const int4 d = __ldg(d4 + i);
      acc[0] += flare_q6_row(q.x, p.x, c.x, d.x);
      acc[0] += flare_q6_row(q.y, p.y, c.y, d.y);
      acc[0] += flare_q6_row(q.z, p.z, c.z, d.z);
      acc[0] += flare_q6_row(q.w, p.w, c.w, d.w);
    }
    tail = quads << 2;
  }
  for (long long i = tail + tid; i < n; i += stride)
    acc[0] += flare_q6_row(__ldg(qty + i), __ldg(price + i), __ldg(disc + i),
                           __ldg(date + i));
  flare_block_sum<1>(acc, partials + blockIdx.x);
}

extern "C" int flare_q6(const void* qty, const void* price, const void* disc,
                        const void* date, long long n, void* partials,
                        void* out, int n_blocks, void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(qty) |
                         reinterpret_cast<uintptr_t>(price) |
                         reinterpret_cast<uintptr_t>(disc) |
                         reinterpret_cast<uintptr_t>(date);
  const int vec = (bits & 15u) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flare_q6_partial<<<n_blocks, FLARE_THREADS, 0, s>>>(
      static_cast<const float*>(qty), static_cast<const float*>(price),
      static_cast<const float*>(disc), static_cast<const int*>(date), n, vec,
      static_cast<float*>(partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flare_sum_partials<<<1, 32, 0, s>>>(static_cast<const float*>(partials),
                                      n_blocks, 1, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
