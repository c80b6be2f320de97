// flash_attention on Hopper's tensor cores: bf16 mma.sync with cp.async.
//
// Replaces the Pallas kernel flash_attention (src/repro/kernels/
// flash_attention/kernel.py:73, pallas_call at :90) for bf16 inputs with a
// head width of 64, 128 or 160.  The wrapper (kernels/flash_attention/
// kernel.py, route()) sends every other dtype or width to the CUDA-core
// kernel of flash_attention.cuh; the two compute the same function.
//
//   q [BH, S, D], k/v [BHkv, S, D] bf16, o [BH, S, D] bf16.
//   The KV head of query head bh is bh / group: K and V are never repeated.
//
// Semantics kept from the TPU kernel: causally masked scores are -1e30
// (not -inf), keys at or beyond S (the ragged last tile) add exactly
// nothing, the output is acc / max(l, 1e-30) in bf16.
//
// Bound on the H100: operations.  4 * S^2 * D flops per query head (half
// under causal) on the bf16 tensor cores, against q/k/v/o read or written
// once.  The design aims at that bound:
//
// * One block of 4 warps owns one (query head, 64-row Q tile); each warp
//   owns 16 rows.  The warp loads its Q fragments into registers once
//   (ldmatrix.x4) and walks the K/V tiles of 64 keys.
// * Both products run as mma.sync.m16n8k16 bf16 with f32 accumulators:
//   S = Q K^T (K's B fragments by ldmatrix.x4 on the key rows) and
//   O += P V (V's B fragments by ldmatrix.x4.trans).  P stays in
//   registers: the C fragments of two adjacent n8 tiles of S are, packed
//   to bf16, the A fragment of one k16 step of P V.
// * P keeps f32 grade through bf16 tensor cores: it is split into a bf16
//   high part and the bf16 rounding of the rest, and P V runs one mma for
//   each on the same V fragments.  P rounded to bf16 alone (the model's
//   own rounding, layers.py) misses the kernel-vs-plain limit on the LM
//   path's non-causal layer-0 inputs (PERF.md).  The row sum l adds the
//   f32 values.
// * K/V tiles go through a ring of 2 stages in shared memory, filled with
//   16-byte cp.async.cg copies; tile j+1 loads while tile j computes.
//   Rows at or beyond S are zero-filled (src-size 0), so no thread reads
//   past the tensor.  Every ldmatrix matrix reads one 16-byte chunk of 8
//   consecutive rows, and its 8 row addresses fall on 8 distinct bank
//   groups (16-byte units mod 128 bytes) by the row layout (fm_row):
//   at D 64 and 128 a shared row is D * 2 bytes (8 or 16 chunks) and
//   chunk c of row r sits at chunk c ^ (r % 8); at D 160 (20 chunks,
//   where that XOR would reach chunks 16..23, past the row) a row is
//   padded to 21 chunks (168 elements, 336 bytes), and since 21 is odd,
//   8 consecutive rows at one chunk land on 8 distinct bank groups with
//   no XOR.  Global memory keeps its [S, D] rows; only shared rows are
//   padded.  kernels/flash_attention/kernel.py mirrors the layout
//   (mma_smem_offset, mma_smem_bytes) for the CPU tests.
// * The softmax runs in the exp2 domain: scale * log2(e) is one constant
//   and every exponential is one ex2.approx.  Row max and row sum live in
//   the quad of lanes that share a row (shfl_xor 1 and 2); l is summed
//   per lane and folded across the quad once, at the end.  O is rescaled
//   by alpha once per K tile.
// * Causal: K tiles wholly above the diagonal are skipped (exact: there
//   p would be 0 and alpha 1); the mask runs only on the diagonal tile
//   and on the ragged last tile.  Heavy (late) Q tiles launch first.
// * No NaN can enter m or l: m starts at the finite -1e30 and a key at or
//   beyond S scores -inf, so an exponent is never -inf - (-inf).  Every
//   row below S sees key 0; a row past S (the last tile's padding, never
//   stored) sees the keys below S.
//
// Shared memory: Q 64 rows, then 2 stages of K and V 64 rows, all bf16
// rows of fm_row<D>::stride elements: 40 KB at D 64, 80 KB at D 128 and
// 105 KB (107,520 bytes) at D 160 (opt-in above 48 KB; two blocks fit an
// SM at each).  The unit builds with --fmad=false; it has no
// multiply-add outside the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FM_NEG_INF (-1e30f)
#define FM_BQ 64
#define FM_BK 64
#define FM_WARPS 4
#define FM_THREADS (FM_WARPS * 32)
#define FM_LOG2E 1.4426950408889634f

__device__ __forceinline__ uint32_t fm_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared row layout at head width D: a row of D / 8 16-byte chunks
// XOR-swizzles them by row % 8 when that count is a multiple of 8 (D 64,
// 128); otherwise it is padded to an odd number of chunks (D 160: 21)
// and left unswizzled.
template <int D>
struct fm_row {
  static constexpr int chunks = D / 8;
  static constexpr bool swizzle = chunks % 8 == 0;
  static constexpr int stride = (swizzle ? chunks : (chunks | 1)) * 8;
};

// Element offset of (row, 16-byte chunk) in a shared [rows][D] tile.
template <int D>
__device__ __forceinline__ int fm_swz(int row, int chunk) {
  if constexpr (fm_row<D>::swizzle)
    return row * D + ((chunk ^ (row & 7)) << 3);
  else
    return row * fm_row<D>::stride + (chunk << 3);
}

__device__ __forceinline__ void fm_cp_async16(uint32_t dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void fm_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fm_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fm_ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void fm_ldsm_x4_t(uint32_t (&r)[4],
                                             uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void fm_mma(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fm_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as packed bf16 (lo in the low half: the smaller column).
__device__ __forceinline__ uint32_t fm_pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The bf16 residual of fm_pack(lo, hi): what the rounding dropped.
__device__ __forceinline__ uint32_t fm_pack_rest(float lo, float hi,
                                                 uint32_t packed) {
  const float2 r = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&packed));
  return fm_pack(lo - r.x, hi - r.y);
}

// cp.async one [64][D] bf16 tile (rows row0.. of a [S][D] slab) into a
// shared tile laid out by fm_row<D>; rows at or beyond S are zero-filled.
template <int D>
__device__ __forceinline__ void fm_load_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int row0, int S) {
  constexpr int CH = D / 8;                   // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < FM_BQ * CH / FM_THREADS; ++i) {
    const int idx = threadIdx.x + i * FM_THREADS;
    const int r = idx / CH, c = idx % CH;
    const int gr = row0 + r;
    const bool in = gr < S;
    const __nv_bfloat16* g = src + (long long)(in ? gr : 0) * D + c * 8;
    fm_cp_async16(fm_smem_addr(dst + fm_swz<D>(r, c)), g, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(FM_THREADS)
flare_flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int S, int group,
                       int causal, float scale_log2) {
  constexpr int KS = D / 16;     // k16 steps of Q K^T; n8 tiles of O / 2
  constexpr int NO = D / 8;      // n8 tiles of O
  constexpr int NS = FM_BK / 8;  // n8 tiles of S
  constexpr int RS = fm_row<D>::stride;  // shared row stride (elements)
  extern __shared__ __align__(128) unsigned char fm_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fm_smem);
  __nv_bfloat16* ks = qs + FM_BQ * RS;         // [2][64][RS]
  __nv_bfloat16* vs = ks + 2 * FM_BK * RS;     // [2][64][RS]

  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int q0 = qt * FM_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const __nv_bfloat16* kb = k + (long long)(bh / group) * S * D;
  const __nv_bfloat16* vb = v + (long long)(bh / group) * S * D;

  const int n_k = (S + FM_BK - 1) / FM_BK;
  const int n_tiles = causal ? min(qt + 1, n_k) : n_k;

  fm_load_tile<D>(qs, q + (long long)bh * S * D, q0, S);
  fm_load_tile<D>(ks, kb, 0, S);
  fm_load_tile<D>(vs, vb, 0, S);
  fm_cp_commit();

  uint32_t qf[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = FM_NEG_INF, m_b = FM_NEG_INF, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      const int nst = (j + 1) & 1;
      fm_load_tile<D>(ks + nst * FM_BK * RS, kb, (j + 1) * FM_BK, S);
      fm_load_tile<D>(vs + nst * FM_BK * RS, vb, (j + 1) * FM_BK, S);
      fm_cp_commit();
      fm_cp_wait<1>();
    } else {
      fm_cp_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < KS; ++kc) {
        const int r = warp * 16 + (lane & 15);
        fm_ldsm_x4(qf[kc],
                   fm_smem_addr(qs + fm_swz<D>(r, 2 * kc + (lane >> 4))));
      }
    }
    const __nv_bfloat16* kt = ks + st * FM_BK * RS;
    const __nv_bfloat16* vt = vs + st * FM_BK * RS;
    const int k0 = j * FM_BK;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int kc = 0; kc < KS; ++kc) {
        uint32_t b[4];
        fm_ldsm_x4(b, fm_smem_addr(
                          kt + fm_swz<D>(key, 2 * kc + ((lane >> 3) & 1))));
        fm_mma(s[2 * np], qf[kc], b[0], b[1]);
        fm_mma(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    }

    // scores in the log2 domain, masked on the diagonal and ragged tiles
    const bool edge = (causal && j == qt) || k0 + FM_BK > S;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (key >= S) x = -INFINITY;
          else if (causal && key > row) x = FM_NEG_INF;
        }
        s[n][e] = x;
      }
    }

    // online softmax: one rescale of O per tile
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float alpha_a = fm_exp2(m_a - mx_a);
    const float alpha_b = fm_exp2(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha_a; acc[n][1] *= alpha_a;
      acc[n][2] *= alpha_b; acc[n][3] *= alpha_b;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = fm_exp2(s[n][0] - m_a);
      s[n][1] = fm_exp2(s[n][1] - m_a);
      s[n][2] = fm_exp2(s[n][2] - m_b);
      s[n][3] = fm_exp2(s[n][3] - m_b);
      l_a += s[n][0] + s[n][1];
      l_b += s[n][2] + s[n][3];
    }

    // O += P V: P's A fragments straight from the S registers
#pragma unroll
    for (int kk = 0; kk < FM_BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = fm_pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = fm_pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = fm_pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = fm_pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      uint32_t pr[4];
      pr[0] = fm_pack_rest(s[2 * kk][0], s[2 * kk][1], pa[0]);
      pr[1] = fm_pack_rest(s[2 * kk][2], s[2 * kk][3], pa[1]);
      pr[2] = fm_pack_rest(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2]);
      pr[3] = fm_pack_rest(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3]);
      const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
        uint32_t b[4];
        fm_ldsm_x4_t(b, fm_smem_addr(vt + fm_swz<D>(key, 2 * dn +
                                                         (lane >> 4))));
        fm_mma(acc[2 * dn], pa, b[0], b[1]);
        fm_mma(acc[2 * dn + 1], pa, b[2], b[3]);
        fm_mma(acc[2 * dn], pr, b[0], b[1]);
        fm_mma(acc[2 * dn + 1], pr, b[2], b[3]);
      }
    }
    __syncthreads();   // stage st is refilled at the top of iteration j+1
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = o + (long long)bh * S * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_a * D + col) =
          __floats2bfloat162_rn(acc[n][0] / den_a, acc[n][1] / den_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_b * D + col) =
          __floats2bfloat162_rn(acc[n][2] / den_b, acc[n][3] / den_b);
  }
}

template <int D>
static size_t fm_smem_bytes() {
  return (size_t)(FM_BQ + 4 * FM_BK) * fm_row<D>::stride *
         sizeof(__nv_bfloat16);
}

template <int D>
static int fm_launch(const void* q, const void* k, const void* v, void* o,
                     int bh, int S, int group, int causal, float scale,
                     cudaStream_t s) {
  const size_t smem = fm_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flare_flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + FM_BQ - 1) / FM_BQ, bh);
  flare_flash_mma_kernel<D><<<grid, FM_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, group, causal, scale * FM_LOG2E);
  return (int)cudaGetLastError();
}

// bf16 only; d is 64, 128 or 160.  bh query heads, bhkv KV heads.
extern "C" int flare_flash_attention_mma(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int bhkv, int S, int d, int causal,
                                         float scale, void* stream) {
  if (bh <= 0 || bhkv <= 0 || bh % bhkv != 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = bh / bhkv;
  if (d == 64) return fm_launch<64>(q, k, v, o, bh, S, group, causal, scale, s);
  if (d == 128)
    return fm_launch<128>(q, k, v, o, bh, S, group, causal, scale, s);
  if (d == 160)
    return fm_launch<160>(q, k, v, o, bh, S, group, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Resources of the kernel at head width d: registers per thread, local
// (spill) bytes per thread, static and dynamic shared bytes per block.
extern "C" int flare_flash_attention_mma_attrs(int d, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  size_t dyn;
  if (d == 64) {
    e = cudaFuncGetAttributes(&a, flare_flash_mma_kernel<64>);
    dyn = fm_smem_bytes<64>();
  } else if (d == 128) {
    e = cudaFuncGetAttributes(&a, flare_flash_mma_kernel<128>);
    dyn = fm_smem_bytes<128>();
  } else if (d == 160) {
    e = cudaFuncGetAttributes(&a, flare_flash_mma_kernel<160>);
    dyn = fm_smem_bytes<160>();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)dyn;
  return 0;
}
