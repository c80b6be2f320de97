// decode_attention: one new query token per sequence against its KV cache.
//
// Replaces the Pallas kernel decode_attention (src/repro/kernels/
// decode_attention/kernel.py:65, pallas_call at :79), whose grid walks
// (batch * kv head, k block) in order and carries the softmax state of the
// group's packed query heads in VMEM.
//
// Bound on the H100: bytes.  At GQA group 2 the op does 2 flops per byte of
// cache, far below the card's ~295 flops/byte ridge, so the least time is
// the K and V rows below each sequence's length (all S rows for a length of
// 0), plus q and the output, over 3.35 TB/s.  The design keeps that stream
// full and balanced over the 132 SMs; the dots run in f32 on the CUDA cores
// (tensor cores would not help).  One launch per call:
//
// 1. Split by valid keys, scheduled on the device, over a persistent grid
//    (blocks_per_sm x SMs, from the occupancy query, cached by the
//    wrapper).  Every block reads lengths[B] and computes the same
//    schedule:  n_b = clamp(length, 0, S), S where it is 0;
//    T = hkv * sum n_b rows; a chunk C = ceil(T / target) rounded up to
//    whole tiles (target = DA_ITEMS_PER_BLOCK * grid; C at least two tiles,
//    so an item's lookup serves two tiles or more, and at most S rounded
//    up); then the prefix over b of hkv * ceil(n_b / C) work items, kept
//    in shared memory with n_b.  An item is one chunk of one (sequence, kv
//    head); items are ordered (b, kv head, chunk) and an item's (b, kv
//    head, chunk) is found by binary search on the prefix.
//    Block x walks the contiguous run of items [x N / g, (x + 1) N / g),
//    g = min(grid, N): every block has the same number of items to within
//    one.  A block's items of one (sequence, kv head) form a segment,
//    which accumulates in registers and ends in one partial, so a pair has
//    as many partials as blocks meet it, and most blocks end one or two
//    segments.  (Walking items x, x + grid, ... instead ends a partial
//    and a ticket for every item, and a shared counter that hands chunks
//    to whichever block is free ends one for every chunk: both ran slower
//    on the H100 at decode_32k and at the serving shape.)
//    The host needs no lengths: the partial buffer has grid + B * hkv
//    rows, block x's segment of pair j in row x + j.  Block 0 writes
//    (C, items) to `sched`, so a test can hold the schedule against the
//    wrapper's Python mirror (decode_schedule).
// 2. An asynchronous ring of K and V tiles in shared memory.  The rows of
//    one (sequence, kv head) are contiguous, so a tile of keys is one
//    contiguous span: it is loaded by one thread issuing 1-D bulk copies
//    (cp.async.bulk, one for K, one for V, and one for the queries on a
//    segment's first tile) that complete on the slot's mbarrier with
//    expect_tx of the exact bytes (a short tail tile expects fewer).  Bulk
//    copies because a tile is one span: the copy engine computes no
//    per-thread addresses and spends no registers, and one thread keeps
//    DA_STAGES - 1 tiles of 8 KB of K and of V in flight ahead of the tile
//    being computed (a 4-stage ring, 64 KB per block, three blocks per SM
//    at group <= 2).  The ring runs on across items and segments, so the
//    stream does not drain between them.
//    From shared memory, per tile: scores for the G query heads over the
//    tile's keys, L lanes across a key row (16-byte loads) and a shuffle
//    reduction; the online-softmax update per head (one warp per head);
//    P.V, where each thread owns (head, 16-byte slice of D) and a
//    stride of keys, reading V rows from shared memory with p broadcast
//    from shared memory.  The queries move from the ring to registers as
//    f32 (each lane holds its D slice for all G heads).
// 3. The fold in the kernel.  A segment that covers a whole (sequence, kv
//    head) writes the output directly; otherwise it writes its (m, l, acc)
//    partial in f32 and its block takes a ticket (an acquire-release add
//    on a per-(sequence, kv head) counter, zeroed by cudaMemsetAsync in
//    the C entry).  The block that takes the last ticket folds that
//    pair's partials in block order, read through L2 (__ldcg):
//      M = max m_p, L = sum l_p e^(m_p - M), A = sum acc_p e^(m_p - M),
//      out = A / max(L, 1e-30), cast to q's type,
//    in one pass of loads (each thread merges a stride of the partials
//    with a running max, then the strides are merged in order).  The order
//    is fixed, so two calls on the same inputs are bit-identical.
//
//   q [B*hkv, group, D], k/v [B*hkv, S, D] (float or bf16), lengths [B]
//   int32 (the same length for the hkv heads of a sequence),
//   o [B*hkv, group, D].
//
// Masking follows the TPU kernel: position pos is valid iff pos < length,
// and an invalid score is -1e30.  With length >= 1 the keys at or beyond
// length add exactly 0 (e^(-1e30 - m) underflows once m is finite), so only
// the rows below min(length, S) are read.  With length 0 (or below) every
// score is -1e30 and every key has p = 1: the output is the mean of V over
// all S, as in the TPU kernel and the reference; then all rows are read.
// Lengths above S clamp to S.
//
// The dots and P.V call fmaf by name: the unit builds with --fmad=false
// (cuda_build.py), which leaves an explicit fmaf one instruction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define DA_NEG_INF (-1e30f)
#define DA_THREADS 256
#define DA_WARPS (DA_THREADS / 32)
#define DA_STAGES 4
#define DA_TILE_BYTES 8192
#define DA_ITEMS_PER_BLOCK 8
#define DA_MAX_BATCH 8192

template <typename T> __device__ __forceinline__ T da_from_f(float x);
template <> __device__ __forceinline__ float da_from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
da_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// unpack one 16-byte vector of a row into f32
__device__ __forceinline__ void da_unpack(const uint4& u, float* f,
                                          const float*) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void da_unpack(const uint4& u, float* f,
                                          const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float da_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float da_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- mbarrier and bulk copy (sm_90) ---------------------------------------

__device__ __forceinline__ uint32_t da_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void da_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   da_smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void da_bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   da_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void da_bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = da_smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// the ticket: an add with acquire-release semantics at GPU scope.  The
// block's partial (written by every thread before a __syncthreads) is
// visible before the add; the block that draws the last ticket sees every
// other block's partial after it (then a __syncthreads for its threads).
__device__ __forceinline__ int da_ticket(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}
// one contiguous span of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`
__device__ __forceinline__ void da_bulk_load(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(da_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(da_smem_addr(bar))
      : "memory");
}

// ---- arguments and the shared-memory layout --------------------------------

struct DaLayout {
  int ring, misc, sbuf, red, prefix, total;  // byte offsets, total bytes
  int slot;                                  // bytes of one ring slot
  int kt;                                    // keys per tile
};

// The layout is computed on the host (it sizes the launch) and passed to
// the kernel, which carves its dynamic shared memory by it.
__host__ __device__ inline int da_round16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline DaLayout da_layout(int B, int group, int d,
                                              int elem) {
  DaLayout L;
  L.kt = DA_TILE_BYTES / (d * elem);
  const int nvec = d * elem / 16, epv = 16 / elem;
  const int units = group * nvec;
  const int ks = units >= DA_THREADS ? 1 : DA_THREADS / units;
  // the key strides' sums (then the fold's parts): one f32 per unit slot
  const int red_floats = (units >= DA_THREADS ? units : ks * units) * epv;
  // a slot: K tile, V tile, and the queries when the tile is a segment's
  // first
  L.slot = 2 * DA_TILE_BYTES + da_round16(group * d * elem);
  L.ring = 128;                           // after the mbarriers, 128-aligned
  L.misc = L.ring + DA_STAGES * L.slot;   // alpha, m/l, flag, sums, fold
  L.sbuf = L.misc + 384;
  L.red = L.sbuf + da_round16(2 * group * L.kt * 4);   // two score buffers
  L.prefix = L.red + da_round16(red_floats * 4);
  L.total = L.prefix + da_round16((2 * B + 1) * 4);   // prefix, lengths
  return L;
}

struct DaArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  int B, hkv, group, S, d;
  float scale;
  long long target;  // DA_ITEMS_PER_BLOCK * grid
  DaLayout lay;
  int* ctr;    // [B * hkv] tickets
  int* sched;  // [2]: chunk, items
  float* pacc;
  float* pm;
  float* pl;
};

struct DaItem {
  int bkv;            // the pair: sequence * hkv + kv head
  int start, end;     // the item's rows
  int first, cnt;     // the pair's first item and item count
  bool none_valid;
};

__device__ __forceinline__ int da_clamp_len(int len, int S) {
  return min(max(len, 0), S);
}

// item i -> (sequence, kv head, chunk): P is the prefix of items per
// sequence (P[B] = items), strictly increasing since every n_b >= 1, and
// P[B + 1 + b] is n_b, negated where the length is 0 (every key masked)
__device__ __forceinline__ DaItem da_item(int i, const int* P,
                                          const DaArgs& a, int C) {
  int lo = 0, hi = a.B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (P[mid] <= i) lo = mid; else hi = mid;
  }
  const int b = lo;
  const int cnt = (P[b + 1] - P[b]) / a.hkv;
  const int local = i - P[b];
  const int h = local / cnt, chunk = local % cnt;
  const int nb = P[a.B + 1 + b];
  DaItem it;
  it.bkv = b * a.hkv + h;
  it.start = chunk * C;
  it.end = min(it.start + C, nb < 0 ? -nb : nb);
  it.first = P[b] + h * cnt;
  it.cnt = cnt;
  it.none_valid = nb < 0;
  return it;
}

// ---- the kernel --------------------------------------------------------

// three blocks per SM (85 registers) where the query registers allow it
template <typename T, int G, int DMAX>
__global__ void __launch_bounds__(DA_THREADS, G <= 2 ? 3 : 2)
flare_decode_kernel(const DaArgs a) {
  constexpr int EPV = 16 / sizeof(T);                // elements per 16 bytes
  constexpr int NVM = DMAX * sizeof(T) / 16;         // 16-byte vectors a row
  constexpr int VPL = NVM > 32 ? 2 : 1;              // score vectors a lane
  constexpr int UPT = (G * NVM + DA_THREADS - 1) / DA_THREADS;  // P.V units
  constexpr int DMIN = DMAX == 64 ? 16 : DMAX / 2 + 8;
  constexpr int KT_MAX = DA_TILE_BYTES / (DMIN * (int)sizeof(T));
  constexpr int SPL = (KT_MAX + 31) / 32;            // softmax keys a lane

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + a.lay.ring;
  float* alpha_s = reinterpret_cast<float*>(smem + a.lay.misc);   // [8]
  float* ml_s = alpha_s + 8;                                        // [8][2]
  int* flag_s = reinterpret_cast<int*>(ml_s + 16);                  // [1]
  long long* wsum = reinterpret_cast<long long*>(smem + a.lay.misc + 128);
  // the fold's per-part max [16] and denominator [16]
  float* fold_s = reinterpret_cast<float*>(smem + a.lay.misc + 192);
  float* sbuf = reinterpret_cast<float*>(smem + a.lay.sbuf);
  float* red = reinterpret_cast<float*>(smem + a.lay.red);
  int* P = reinterpret_cast<int*>(smem + a.lay.prefix);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int B = a.B, hkv = a.hkv, group = a.group, S = a.S, d = a.d;
  const int KT = a.lay.kt;
  const int rb = d * (int)sizeof(T);                 // bytes a row
  const int nvec = rb / 16;

  if (t == 0) {
    for (int s = 0; s < DA_STAGES; ++s) da_bar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // -- the schedule: C and the prefix of items per sequence ---------------
  long long my_rows = 0;
  for (int b = t; b < B; b += DA_THREADS) {
    const int len = da_clamp_len(__ldg(a.lengths + b), S);
    my_rows += len == 0 ? S : len;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    my_rows += __shfl_xor_sync(0xffffffffu, my_rows, o);
  if (lane == 0) wsum[warp] = my_rows;
  __syncthreads();
  long long rows = 0;
#pragma unroll
  for (int w = 0; w < DA_WARPS; ++w) rows += wsum[w];
  rows *= hkv;
  long long c = (rows + a.target - 1) / a.target;
  c = (c + KT - 1) / KT * KT;
  const long long c_cap = ((long long)S + KT - 1) / KT * KT;
  if (c < 2 * KT) c = 2 * KT;   // each item's search serves two tiles or more
  if (c > c_cap) c = c_cap;
  const int C = (int)c;
  // each thread owns a contiguous run of sequences; block-wide scan
  const int per = (B + DA_THREADS - 1) / DA_THREADS;
  const int b0 = min(t * per, B), b1 = min(b0 + per, B);
  int run = 0;
  for (int b = b0; b < b1; ++b) {
    const int len = da_clamp_len(__ldg(a.lengths + b), S);
    const int n = len == 0 ? S : len;
    run += hkv * ((n + C - 1) / C);
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  __syncthreads();                       // wsum is read above
  int* wtot = reinterpret_cast<int*>(wsum);
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  int before = incl - run;
  for (int w = 0; w < warp; ++w) before += wtot[w];
  if (t == 0) P[0] = 0;
  for (int b = b0; b < b1; ++b) {
    const int len = da_clamp_len(__ldg(a.lengths + b), S);
    const int n = len == 0 ? S : len;
    before += hkv * ((n + C - 1) / C);
    P[b + 1] = before;
    P[B + 1 + b] = len == 0 ? -S : len;
  }
  __syncthreads();
  const int N = P[B];
  if (blockIdx.x == 0 && t == 0) {
    a.sched[0] = C;
    a.sched[1] = N;
  }
  // this block's items: a contiguous run, the same count to within one,
  // over min(grid, items) blocks (so no run is empty)
  const long long nl = N, gl = min((long long)gridDim.x, nl);
  if (blockIdx.x >= gl) return;
  const int lo = (int)(blockIdx.x * nl / gl);
  const int hi = (int)((blockIdx.x + 1) * nl / gl);

  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);
  const T* qg = static_cast<const T*>(a.q);
  const int qbytes = group * rb;
  T* og = static_cast<T*>(a.o);

  // -- the producer (thread 0): the next tile of this block's run ---------
  int p_item = lo, p_tile = 0, p_seq = 0;
  DaItem pit;
  if (t == 0) pit = da_item(p_item, P, a, C);
  auto issue = [&]() {
    if (p_item >= hi) return;
    const int row0 = pit.start + p_tile * KT;
    const int nk = min(KT, pit.end - row0);
    const uint32_t bytes = (uint32_t)(nk * rb);
    const int slot = p_seq % DA_STAGES;
    unsigned char* dst = ring + slot * a.lay.slot;
    const long long off = ((long long)pit.bkv * S + row0) * d;
    // a segment's first tile brings its queries
    const bool with_q = p_tile == 0 && (p_item == lo || p_item == pit.first);
    da_bar_expect(full + slot, 2 * bytes + (with_q ? qbytes : 0));
    da_bulk_load(dst, kg + off, bytes, full + slot);
    da_bulk_load(dst + DA_TILE_BYTES, vg + off, bytes, full + slot);
    if (with_q)
      da_bulk_load(dst + 2 * DA_TILE_BYTES, qg + (long long)pit.bkv * group * d,
                   (uint32_t)qbytes, full + slot);
    ++p_seq;
    if (row0 + KT >= pit.end) {
      p_tile = 0;
      if (++p_item < hi) pit = da_item(p_item, P, a, C);
    } else {
      ++p_tile;
    }
  };
  if (t == 0)
    for (int s = 0; s < DA_STAGES - 1; ++s) issue();

  // -- thread roles ---------------------------------------------------------
  // scores: L lanes a key (a power of two), keys_per_pass keys a pass
  int L = 1;
  while (L < nvec && L < 32) L <<= 1;
  const int lin = lane & (L - 1);
  const int kslot = warp * (32 / L) + lane / L;
  const int kpp = DA_THREADS / L;
  // P.V: units u = (head, 16-byte slice); ks key strides when units < threads
  const int units = group * nvec;
  const int KS = units >= DA_THREADS ? 1 : DA_THREADS / units;
  const int my_ks = units >= DA_THREADS ? 0 : t / units;
  const bool pv_on = units >= DA_THREADS || t < KS * units;
  const int gd = group * d;

  float qr[G][VPL][EPV];
  float acc[UPT][EPV];
  float m_run = -INFINITY, l_run = 0.f;   // the softmax warp's head
  int seq = 0;

  // A segment is the block's items of one (sequence, kv head): its rows
  // accumulate in registers, and it ends in one partial or the output.
  for (int item = lo; item < hi; ++item) {
    const DaItem it = da_item(item, P, a, C);
    const bool seg_first = item == lo || item == it.first;
    const int pair_last = it.first + it.cnt - 1;
    if (seg_first) {
#pragma unroll
      for (int x = 0; x < UPT; ++x)
#pragma unroll
        for (int e = 0; e < EPV; ++e) acc[x][e] = 0.f;
      m_run = -INFINITY;
      l_run = 0.f;
    }

    for (int row0 = it.start; row0 < it.end; row0 += KT, ++seq) {
      const int nk = min(KT, it.end - row0);
      const int slot = seq % DA_STAGES;
      const unsigned char* ks_ = ring + slot * a.lay.slot;
      const unsigned char* vs_ = ks_ + DA_TILE_BYTES;
      float* sb = sbuf + (seq & 1) * group * KT;
      da_bar_wait(full + slot, (uint32_t)((seq / DA_STAGES) & 1));
      if (seg_first && row0 == it.start) {
        // the segment's queries came with its first tile: to f32 registers
        const uint4* qv = reinterpret_cast<const uint4*>(ks_ + 2 * DA_TILE_BYTES);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int r = 0; r < VPL; ++r) {
            const int vv = lin + r * L;
            if (g < group && vv < nvec) {
              da_unpack(qv[g * nvec + vv], qr[g][r], (const T*)nullptr);
            } else {
#pragma unroll
              for (int e = 0; e < EPV; ++e) qr[g][r][e] = 0.f;
            }
          }
      }

      // scores of the G heads over the tile's keys
      for (int j0 = 0; j0 < nk; j0 += kpp) {
        const int j = j0 + kslot;
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = 0.f;
        if (j < nk && !it.none_valid) {
#pragma unroll
          for (int r = 0; r < VPL; ++r) {
            const int vv = lin + r * L;
            if (vv < nvec) {
              float f[EPV];
              da_unpack(*reinterpret_cast<const uint4*>(ks_ + j * rb + vv * 16),
                        f, (const T*)nullptr);
#pragma unroll
              for (int e = 0; e < EPV; ++e)
#pragma unroll
                for (int g = 0; g < G; ++g) s[g] = fmaf(qr[g][r][e], f[e], s[g]);
            }
          }
        }
        for (int o = L >> 1; o > 0; o >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
        if (lin == 0 && j < nk)
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (g < group)
              sb[g * KT + j] = it.none_valid ? DA_NEG_INF : s[g] * a.scale;
      }
      __syncthreads();                                       // (a)
      if (t == 0) issue();       // the slot of the previous tile is free

      // the online-softmax update: warp g owns head g
      if (warp < group) {
        float* sg = sb + warp * KT;
        float sv[SPL];
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < SPL; ++r) {
          const int j = lane + 32 * r;
          sv[r] = j < nk ? sg[j] : -INFINITY;
          mx = fmaxf(mx, sv[r]);
        }
        mx = da_warp_max(mx);
        const float m_new = fmaxf(m_run, mx);
        const float alpha = expf(m_run - m_new);
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < SPL; ++r) {
          const int j = lane + 32 * r;
          if (j < nk) {
            const float p = expf(sv[r] - m_new);
            sg[j] = p;
            sum += p;
          }
        }
        sum = da_warp_sum(sum);
        l_run = l_run * alpha + sum;
        m_run = m_new;
        if (lane == 0) alpha_s[warp] = alpha;
      }
      __syncthreads();                                       // (b)

      // P.V: each thread its (head, slice) units over its stride of keys
      if (pv_on) {
#pragma unroll
        for (int x = 0; x < UPT; ++x) {
          const int u = units >= DA_THREADS ? t + x * DA_THREADS
                                            : (x == 0 ? t % units : units);
          if (u >= units) continue;
          const int g = u / nvec, cv = u % nvec;
          const float al = alpha_s[g];
#pragma unroll
          for (int e = 0; e < EPV; ++e) acc[x][e] *= al;
          const float* pg = sb + g * KT;
          for (int j = my_ks; j < nk; j += KS) {
            const float p = pg[j];
            float f[EPV];
            da_unpack(*reinterpret_cast<const uint4*>(vs_ + j * rb + cv * 16),
                      f, (const T*)nullptr);
#pragma unroll
            for (int e = 0; e < EPV; ++e) acc[x][e] = fmaf(p, f[e], acc[x][e]);
          }
        }
      }
    }
    if (item != hi - 1 && item != pair_last) continue;

    // -- the segment's end: sum the key strides, then write or fold ---------
    if (pv_on) {
#pragma unroll
      for (int x = 0; x < UPT; ++x) {
        const int u = units >= DA_THREADS ? t + x * DA_THREADS
                                          : (x == 0 ? t % units : units);
        if (u >= units) continue;
        float* dst = red + my_ks * gd + u * EPV;   // u * EPV = g * d + c
#pragma unroll
        for (int e = 0; e < EPV; ++e) dst[e] = acc[x][e];
      }
    }
    if (warp < group && lane == 0) {
      ml_s[2 * warp] = m_run;
      ml_s[2 * warp + 1] = l_run;
    }
    __syncthreads();                                         // (E1)
    // the blocks whose runs meet this pair: its segments, in item order;
    // block x's segment of pair bkv keeps its partial in slot x + bkv
    const int xa = (int)(((long long)(it.first + 1) * gl + nl - 1) / nl) - 1;
    const int xb = (int)(((long long)(pair_last + 1) * gl + nl - 1) / nl) - 1;
    const bool whole = xa == xb;
    const long long obase = (long long)it.bkv * gd;
    const long long mine = (long long)blockIdx.x + it.bkv;
    for (int el = t; el < gd; el += DA_THREADS) {
      float A = 0.f;
      for (int s = 0; s < KS; ++s) A += red[s * gd + el];
      if (whole) {
        const int g = el / d;
        og[obase + el] = da_from_f<T>(A / fmaxf(ml_s[2 * g + 1], 1e-30f));
      } else {
        a.pacc[mine * gd + el] = A;
      }
    }
    if (!whole && t < group) {
      a.pm[mine * group + t] = ml_s[2 * t];
      a.pl[mine * group + t] = ml_s[2 * t + 1];
    }
    __syncthreads();                                         // (E2)
    if (whole) continue;
    if (t == 0) *flag_s = (da_ticket(a.ctr + it.bkv) == xb - xa);
    __syncthreads();                                         // (E3)
    if (!*flag_s) continue;
    // the last block folds the pair's partials in order, in one pass of
    // loads: `parts` threads an element, each merging a stride of the
    // partials (running max, and the denominator where c is 0), then the
    // parts merged in order.  (One thread an element looping over all the
    // partials spills more registers and ran slower on the H100: PERF.md.)
    const int nseg = xb - xa + 1;
    const long long first = (long long)xa + it.bkv;
    const int parts = gd >= DA_THREADS ? 1 : DA_THREADS / gd;
    const int part = t / gd;
    for (int el = t % gd; el < gd && part < parts; el += DA_THREADS) {
      const int g = el / d;
      const bool c0 = el == g * d;
      const float* pm = a.pm + first * group + g;
      const float* pl = a.pl + first * group + g;
      const float* pa = a.pacc + first * gd + el;
      float M = -INFINITY, A = 0.f, Ls = 0.f;
#pragma unroll 4
      for (int p = part; p < nseg; p += parts) {
        const float m = __ldcg(pm + (long long)p * group);
        const float x = __ldcg(pa + (long long)p * gd);
        const float l = c0 ? __ldcg(pl + (long long)p * group) : 0.f;
        const float mn = fmaxf(M, m);
        const float sc = expf(M - mn), w = expf(m - mn);
        A = A * sc + x * w;
        Ls = Ls * sc + l * w;
        M = mn;
      }
      red[part * gd + el] = A;
      if (c0) {
        fold_s[part * group + g] = M;
        fold_s[16 + part * group + g] = Ls;
      }
    }
    __syncthreads();                                         // (E4)
    for (int el = t; el < gd; el += DA_THREADS) {
      const int g = el / d;
      float M = -INFINITY;
      for (int q = 0; q < parts; ++q) M = fmaxf(M, fold_s[q * group + g]);
      float A = 0.f, Ls = 0.f;
      for (int q = 0; q < parts; ++q) {
        const float w = expf(fold_s[q * group + g] - M);
        A += red[q * gd + el] * w;
        Ls += fold_s[16 + q * group + g] * w;
      }
      og[obase + el] = da_from_f<T>(A / fmaxf(Ls, 1e-30f));
    }
  }
}

// ---- host side -----------------------------------------------------------

template <int G_, int D_> struct DaTag {
  static constexpr int G = G_;
  static constexpr int DMAX = D_;
};

template <typename T, int G, typename F>
static int da_by_d(int d, F&& f) {
  if (d <= 64) return f((T*)nullptr, DaTag<G, 64>());
  if (d <= 128) return f((T*)nullptr, DaTag<G, 128>());
  if (d <= 256) return f((T*)nullptr, DaTag<G, 256>());
  return (int)cudaErrorInvalidValue;
}
template <typename T, typename F>
static int da_by_group(int group, int d, F&& f) {
  if (group <= 1) return da_by_d<T, 1>(d, f);
  if (group <= 2) return da_by_d<T, 2>(d, f);
  if (group <= 4) return da_by_d<T, 4>(d, f);
  if (group <= 8) return da_by_d<T, 8>(d, f);
  return (int)cudaErrorInvalidValue;
}
// f(T*, DaTag<G, DMAX>) on the kernel variant of (dtype, group, d)
template <typename F>
static int da_dispatch(int dtype, int group, int d, F&& f) {
  if (dtype == 0) return da_by_group<float>(group, d, f);
  if (dtype == 1) return da_by_group<__nv_bfloat16>(group, d, f);
  return (int)cudaErrorInvalidValue;
}

static bool da_valid(int B, int hkv, int group, int S, int d, int dtype) {
  return B >= 1 && B <= DA_MAX_BATCH && hkv >= 1 &&
         (long long)B * hkv <= (1 << 24) && group >= 1 && group <= 8 &&
         S >= 1 && S <= (1 << 30) && d >= 16 && d <= 256 && d % 8 == 0 &&
         (dtype == 0 || dtype == 1);
}

static int da_elem(int dtype) { return dtype == 0 ? 4 : 2; }

// Once per (device, variant, B): raise the variant's dynamic shared-memory
// limit to the device's opt-in maximum and return its blocks per SM at the
// layout of (B, group, d), and that layout's bytes: out = {blocks, bytes}.
extern "C" int flare_decode_prepare(int dtype, int B, int group, int d,
                                    int* out) {
  if (!da_valid(B, 1, group, 1, d, dtype)) return (int)cudaErrorInvalidValue;
  const DaLayout lay = da_layout(B, group, d, da_elem(dtype));
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (lay.total > optin) return (int)cudaErrorInvalidValue;
  return da_dispatch(dtype, group, d, [&](auto tp, auto tag) {
    using T = std::remove_pointer_t<decltype(tp)>;
    constexpr int G = decltype(tag)::G, DM = decltype(tag)::DMAX;
    cudaError_t err = cudaFuncSetAttribute(
        flare_decode_kernel<T, G, DM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flare_decode_kernel<T, G, DM>, DA_THREADS, lay.total);
    if (err != cudaSuccess) return (int)err;
    out[0] = blocks;
    out[1] = lay.total;
    return blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
  });
}

// Resources of the variant of (dtype, group, d): registers and local
// (spill) bytes per thread, static and dynamic shared bytes per block at
// batch B, threads per block.
extern "C" int flare_decode_attention_attrs(int dtype, int B, int group,
                                            int d, int* out) {
  if (!da_valid(B, 1, group, 1, d, dtype)) return (int)cudaErrorInvalidValue;
  const DaLayout lay = da_layout(B, group, d, da_elem(dtype));
  return da_dispatch(dtype, group, d, [&](auto tp, auto tag) {
    using T = std::remove_pointer_t<decltype(tp)>;
    constexpr int G = decltype(tag)::G, DM = decltype(tag)::DMAX;
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, flare_decode_kernel<T, G, DM>);
    if (err != cudaSuccess) return (int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = (int)fa.sharedSizeBytes;
    out[3] = lay.total;
    out[4] = DA_THREADS;
    return 0;
  });
}

// dtype: 0 float32, 1 bfloat16.  grid: blocks_per_sm (flare_decode_prepare)
// x SMs.  scratch: int32 words, laid out as
//   [B * hkv] tickets, [4] (chunk, items, -, -),
//   then f32 acc [I][group][d], m [I][group], l [I][group],
//   with I = grid + B * hkv partial slots (block x's segment of pair j
//   in slot x + j).
extern "C" int flare_decode_attention(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* o, int B, int hkv, int group,
                                      int S, int d, float scale, int dtype,
                                      int grid, void* scratch, void* stream) {
  if (!da_valid(B, hkv, group, S, d, dtype) || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DaArgs a;
  a.q = q; a.k = k; a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.o = o;
  a.B = B; a.hkv = hkv; a.group = group; a.S = S; a.d = d;
  a.scale = scale;
  a.target = (long long)DA_ITEMS_PER_BLOCK * grid;
  a.lay = da_layout(B, group, d, da_elem(dtype));
  const long long pairs = (long long)B * hkv;
  const long long items = (long long)grid + pairs;   // partial slots
  const long long head = (pairs + 4 + 3) / 4 * 4;
  int* words = static_cast<int*>(scratch);
  a.ctr = words;
  a.sched = words + pairs;
  a.pacc = reinterpret_cast<float*>(words + head);
  a.pm = a.pacc + items * group * d;
  a.pl = a.pm + items * group;
  cudaError_t e = cudaMemsetAsync(words, 0, (size_t)(pairs + 4) * 4, s);
  if (e != cudaSuccess) return (int)e;
  return da_dispatch(dtype, group, d, [&](auto tp, auto tag) {
    using T = std::remove_pointer_t<decltype(tp)>;
    constexpr int G = decltype(tag)::G, DM = decltype(tag)::DMAX;
    flare_decode_kernel<T, G, DM><<<grid, DA_THREADS, a.lay.total, s>>>(a);
    return (int)cudaGetLastError();
  });
}
