// Fused paged attention over the KV pool, for Hopper (sm_90a): single-query
// decode (optionally folding the speculative draft's tick-local ring) and
// the multi-query speculative verify.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/paged_attention.py:
//
//   * `paged_decode_attention` (`_kernel_bf16`, `_kernel_packed`,
//     `_online_update`, `_init_scratch`, `_store_out`), plus the draft's
//     ring fold, which the reference computes in its jnp lowering
//     (`paged_decode_attention_xla`, extra_k/extra_v/extra_pos) and not in
//     Pallas: each slot's query attends to its keys by reading the pool
//     THROUGH `page_table` (-1 marks an unallocated page) with an online
//     softmax in f32, so no gathered [B, n_pp * page_size] copy of the KV
//     cache ever exists. Keys at offsets past the slot's position are
//     masked (-1e30), pages that are unallocated or lie wholly past the
//     position are skipped, and a slot with no valid key (an inactive slot,
//     page table row all -1) emits exact zeros. With the ring fold, the
//     slot's R ring entries (bf16 [B, R, Hkv, dh], valid iff
//     extra_pos >= 0) are folded into the same online softmax after the
//     pages; a slot with no valid ring entry keeps its state.
//   * `paged_verify_attention` (`_kernel_bf16_mq`, `_kernel_packed_mq`,
//     `_online_update_mq`): the same page loop for a block of S queries
//     per slot, each with its own position. A page is skipped when it is
//     unallocated or lies wholly past the slot's LAST query; inside a page
//     each row masks keys past its own position. A row at position -1 (a
//     slot past its draft budget) adds no mass, so its l stays 0 and it
//     emits exact zeros. A valid row whose keys on a page are all masked
//     adds exp(-1e30 - m) = 0 once m holds a real score, as in the
//     reference.
//
// Packed pools hold four int8 lanes per 32-bit word along head_dim with an
// f32 scale per (token, kv-head).
//
// What bounds them on an H100: the bytes of the KV pages the slots own,
// over HBM (3.35 TB/s): one layer of the serving path's pools is 5.9 MB
// (bf16) or 3.1 MB (int8), 1-2 us. The FLOPs are ~2 per byte for decode
// and ~2 S per byte for the verify (S <= 5 here), far below the card's
// ~295 FLOP/byte balance point, so CUDA cores do the arithmetic. At the
// serving shapes (8 slots x 16 kv-heads, ~12 pages a slot) a kernel that
// walks a slot's pages in one block in series is bound by latency: one
// DRAM round trip per page. The design is about keeping bytes in flight:
//
// * Split-KV over a cluster. The grid is (slot, kv-head, row block x
//   split). The wrapper picks the split count from shapes alone
//   (`paged_attention.attention_plan`): as many as keep the blocks within
//   one wave of resident blocks, at most 8, the portable cluster size.
//   Each block reads q_pos and the table on the device and takes a
//   contiguous 1/splits of its slot's live pages (those at or before the
//   slot's last query), so the wrapper never reads either on the host.
//   The ring goes to the last rank, after its pages. Ranks merge their
//   partial (m, l, acc) in rank order: each pushes every output element's
//   partial into the shared memory of the rank that finishes it
//   (distributed shared memory: remote stores, one cluster barrier, local
//   reads). One launch, no workspace, no atomics, and two calls give
//   bit-identical outputs.
// * Coalesced copies in flight. A block copies its pages with `cp.async`
//   (16 bytes a thread where the rows and pointers allow, else 4) into a
//   ring of STAGES steps of STEP_PAGES pages in shared memory, in their
//   stored type (bf16, or packed words plus scales), so the next steps'
//   bytes are on their way while one is scored. The ring's copies start
//   before the first page's.
// * Work spread over every thread. One query row (decode at G = 1): a key
//   row is read by dh/8 lanes, 8 dims each (one 16-byte shared load of
//   bf16, 8 bytes of packed words); the block's 128 threads form
//   128 / (dh/8) streams that take the keys in turn. Each score is one
//   warp-shuffle reduction over its row's lanes and costs one exp
//   (`fold_keys`); m, l and acc stay in registers per stream and merge by
//   shuffles within a warp, then once per block through shared memory.
//   Several rows (the verify, G > 1) at dh = 64 or 128: the tensor-core
//   path (`fold_keys_mma`) holds 16 rows a block and scores 8 keys a warp
//   per `mma.sync` group, Q K^T and P V on bf16 MMAs with f32 sums, p in
//   two bf16 terms; the CUDA-core work that grew with the rows is gone.
//   Either way the merge weights partials by exp(m_i - m), so a stream,
//   warp or split whose keys were all masked for a row (m = -1e30,
//   l > 0) drops out. Registers are capped for 4 blocks an SM: the kernel
//   is bound by latency, and resident warps hide it.
// * Precision as the reference: q is scaled by sm_scale in f32; packed
//   lanes are exact in f32, the K scale multiplies the score and the V
//   scale the probability.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STEP_PAGES = 2;  // pages of K and V a block scores at once
constexpr int STAGES = 3;      // steps a block has in flight (or scores)
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr int BLOCKS_PER_SM = 4;  // registers capped for this many
constexpr int MMA_ROWS = 16;  // rows a block of the tensor-core path holds
constexpr float MASK_VALUE = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the cluster barrier in two halves: arrive (release; relaxed orders
// nothing, for the start-up arrive) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// two bf16 of a 32-bit word as f32 (exact)
__device__ __forceinline__ void bf16x2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// dims 8c .. 8c + 7 of a staged row: 8 bf16 (16 bytes), or (PACKED) 8
// int8 lanes in two words (8 bytes), as f32
template <bool PACKED>
__device__ __forceinline__ void row8(const unsigned char* row, int c,
                                     float (&x)[8]) {
  if (PACKED) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + 8 * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = (float)(int8_t)(u.x >> (8 * e));
      x[4 + e] = (float)(int8_t)(u.y >> (8 * e));
    }
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(row + 16 * c);
    bf16x2(u.x, x[0], x[1]);
    bf16x2(u.y, x[2], x[3]);
    bf16x2(u.z, x[4], x[5]);
    bf16x2(u.w, x[6], x[7]);
  }
}

// Fold a run of staged keys into the streams' online-softmax states: key
// t (0 <= t < nkeys) is row t of `kst` and `vst`, taken iff its flag is
// >= 0 (PAGE: flag[t / ps], the table entry of its page; the ring:
// flag[t], its position). A page key past a row's position is masked
// (-1e30), and a row at -1 takes none, as in the reference; a ring key is
// taken by every row. Each stream takes keys ko, ko + ki, ...: a score is
// one shuffle reduction over the lpr lanes of its row, and each (row,
// key) costs one exp: p = exp(s - m), or, when s raises the max, the
// rescale exp(m - s) with p = 1, picked by selects, not a branch. Packed
// rows: the K scale multiplies the score, the V scale p.
template <int RT, bool KP, bool PAGE>
__device__ __forceinline__ void fold_keys(
    const float (&qr)[RT][8], const int (&rpos)[RT], const bool (&rex)[RT],
    float (&m)[RT], float (&l)[RT], float (&acc)[RT][8],
    const unsigned char* kst, const unsigned char* vst, int rbytes,
    const float* ksc, const float* vsc, const int* flag, int ps,
    int nkeys, int base, int ko, int ki, bool active, int c, int lpr) {
  const int trips = (nkeys + ki - 1) / ki;
  for (int it = 0; it < trips; ++it) {
    const int t = ko + it * ki;
    const int tk = active && t < nkeys ? t : 0;  // the row to read
    int f = tk;
    if (PAGE) {  // t / ps for t < STEP_PAGES * ps, without a division
      f = 0;
#pragma unroll
      for (int u = 1; u < STEP_PAGES; ++u) f += tk >= u * ps;
    }
    const bool ok = active && t < nkeys && flag[f] >= 0;
    float kx[8], s[RT];
    row8<KP>(kst + tk * rbytes, c, kx);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d = fmaf(qr[r][e], kx[e], d);
      s[r] = d;
    }
    // every lane runs the same trips, so the shuffles are uniform
    for (int o = lpr >> 1; o; o >>= 1)
#pragma unroll
      for (int r = 0; r < RT; ++r) s[r] += __shfl_xor_sync(FULL, s[r], o);
    if (!ok) continue;  // no shuffles below
    float vx[8];
    row8<KP>(vst + tk * rbytes, c, vx);
    const float kscale = KP ? ksc[tk] : 1.f;
    const float vscale = KP ? vsc[tk] : 1.f;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (!(PAGE ? rpos[r] >= 0 : rex[r])) continue;
      const float sc =
          !PAGE ? s[r] : (base + tk <= rpos[r] ? s[r] * kscale : MASK_VALUE);
      // one exp, and no branch for the streams of a warp to part at
      const bool up = sc > m[r];
      const float x = __expf(up ? m[r] - sc : sc - m[r]);
      const float alpha = up ? x : 1.f, p = up ? 1.f : x;
      m[r] = up ? sc : m[r];
      l[r] = fmaf(l[r], alpha, p);
      const float pv = p * vscale;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pv, vx[e], acc[r][e] * alpha);
    }
  }
}

// C[16x8] += A[16x16] . B[16x8], bf16 in, f32 accumulate. Fragments (g =
// lane / 4, t = lane % 4): A a0 = (row g, cols 2t, 2t+1), a1 = (row g+8,
// the same cols), a2, a3 = cols 2t+8, 2t+9; B b0 = (rows 2t, 2t+1, col g),
// b1 = rows 2t+8, 2t+9; C c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = row
// g+8. A 32-bit register holds two bf16, the lower column low.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two floats as bf16x2, rounded to nearest even (the lower one low)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// two int8 lanes as bf16x2 (exact)
__device__ __forceinline__ uint32_t int8x2_bf16(uint32_t lo, uint32_t hi) {
  return pack_bf16((float)(int8_t)lo, (float)(int8_t)hi);
}

// The tensor-core fold of a run of staged keys (as `fold_keys`) for the
// 16 query rows of a block: warp w takes the keys of groups w, w + WARPS,
// ... of 8. Per group: S[16 x 8] = Q K^T on DH / 16 MMAs (Q in bf16 as given;
// sm_scale and the K scale multiply the f32 scores); the row max over the
// group by quad shuffles, one rescale exp per row and one exp per (row,
// key); then P V on DH / 8 MMAs for each of p's two bf16 terms (hi + lo:
// p to 16 bits), P's keys 8-15 zero. Each lane keeps rows g and g + 8:
// m and its own part of l (summed over the quad at the end) and the C
// fragments of acc. A key that is not taken reads as zero in V, so a
// stale staged row cannot turn p = 0 into NaN.
template <int DH, bool KP, bool PAGE>
__device__ __forceinline__ void fold_keys_mma(
    const uint32_t (&qa)[DH / 16][4], const int (&rpos)[2],
    const bool (&rex)[2], float (&m)[2], float (&l)[2],
    float (&acc)[DH / 8][4], const unsigned char* kst,
    const unsigned char* vst, int rbytes, const float* ksc,
    const float* vsc, const int* flag, int ps, int nkeys, int base,
    int warp, int lane, float sm_scale) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 8 * warp; k0 < nkeys; k0 += 8 * WARPS) {  // warp-uniform
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const unsigned char* krow = kst + (k0 + g < nkeys ? k0 + g : 0) * rbytes;
#pragma unroll
    for (int kt = 0; kt < DH / 16; ++kt) {
      const int d = 16 * kt + 2 * t;
      uint32_t b0, b1;
      if (KP) {
        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(krow + d);
        const uint32_t w1 = *reinterpret_cast<const uint16_t*>(krow + d + 8);
        b0 = int8x2_bf16(w0, w0 >> 8);
        b1 = int8x2_bf16(w1, w1 >> 8);
      } else {
        b0 = *reinterpret_cast<const uint32_t*>(krow + 2 * d);
        b1 = *reinterpret_cast<const uint32_t*>(krow + 2 * d + 16);
      }
      mma_bf16(s, qa[kt][0], qa[kt][1], qa[kt][2], qa[kt][3], b0, b1);
    }
    // this lane's keys: k0 + 2t + j, j = 0, 1
    bool ok[2];
    int kk[2];
    float ks[2], vs[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + 2 * t + j;
      const bool in = k < nkeys;
      kk[j] = in ? k : 0;
      int f = kk[j];
      if (PAGE) {
        f = 0;
#pragma unroll
        for (int u = 1; u < STEP_PAGES; ++u) f += kk[j] >= u * ps;
      }
      ok[j] = in && flag[f] >= 0;
      // the scales of a key not taken are stale: p = 0 must not meet NaN
      ks[j] = KP && ok[j] ? ksc[kk[j]] : 1.f;
      vs[j] = !KP ? 1.f : ok[j] ? vsc[kk[j]] : 0.f;
    }
    float p[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      const bool row = PAGE ? rpos[h] >= 0 : rex[h];
      float sc[2], mx = m[h];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[j] = s[2 * h + j] * sm_scale * ks[j];
        if (PAGE && base + kk[j] > rpos[h]) sc[j] = MASK_VALUE;
        if (ok[j] && row) mx = fmaxf(mx, sc[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float alpha = __expf(m[h] - mx);  // 1 while the max holds
      m[h] = mx;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[2 * h + j] = ok[j] && row ? __expf(sc[j] - mx) : 0.f;
        ls += p[2 * h + j];
      }
      l[h] = fmaf(l[h], alpha, ls);
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        acc[nt][2 * h] *= alpha;
        acc[nt][2 * h + 1] *= alpha;
      }
    }
    // P in two bf16 terms, the V scale in it; keys 8-15 of the MMA zero
    float pv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[e] = p[e] * vs[e & 1];
    const uint32_t hi0 = pack_bf16(pv[0], pv[1]);
    const uint32_t hi1 = pack_bf16(pv[2], pv[3]);
    float lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t hw = e < 2 ? hi0 : hi1;
      lo[e] = pv[e] - __uint_as_float((e & 1 ? hw >> 16 : hw & 0xffffu) << 16);
    }
    const uint32_t lo0 = pack_bf16(lo[0], lo[1]);
    const uint32_t lo1 = pack_bf16(lo[2], lo[3]);
    const unsigned char* v0 = vst + kk[0] * rbytes;
    const unsigned char* v1 = vst + kk[1] * rbytes;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int d = 8 * nt + g;
      uint32_t x0, x1;
      if (KP) {
        x0 = int8x2_bf16(v0[d], 0) & 0xffffu;
        x1 = int8x2_bf16(v1[d], 0) & 0xffffu;
      } else {
        x0 = *reinterpret_cast<const uint16_t*>(v0 + 2 * d);
        x1 = *reinterpret_cast<const uint16_t*>(v1 + 2 * d);
      }
      const uint32_t b0 = (ok[0] ? x0 : 0u) | ((ok[1] ? x1 : 0u) << 16);
      mma_bf16(acc[nt], hi0, hi1, 0u, 0u, b0, 0u);
      mma_bf16(acc[nt], lo0, lo1, 0u, 0u, b0, 0u);
    }
  }
}

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

// Byte offsets of the dynamic shared memory, the same on host and device
// (`paged_attention.block_smem` mirrors the total for the split rule).
struct Layout {
  int row_bytes;    // one token row of one head in the pool
  int stage_bytes;  // STEP_PAGES pages of K and V (and scales)
  int ring, table, qpos, acc, m, l, in_acc, in_m, in_l, total;

  __host__ __device__ Layout(bool packed, bool ring_fold, int ps, int dh,
                             int R, int n_pp, int S, int rt, int splits) {
    row_bytes = packed ? dh : 2 * dh;
    stage_bytes = round16(STEP_PAGES * (2 * ps * row_bytes +
                                        (packed ? 8 * ps : 0)));
    // rows of partials (streams x rt; with MMA_ROWS, warps x 16) and
    // rows a block finishes
    const int prows = rt == MMA_ROWS ? WARPS * MMA_ROWS : THREADS / (dh / 8) * rt;
    const int brows = rt == MMA_ROWS ? MMA_ROWS : prows;
    // the partials [prows][dh] f32 take the stages' place once the pages
    // are scored
    acc = 0;
    int o = max(STAGES * stage_bytes, 4 * prows * dh);
    ring = o;
    if (ring_fold) o += round16(4 * R * dh + 4 * R);
    table = o;
    o += round16(4 * n_pp);
    qpos = o;
    o += round16(4 * S);
    m = o;                        // [prows]
    o += 4 * prows;
    l = o;
    o += 4 * prows;
    // the inbox of the split merge: [splits][share] elements and
    // [splits][rows] m and l, share = ceil(rows * dh / splits)
    const int share = splits > 1 ? (brows * dh + splits - 1) / splits : 0;
    in_acc = o;
    o += 4 * splits * share;
    in_m = o;
    o += splits > 1 ? 4 * splits * brows : 0;
    in_l = o;
    o += splits > 1 ? 4 * splits * brows : 0;
    total = o;
  }
};

// One block per (slot b, kv-head h, row block x split) over S*G query rows
// (row r = query sq * g + group member gi); decode is S = 1. q and out are
// [B, S, hkv, g, dh], q_pos [B, S]. RING folds the slot's R draft-ring
// entries in after the pages, on the last rank. RT rows a stream, or, with
// RT = MMA_ROWS, the tensor-core path (`fold_keys_mma`) for heads of
// width DH.
template <bool PACKED, bool RING, int RT, int DH>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const unsigned char* __restrict__ k_pages,
                       const unsigned char* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ q_pos,
                       const unsigned char* __restrict__ extra_k,
                       const unsigned char* __restrict__ extra_v,
                       const int* __restrict__ extra_pos,
                       __nv_bfloat16* __restrict__ out, int n_pp, int ps,
                       int hkv, int g, int dh, int S, int R, float sm_scale,
                       int splits, int vec) {
  constexpr bool MMA = RT == MMA_ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(PACKED, RING, ps, dh, R, n_pp, S, RT, splits);
  int* table = reinterpret_cast<int*>(smem + lay.table);
  int* qpos = reinterpret_cast<int*>(smem + lay.qpos);
  float* pacc = reinterpret_cast<float*>(smem + lay.acc);
  float* pm = reinterpret_cast<float*>(smem + lay.m);
  float* pl = reinterpret_cast<float*>(smem + lay.l);
  float* in_acc = reinterpret_cast<float*>(smem + lay.in_acc);
  float* in_m = reinterpret_cast<float*>(smem + lay.in_m);
  float* in_l = reinterpret_cast<float*>(smem + lay.in_l);
  const int rbytes = lay.row_bytes;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lpr = dh >> 3;          // lanes a key row: 8 dims each
  const int ns = THREADS / lpr;     // streams
  const int sid = tid / lpr, c = tid - sid * lpr;
  const int b = blockIdx.x, h = blockIdx.y;
  const int rank = blockIdx.z % splits, rb = blockIdx.z / splits;
  const int rows = S * g;
  // chunks of RT rows; streams of a chunk share its keys. The tensor-core
  // path is one chunk of MMA_ROWS rows whose warps share the keys
  const int chunk0 = MMA ? rb : rb * ns;  // this block's first chunk
  const int nchunks = MMA ? 1 : min(ns, (rows + RT - 1) / RT - chunk0);
  const int ki = MMA ? WARPS : ns / nchunks;
  const int cl = MMA ? 0 : sid / ki, ko = MMA ? warp : sid - cl * ki;
  const bool active = cl < nchunks;
  const int row0 = (chunk0 + (active ? cl : 0)) * RT;
  const bool ring_rank = RING && rank == splits - 1;
  // start the cluster barrier that the merge waits on before it writes
  // into other blocks' shared memory (they must be running by then)
  if (splits > 1) cluster_arrive_relaxed();

  // the ring's copies go first: they need nothing from the table
  if (ring_rank) {
    unsigned char* rk = smem + lay.ring;
    unsigned char* rv = rk + 2 * R * dh;
    const int shift = __ffs(vec ? (2 * dh) / 16 : (2 * dh) / 4) - 1;
    const int cpr = 1 << shift;
    for (int i = tid; i < 2 * R * cpr; i += THREADS) {
      const int which = i >= R * cpr, rem = i - which * R * cpr;
      const int t = rem >> shift, ch = rem & (cpr - 1);
      const size_t src = ((((size_t)b * R + t) * hkv + h) * dh) * 2;
      unsigned char* dst = (which ? rv : rk) + t * 2 * dh;
      const unsigned char* s = (which ? extra_v : extra_k) + src;
      if (vec)
        cp_async16(dst + 16 * ch, s + 16 * ch);
      else
        cp_async4(dst + 4 * ch, s + 4 * ch);
    }
    int* epos = reinterpret_cast<int*>(rv + 2 * R * dh);
    for (int i = tid; i < R; i += THREADS) epos[i] = extra_pos[(size_t)b * R + i];
  }
  for (int i = tid; i < n_pp; i += THREADS)
    table[i] = page_table[(size_t)b * n_pp + i];
  for (int i = tid; i < S; i += THREADS) qpos[i] = q_pos[(size_t)b * S + i];

  // rows a lane holds: its stream's RT rows, or (MMA) rows g and g + 8 of
  // the block's 16 (g = lane / 4)
  constexpr int NR = MMA ? 2 : RT;
  const int gq = lane >> 2, tq = lane & 3;
  auto row_of = [&](int r) { return MMA ? row0 + gq + 8 * r : row0 + r; };
  // this lane's 8 dims of its RT query rows, scaled in f32; or (MMA) its
  // A fragments of the block's rows, bf16 as given
  float qr[MMA ? 1 : RT][8];
  uint32_t qa[MMA ? DH / 16 : 1][4];
  bool rex[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) rex[r] = active && row_of(r) < rows;
  if constexpr (MMA) {
    const __nv_bfloat16* qrow[2];  // rows g and g + 8, at this lane's cols
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_of(r);
      qrow[r] = q + ((((size_t)b * S + row / g) * hkv + h) * g + row % g) *
                        dh + 2 * tq;
    }
#pragma unroll
    for (int kt = 0; kt < DH / 16; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a0..a3: rows g, g+8; cols 2t, 2t+8
        const int r = e & 1;
        const __nv_bfloat16* src = qrow[r] + 16 * kt + 8 * (e >> 1);
        qa[kt][e] = !rex[r] ? 0u
                    : vec   ? *reinterpret_cast<const uint32_t*>(src)
                            : (uint32_t)__bfloat16_as_ushort(src[0]) |
                                  ((uint32_t)__bfloat16_as_ushort(src[1])
                                   << 16);
      }
  }
#pragma unroll
  for (int r = 0; r < (MMA ? 0 : RT); ++r) {
    const int row = row0 + r;
    if (rex[r]) {
      const int sq = row / g, gi = row - sq * g;
      const __nv_bfloat16* src =
          q + ((((size_t)b * S + sq) * hkv + h) * g + gi) * dh + 8 * c;
      if (vec) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        bf16x2(u.x, qr[r][0], qr[r][1]);
        bf16x2(u.y, qr[r][2], qr[r][3]);
        bf16x2(u.z, qr[r][4], qr[r][5]);
        bf16x2(u.w, qr[r][6], qr[r][7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[r][e] = __bfloat162float(src[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[r][e] *= sm_scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[r][e] = 0.f;
    }
  }
  __syncthreads();

  int rpos[NR];  // each row's position; -1 for rows at -1 and padding
#pragma unroll
  for (int r = 0; r < NR; ++r) rpos[r] = rex[r] ? qpos[row_of(r) / g] : -1;
  int max_pos = -1;  // the slot's last query: uniform across the block
  for (int sq = 0; sq < S; ++sq) max_pos = max(max_pos, qpos[sq]);
  const int n_live = max_pos < 0 ? 0 : min(n_pp, max_pos / ps + 1);
  const int per = (n_live + splits - 1) / splits;
  const int j0 = rank * per;
  const int n = max(0, min(n_live, j0 + per) - j0);  // this rank's pages

  const int j1 = j0 + n;
  auto stage = [&](int st) { return smem + (size_t)st * lay.stage_bytes; };
  // copy step st's page columns (STEP_PAGES from j0 + st * STEP_PAGES, up
  // to j1) into stage slot `slot`: K rows, V rows (and K, V scales), each
  // [STEP_PAGES * ps]; nothing for an unallocated page
  auto issue = [&](int st, int slot) {
    const int c0 = j0 + st * STEP_PAGES;
    const int keys = min(STEP_PAGES, j1 - c0) * ps;
    const int span = STEP_PAGES * ps;
    unsigned char* sk = stage(slot);
    // copies a row: a power of two, as dh / 8 is
    const int shift = __ffs(vec ? rbytes / 16 : rbytes / 4) - 1;
    const int cpr = 1 << shift;
    for (int i = tid; i < 2 * keys * cpr; i += THREADS) {
      const int which = i >= keys * cpr, rem = i - which * keys * cpr;
      const int tr = rem >> shift, ch = rem & (cpr - 1);
      int pg = 0;
#pragma unroll
      for (int u = 1; u < STEP_PAGES; ++u) pg += tr >= u * ps;
      const int page = table[c0 + pg];
      if (page < 0) continue;
      const size_t tok = ((size_t)page * ps + tr - pg * ps) * hkv + h;
      const unsigned char* src = (which ? v_pages : k_pages) + tok * rbytes;
      unsigned char* dst = sk + (which * span + tr) * rbytes;
      if (vec)
        cp_async16(dst + 16 * ch, src + 16 * ch);
      else
        cp_async4(dst + 4 * ch, src + 4 * ch);
    }
    if (PACKED) {
      float* sc = reinterpret_cast<float*>(sk + 2 * span * rbytes);
      for (int i = tid; i < 2 * keys; i += THREADS) {
        const int which = i >= keys, tr = i - which * keys;
        int pg = 0;
#pragma unroll
        for (int u = 1; u < STEP_PAGES; ++u) pg += tr >= u * ps;
        const int page = table[c0 + pg];
        if (page < 0) continue;
        const size_t tok = ((size_t)page * ps + tr - pg * ps) * hkv + h;
        cp_async4(sc + which * span + tr, (which ? v_scale : k_scale) + tok);
      }
    }
  };

  float m[NR], l[NR], acc[MMA ? DH / 8 : RT][MMA ? 4 : 8];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = MASK_VALUE;
    l[r] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < (MMA ? DH / 8 : RT); ++r)
#pragma unroll
    for (int e = 0; e < (MMA ? 4 : 8); ++e) acc[r][e] = 0.f;

  const int steps = (n + STEP_PAGES - 1) / STEP_PAGES;
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) issue(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i landed; every stream is done with step i - 1
    if (i + STAGES - 1 < steps) issue(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const int c0 = j0 + i * STEP_PAGES;
    const int span = STEP_PAGES * ps;
    const unsigned char* sk = stage(i % STAGES);
    const float* sc = reinterpret_cast<const float*>(sk + 2 * span * rbytes);
    const int nkeys = min(STEP_PAGES, j1 - c0) * ps;
    if constexpr (MMA)
      fold_keys_mma<DH, PACKED, true>(qa, rpos, rex, m, l, acc, sk,
                                      sk + span * rbytes, rbytes, sc,
                                      sc + span, table + c0, ps, nkeys,
                                      c0 * ps, warp, lane, sm_scale);
    else
      fold_keys<RT, PACKED, true>(qr, rpos, rex, m, l, acc, sk,
                                  sk + span * rbytes, rbytes, sc, sc + span,
                                  table + c0, ps, nkeys, c0 * ps, ko, ki,
                                  active, c, lpr);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's copies landed; the stages are free

  if (ring_rank && R > 0) {
    const unsigned char* rk = smem + lay.ring;
    const unsigned char* rv = rk + 2 * R * dh;
    const int* epos = reinterpret_cast<const int*>(rv + 2 * R * dh);
    // an entry at -1 is not taken: it would add exp(-1e30 - m) = 0
    if constexpr (MMA)
      fold_keys_mma<DH, false, false>(qa, rpos, rex, m, l, acc, rk, rv,
                                      2 * dh, nullptr, nullptr, epos, 0, R,
                                      0, warp, lane, sm_scale);
    else
      fold_keys<RT, false, false>(qr, rpos, rex, m, l, acc, rk, rv, 2 * dh,
                                  nullptr, nullptr, epos, 0, R, 0, ko, ki,
                                  active, c, lpr);
  }

  // merge the streams of a chunk, weights exp(m_i - m): first the streams
  // of a warp by shuffles, when a chunk spans whole warps (decode and
  // every row in one chunk), then the warps' partials through shared
  // memory in stream order
  const int spw = 32 / lpr;                   // streams a warp
  // uniform across the block; the tensor-core path merges its warps'
  // partials through shared memory only
  const int step = !MMA && ki % spw == 0 ? spw : 1;
  if constexpr (!MMA)
    for (int o = lpr; o < lpr * step; o <<= 1) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float mo = __shfl_xor_sync(FULL, m[r], o);
        const float lo = __shfl_xor_sync(FULL, l[r], o);
        const float mx = fmaxf(m[r], mo);
        const float w = __expf(m[r] - mx), wo = __expf(mo - mx);
        m[r] = mx;
        l[r] = w * l[r] + wo * lo;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[r][e] = w * acc[r][e] + wo * __shfl_xor_sync(FULL, acc[r][e], o);
      }
    }
  if constexpr (MMA) {
    // l over the quad; then each warp's partial of the block's 16 rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
    }
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pacc[(warp * MMA_ROWS + gq + 8 * (e >> 1)) * dh + 8 * nt + 2 * tq +
             (e & 1)] = acc[nt][e];
    if (tq == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        pm[warp * MMA_ROWS + gq + 8 * r] = m[r];
        pl[warp * MMA_ROWS + gq + 8 * r] = l[r];
      }
  } else if (active && sid % step == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float4* dst = reinterpret_cast<float4*>(pacc + (sid * RT + r) * dh + 8 * c);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      if (c == 0) {
        pm[sid * RT + r] = m[r];
        pl[sid * RT + r] = l[r];
      }
    }
  }
  __syncthreads();

  // each output element of the block's rows: its (m, l, acc) over the
  // partials; with one split, the output. With more, the element goes to
  // the rank that finishes it (a 1/splits share each), into that rank's
  // inbox in distributed shared memory, with each row's m and l to every
  // rank: remote stores only, one cluster barrier, then local reads
  const int nrows = nchunks * RT;  // the block's rows, padding included
  const int dsh = __ffs(dh) - 1;   // dh is a power of two
  const int parts = ki / step;     // partials a chunk
  const int total = nrows * dh;
  const int share = (total + splits - 1) / splits;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) cluster_wait();  // every block of the cluster is running
  for (int e = tid; e < total; e += THREADS) {
    const int lr = e >> dsh, d = e & (dh - 1);
    const int ch = lr / RT, r = lr - ch * RT;
    const int row = (chunk0 + ch) * RT + r;
    if (row >= rows) continue;
    const int i0 = ch * ki * RT + r;  // the chunk's first partial
    float mx = MASK_VALUE;
    for (int k = 0; k < parts; ++k) mx = fmaxf(mx, pm[i0 + k * step * RT]);
    float ls = 0.f, a = 0.f;
    for (int k = 0; k < parts; ++k) {
      const int i = i0 + k * step * RT;
      const float w = __expf(pm[i] - mx);
      ls = fmaf(w, pl[i], ls);
      a = fmaf(w, pacc[i * dh + d], a);
    }
    if (splits == 1) {
      const int sq = row / g, gi = row - sq * g;
      out[((((size_t)b * S + sq) * hkv + h) * g + gi) * dh + d] =
          __float2bfloat16(a / fmaxf(ls, 1e-30f));
      continue;
    }
    const int owner = e / share;
    cluster.map_shared_rank(in_acc, owner)[rank * share + e - owner * share] = a;
    if (d == 0)
      for (int k = 0; k < splits; ++k) {
        cluster.map_shared_rank(in_m, k)[rank * nrows + lr] = mx;
        cluster.map_shared_rank(in_l, k)[rank * nrows + lr] = ls;
      }
  }
  if (splits == 1) return;
  cluster_arrive();  // release: this block's stores are visible ...
  cluster_wait();    // ... acquire: every block's stores to this inbox are
  const int lo = rank * share, hi = min(lo + share, total);
  for (int e = lo + tid; e < hi; e += THREADS) {
    const int lr = e >> dsh, d = e & (dh - 1);
    const int ch = lr / RT, r = lr - ch * RT;
    const int row = (chunk0 + ch) * RT + r;
    if (row >= rows) continue;
    float mx = MASK_VALUE;
    for (int k = 0; k < splits; ++k) mx = fmaxf(mx, in_m[k * nrows + lr]);
    float ls = 0.f, a = 0.f;
    for (int k = 0; k < splits; ++k) {  // rank order
      const float w = __expf(in_m[k * nrows + lr] - mx);
      ls = fmaf(w, in_l[k * nrows + lr], ls);
      a = fmaf(w, in_acc[k * share + e - lo], a);
    }
    const int sq = row / g, gi = row - sq * g;
    out[((((size_t)b * S + sq) * hkv + h) * g + gi) * dh + d] =
        __float2bfloat16(a / fmaxf(ls, 1e-30f));
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool PACKED, bool RING, int RT, int DH>
int launch_rt(const void* q, const void* k_pages, const void* v_pages,
              const void* k_scale, const void* v_scale,
              const void* page_table, const void* q_pos, const void* extra_k,
              const void* extra_v, const void* extra_pos, void* out, int B,
              int n_pp, int ps, int hkv, int g, int dh, int S, int R,
              float sm_scale, int splits, cudaStream_t stream) {
  const Layout lay(PACKED, RING, ps, dh, R, n_pp, S, RT, splits);
  const size_t smem = (size_t)lay.total;
  auto kernel = paged_attention_kernel<PACKED, RING, RT, DH>;
  if (smem > 48 * 1024) {
    // once per device and size: the attribute outlives the launch
    static size_t opted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || opted[dev] < smem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) opted[dev] = smem;
    }
  }
  const int chunks = (S * g + RT - 1) / RT;  // chunks a block: 1 or ns
  const int per_block = RT == MMA_ROWS ? 1 : THREADS / (dh / 8);
  const int row_blocks = (chunks + per_block - 1) / per_block;
  const int vec = lay.row_bytes % 16 == 0 && aligned16(q) &&
                  aligned16(k_pages) && aligned16(v_pages) &&
                  (!RING || (aligned16(extra_k) && aligned16(extra_v)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, hkv, splits * row_blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;  // the KV splits of one (slot, head)
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const __nv_bfloat16*)q, (const unsigned char*)k_pages,
      (const unsigned char*)v_pages, (const float*)k_scale,
      (const float*)v_scale, (const int*)page_table, (const int*)q_pos,
      (const unsigned char*)extra_k, (const unsigned char*)extra_v,
      (const int*)extra_pos, (__nv_bfloat16*)out, n_pp, ps, hkv, g, dh, S, R,
      sm_scale, splits, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool PACKED, bool RING>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* q_pos, const void* extra_k, const void* extra_v,
           const void* extra_pos, void* out, int B, int n_pp, int ps, int hkv,
           int g, int dh, int S, int R, float sm_scale, int splits, int rt,
           cudaStream_t stream) {
  // dh / 8 lanes a key row must tile a warp; the plan's split and rows
  // per stream must be ones the kernel was built for
  const int lpr = dh / 8;
  if (dh % 8 || lpr > 32 || (lpr & (lpr - 1)) || splits < 1 ||
      splits > MAX_SPLITS || B < 1 || S < 1 || g < 1 || ps < 1 ||
      n_pp < 0 || R < 0)
    return (int)cudaErrorInvalidValue;
#define PA_LAUNCH(RT, DH)                                                  \
  return launch_rt<PACKED, RING, RT, DH>(                                  \
      q, k_pages, v_pages, k_scale, v_scale, page_table, q_pos, extra_k,   \
      extra_v, extra_pos, out, B, n_pp, ps, hkv, g, dh, S, R, sm_scale,    \
      splits, stream)
  switch (rt) {
    case 1: PA_LAUNCH(1, 0);
    case MMA_ROWS:  // the tensor-core path, for the head widths it has
      if (dh == 64) PA_LAUNCH(MMA_ROWS, 64);
      if (dh == 128) PA_LAUNCH(MMA_ROWS, 128);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PA_LAUNCH
}

}  // namespace

extern "C" {

// The three launchers run one kernel; they stay separate entry points so
// that their launches are counted apart. `splits` (1-8, the cluster size)
// and `rt` (1: one row a stream; MMA_ROWS: the tensor-core path, for
// dh = 64 or 128) come from the wrapper's
// plan (`paged_attention.attention_plan`); anything else is refused with
// cudaErrorInvalidValue, as is a head_dim that is not 8 x a power of two
// up to 256.

// q bf16 [B, hkv*g, dh]; pools [P, ps, hkv, dh] bf16, or (packed != 0)
// uint32 [P, ps, hkv, dh/4] with f32 scales [P, ps, hkv]; page_table int32
// [B, n_pp]; q_pos int32 [B]; out bf16 [B, hkv*g, dh]; all contiguous.
// Returns cudaGetLastError().
int paged_decode_attention_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scale,
                                  const void* v_scale,
                                  const void* page_table, const void* q_pos,
                                  void* out, int B, int n_pp, int ps,
                                  int hkv, int g, int dh, float sm_scale,
                                  int packed, int splits, int rt,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (packed)
    return launch<true, false>(q, k_pages, v_pages, k_scale, v_scale,
                               page_table, q_pos, nullptr, nullptr, nullptr,
                               out, B, n_pp, ps, hkv, g, dh, 1, 0, sm_scale,
                               splits, rt, st);
  return launch<false, false>(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, q_pos, nullptr, nullptr, nullptr,
                              out, B, n_pp, ps, hkv, g, dh, 1, 0, sm_scale,
                              splits, rt, st);
}

// As paged_decode_attention_launch, with q_pos bounding the POOL read and
// the draft ring folded in after the pages: extra_k/extra_v bf16
// [B, R, hkv, dh], extra_pos int32 [B, R] (an entry is valid iff >= 0).
int paged_decode_ring_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* q_pos, const void* extra_k, const void* extra_v,
    const void* extra_pos, void* out, int B, int n_pp, int ps, int hkv,
    int g, int dh, int R, float sm_scale, int packed, int splits, int rt,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (packed)
    return launch<true, true>(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, q_pos, extra_k, extra_v, extra_pos,
                              out, B, n_pp, ps, hkv, g, dh, 1, R, sm_scale,
                              splits, rt, st);
  return launch<false, true>(q, k_pages, v_pages, k_scale, v_scale,
                             page_table, q_pos, extra_k, extra_v, extra_pos,
                             out, B, n_pp, ps, hkv, g, dh, 1, R, sm_scale,
                             splits, rt, st);
}

// q bf16 [B, S, hkv*g, dh]; q_pos int32 [B, S] (-1 = masked row); pools,
// scales and page_table as above; out bf16 [B, S, hkv*g, dh].
int paged_verify_attention_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scale,
                                  const void* v_scale,
                                  const void* page_table, const void* q_pos,
                                  void* out, int B, int n_pp, int ps,
                                  int hkv, int g, int dh, int S,
                                  float sm_scale, int packed, int splits,
                                  int rt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (packed)
    return launch<true, false>(q, k_pages, v_pages, k_scale, v_scale,
                               page_table, q_pos, nullptr, nullptr, nullptr,
                               out, B, n_pp, ps, hkv, g, dh, S, 0, sm_scale,
                               splits, rt, st);
  return launch<false, false>(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, q_pos, nullptr, nullptr, nullptr,
                              out, B, n_pp, ps, hkv, g, dh, S, 0, sm_scale,
                              splits, rt, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
