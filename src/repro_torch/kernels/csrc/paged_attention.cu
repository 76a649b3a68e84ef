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
//     slot past its draft budget) has its probabilities zeroed, so its
//     l stays 0 and it emits exact zeros. A valid row whose keys on a page
//     are all masked adds exp(-1e30 - m) = 0 once m holds a real score, as
//     in the reference.
//
// Packed pools hold four int8 lanes per 32-bit word along head_dim with an
// f32 scale per (token, kv-head); lanes are unpacked and rescaled as the
// page is staged.
//
// What bounds them on an H100: the bytes of the KV pages the slots own,
// over HBM (3.35 TB/s); the FLOPs are ~2 per byte read for decode and
// ~2 S per byte for the verify (S <= 5 here), still far below the card's
// ~295 FLOP/byte balance point. The TPU's sequential page grid axis
// becomes a loop inside the block: one block per (slot, kv-head), 128
// threads, which loads its own page-table entries, stages one page of K
// and V for its head in shared memory as f32, scores its query rows
// (G for decode, S*G for the verify) against the page, and folds the page
// into m/l/acc kept in shared memory, so each page is read from HBM once
// per (slot, kv-head) whatever S is. Both are one kernel: decode is the
// verify at S = 1, with a template flag for the ring fold. The
// shared-memory size grows with S*G and is set per launch. Simple and right first; splitting long
// contexts across blocks and overlapping page loads with compute are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float MASK_VALUE = -1e30f;

__device__ __forceinline__ float int8_lane(uint32_t word, int lane) {
  return (float)(int)(int8_t)((word >> (8 * lane)) & 0xffu);
}

// Stage pool page `page` of kv-head h into ks/vs [ps, dh] as f32.
template <bool PACKED>
__device__ __forceinline__ void stage_page(
    float* ks, float* vs, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, int page, int ps, int hkv, int h,
    int dh) {
  for (int i = threadIdx.x; i < ps * dh; i += THREADS) {
    const int t = i / dh, d = i - t * dh;
    const size_t tok = ((size_t)page * ps + t) * hkv + h;
    if (PACKED) {
      const int w = dh / 4;
      const uint32_t kw = ((const uint32_t*)k_pages)[tok * w + d / 4];
      const uint32_t vw = ((const uint32_t*)v_pages)[tok * w + d / 4];
      ks[i] = int8_lane(kw, d % 4) * k_scale[tok];
      vs[i] = int8_lane(vw, d % 4) * v_scale[tok];
    } else {
      ks[i] = __bfloat162float(((const __nv_bfloat16*)k_pages)[tok * dh + d]);
      vs[i] = __bfloat162float(((const __nv_bfloat16*)v_pages)[tok * dh + d]);
    }
  }
}

// Fold n staged keys into the online-softmax state of `rows` query rows:
// scores s [rows, n] are already masked; p = exp(s - m_new), zeroed for
// rows with live[r] == 0. Ends with a barrier.
__device__ __forceinline__ void fold_rows(
    const float* s, const float* vs, float* acc, float* m, float* l,
    float* m_next, float* l_next, const int* live, int rows, int n, int dh) {
  for (int i = threadIdx.x; i < rows * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
    const float* sr = s + r * n;
    float mn = m[r];
    for (int t = 0; t < n; ++t) mn = fmaxf(mn, sr[t]);
    const float alpha = expf(m[r] - mn);
    float a = 0.f, lsum = 0.f;
    if (live == nullptr || live[r]) {
      for (int t = 0; t < n; ++t) {
        const float p = expf(sr[t] - mn);
        a = fmaf(p, vs[t * dh + d], a);
        lsum += p;
      }
    }
    acc[i] = acc[i] * alpha + a;
    if (d == 0) {
      m_next[r] = mn;
      l_next[r] = l[r] * alpha + lsum;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    m[r] = m_next[r];
    l[r] = l_next[r];
  }
  __syncthreads();  // also guards ks/vs/s before the next page is staged
}

// One block per (slot b, kv-head h) over its S*G query rows (row
// r = query sq * g + group member gi); decode is S = 1. q and out are
// [B, S, hkv, g, dh], q_pos [B, S]. RING folds the slot's R draft-ring
// entries in after the pages.
template <bool PACKED, bool RING>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const void* __restrict__ k_pages,
                       const void* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ q_pos,
                       const __nv_bfloat16* __restrict__ extra_k,
                       const __nv_bfloat16* __restrict__ extra_v,
                       const int* __restrict__ extra_pos,
                       __nv_bfloat16* __restrict__ out, int n_pp, int ps,
                       int hkv, int g, int dh, int S, int R, float sm_scale) {
  extern __shared__ float smem[];
  const int rows = S * g;
  const int rd = rows * dh;
  const int nk = (RING && R > ps) ? R : ps;  // keys staged at once
  float* qs = smem;             // [rows, dh] query rows, pre-scaled
  float* acc = qs + rd;         // [rows, dh] weighted V sum
  float* ks = acc + rd;         // [nk, dh] staged K page (or ring)
  float* vs = ks + nk * dh;     // [nk, dh] staged V page (or ring)
  float* s = vs + nk * dh;      // [rows, nk] scores of the page
  float* m = s + rows * nk;     // [rows] running max
  float* l = m + rows;          // [rows] running denominator
  float* m_next = l + rows;     // [rows]
  float* l_next = m_next + rows;  // [rows]
  int* rpos = (int*)(l_next + rows);  // [rows] position of each row
  int* live = rpos + rows;            // [rows] position >= 0

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  for (int i = tid; i < rd; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
    const int sq = r / g, gi = r - sq * g;
    const size_t off = ((((size_t)b * S + sq) * hkv + h) * g + gi) * dh + d;
    qs[i] = __bfloat162float(q[off]) * sm_scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += THREADS) {
    m[r] = MASK_VALUE;
    l[r] = 0.f;
    rpos[r] = q_pos[(size_t)b * S + r / g];
    live[r] = rpos[r] >= 0;
  }
  int max_pos = -1;  // the slot's last query: uniform across the block
  for (int sq = 0; sq < S; ++sq) max_pos = max(max_pos, q_pos[(size_t)b * S + sq]);
  __syncthreads();

  for (int j = 0; j < n_pp; ++j) {
    const int page = page_table[(size_t)b * n_pp + j];
    const int base = j * ps;
    if (page < 0 || base > max_pos) continue;  // uniform across the block
    stage_page<PACKED>(ks, vs, k_pages, v_pages, k_scale, v_scale, page, ps,
                       hkv, h, dh);
    __syncthreads();
    for (int i = tid; i < rows * ps; i += THREADS) {
      const int r = i / ps, t = i - r * ps;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qs[r * dh + d], ks[t * dh + d], dot);
      s[i] = (base + t <= rpos[r]) ? dot : MASK_VALUE;
    }
    __syncthreads();
    fold_rows(s, vs, acc, m, l, m_next, l_next, live, rows, ps, dh);
  }
  if (RING) {
    bool any = false;  // uniform: every thread reads the same R entries
    for (int t = 0; t < R; ++t) any |= extra_pos[(size_t)b * R + t] >= 0;
    if (any) {
      for (int i = tid; i < R * dh; i += THREADS) {
        const int t = i / dh, d = i - t * dh;
        const size_t off = (((size_t)b * R + t) * hkv + h) * dh + d;
        ks[i] = __bfloat162float(extra_k[off]);
        vs[i] = __bfloat162float(extra_v[off]);
      }
      __syncthreads();
      for (int i = tid; i < rows * R; i += THREADS) {
        const int r = i / R, t = i - r * R;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qs[r * dh + d], ks[t * dh + d], dot);
        s[i] = extra_pos[(size_t)b * R + t] >= 0 ? dot : MASK_VALUE;
      }
      __syncthreads();
      fold_rows(s, vs, acc, m, l, m_next, l_next, nullptr, rows, R, dh);
    }
  }
  for (int i = tid; i < rd; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
    const int sq = r / g, gi = r - sq * g;
    const size_t off = ((((size_t)b * S + sq) * hkv + h) * g + gi) * dh + d;
    out[off] = __float2bfloat16(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool PACKED, bool RING>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* q_pos, const void* extra_k, const void* extra_v,
           const void* extra_pos, void* out, int B, int n_pp, int ps, int hkv,
           int g, int dh, int S, int R, float sm_scale, cudaStream_t stream) {
  const size_t rows = (size_t)S * g;
  const size_t nk = (RING && R > ps) ? (size_t)R : (size_t)ps;
  const size_t smem = sizeof(float) * (2 * rows * dh + 2 * nk * dh +
                                       rows * nk + 4 * rows) +
                      sizeof(int) * 2 * rows;
  const int e = set_smem(paged_attention_kernel<PACKED, RING>, smem);
  if (e) return e;
  paged_attention_kernel<PACKED, RING><<<dim3(B, hkv), THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, k_pages, v_pages, (const float*)k_scale,
      (const float*)v_scale, (const int*)page_table, (const int*)q_pos,
      (const __nv_bfloat16*)extra_k, (const __nv_bfloat16*)extra_v,
      (const int*)extra_pos, (__nv_bfloat16*)out, n_pp, ps, hkv, g, dh, S, R,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The three launchers run one kernel; they stay separate entry points so
// that their launches are counted apart.

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
                                  int packed, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (packed)
    return launch<true, false>(q, k_pages, v_pages, k_scale, v_scale,
                               page_table, q_pos, nullptr, nullptr, nullptr,
                               out, B, n_pp, ps, hkv, g, dh, 1, 0, sm_scale,
                               st);
  return launch<false, false>(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, q_pos, nullptr, nullptr, nullptr,
                              out, B, n_pp, ps, hkv, g, dh, 1, 0, sm_scale,
                              st);
}

// As paged_decode_attention_launch, with q_pos bounding the POOL read and
// the draft ring folded in after the pages: extra_k/extra_v bf16
// [B, R, hkv, dh], extra_pos int32 [B, R] (an entry is valid iff >= 0).
int paged_decode_ring_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* q_pos, const void* extra_k, const void* extra_v,
    const void* extra_pos, void* out, int B, int n_pp, int ps, int hkv,
    int g, int dh, int R, float sm_scale, int packed, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (packed)
    return launch<true, true>(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, q_pos, extra_k, extra_v, extra_pos,
                              out, B, n_pp, ps, hkv, g, dh, 1, R, sm_scale,
                              st);
  return launch<false, true>(q, k_pages, v_pages, k_scale, v_scale,
                             page_table, q_pos, extra_k, extra_v, extra_pos,
                             out, B, n_pp, ps, hkv, g, dh, 1, R, sm_scale,
                             st);
}

// q bf16 [B, S, hkv*g, dh]; q_pos int32 [B, S] (-1 = masked row); pools,
// scales and page_table as above; out bf16 [B, S, hkv*g, dh].
int paged_verify_attention_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scale,
                                  const void* v_scale,
                                  const void* page_table, const void* q_pos,
                                  void* out, int B, int n_pp, int ps,
                                  int hkv, int g, int dh, int S,
                                  float sm_scale, int packed, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (packed)
    return launch<true, false>(q, k_pages, v_pages, k_scale, v_scale,
                               page_table, q_pos, nullptr, nullptr, nullptr,
                               out, B, n_pp, ps, hkv, g, dh, S, 0, sm_scale,
                               st);
  return launch<false, false>(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, q_pos, nullptr, nullptr, nullptr,
                              out, B, n_pp, ps, hkv, g, dh, S, 0, sm_scale,
                              st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
