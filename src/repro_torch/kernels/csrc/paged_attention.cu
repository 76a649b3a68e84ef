// Fused single-query decode attention over the paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_decode_attention` of
// src/repro/kernels/paged_attention.py (`_kernel_bf16`, `_kernel_packed`,
// `_online_update`, `_init_scratch`, `_store_out`): each slot's query
// attends to its keys by reading the pool THROUGH `page_table` (-1 marks an
// unallocated page) with an online softmax in f32, so no gathered
// [B, n_pp * page_size] copy of the KV cache ever exists. Keys at offsets
// past the slot's position are masked (-1e30), pages that are unallocated
// or lie wholly past the position are skipped, and a slot with no valid key
// (an inactive slot, page table row all -1) emits exact zeros. Packed pools
// hold four int8 lanes per 32-bit word along head_dim with an f32 scale per
// (token, kv-head); lanes are unpacked and rescaled as the page is staged.
//
// What bounds it on an H100: the bytes of the KV pages the slots own, over
// HBM (3.35 TB/s); the FLOPs are ~2 per byte read. The TPU's sequential
// page grid axis becomes a loop inside the block: one block per
// (slot, kv-head), 128 threads, which loads its own page-table entries,
// stages one page of K and V for its head in shared memory as f32, scores
// its G query rows against the page, and folds the page into m/l/acc kept
// in shared memory. Simple and right first; splitting long contexts across
// blocks and overlapping page loads with compute are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float MASK_VALUE = -1e30f;

__device__ __forceinline__ float int8_lane(uint32_t word, int lane) {
  return (float)(int)(int8_t)((word >> (8 * lane)) & 0xffu);
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const void* __restrict__ k_pages,
                    const void* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ q_pos,
                    __nv_bfloat16* __restrict__ out, int n_pp, int ps,
                    int hkv, int g, int dh, float sm_scale) {
  extern __shared__ float smem[];
  const int gd = g * dh;
  float* qs = smem;             // [g, dh] query rows, pre-scaled
  float* acc = qs + gd;         // [g, dh] weighted V sum
  float* ks = acc + gd;         // [ps, dh] staged K page
  float* vs = ks + ps * dh;     // [ps, dh] staged V page
  float* s = vs + ps * dh;      // [g, ps] scores of the page
  float* m = s + g * ps;        // [g] running max
  float* l = m + g;             // [g] running denominator
  float* m_next = l + g;        // [g]
  float* l_next = m_next + g;   // [g]

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const size_t q_off = ((size_t)b * hkv + h) * gd;  // q is [B, hkv*g, dh]
  for (int i = tid; i < gd; i += THREADS) {
    qs[i] = __bfloat162float(q[q_off + i]) * sm_scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += THREADS) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
  }
  const int pos = q_pos[b];
  __syncthreads();

  for (int j = 0; j < n_pp; ++j) {
    const int page = page_table[(size_t)b * n_pp + j];
    const int base = j * ps;
    if (page < 0 || base > pos) continue;  // uniform across the block
    for (int i = tid; i < ps * dh; i += THREADS) {
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
    __syncthreads();
    for (int i = tid; i < g * ps; i += THREADS) {
      const int gi = i / ps, t = i - gi * ps;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qs[gi * dh + d], ks[t * dh + d], dot);
      s[i] = (base + t <= pos) ? dot : MASK_VALUE;
    }
    __syncthreads();
    for (int i = tid; i < gd; i += THREADS) {
      const int gi = i / dh, d = i - gi * dh;
      const float* sg = s + gi * ps;
      float mn = m[gi];
      for (int t = 0; t < ps; ++t) mn = fmaxf(mn, sg[t]);
      const float alpha = expf(m[gi] - mn);
      float a = 0.f, lsum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(sg[t] - mn);
        a = fmaf(p, vs[t * dh + d], a);
        lsum += p;
      }
      acc[i] = acc[i] * alpha + a;
      if (d == 0) {
        m_next[gi] = mn;
        l_next[gi] = l[gi] * alpha + lsum;
      }
    }
    __syncthreads();
    for (int i = tid; i < g; i += THREADS) {
      m[i] = m_next[i];
      l[i] = l_next[i];
    }
    __syncthreads();  // also guards ks/vs before the next page is staged
  }
  for (int i = tid; i < gd; i += THREADS)
    out[q_off + i] = __float2bfloat16(acc[i] / fmaxf(l[i / dh], 1e-30f));
}

template <bool PACKED>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* q_pos, void* out, int B, int n_pp, int ps, int hkv,
           int g, int dh, float sm_scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)g * dh + 2 * (size_t)ps * dh +
                       (size_t)g * ps + 4 * (size_t)g);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<PACKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<PACKED><<<dim3(B, hkv), THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, k_pages, v_pages, (const float*)k_scale,
      (const float*)v_scale, (const int*)page_table, (const int*)q_pos,
      (__nv_bfloat16*)out, n_pp, ps, hkv, g, dh, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

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
    return launch<true>(q, k_pages, v_pages, k_scale, v_scale, page_table,
                        q_pos, out, B, n_pp, ps, hkv, g, dh, sm_scale, st);
  return launch<false>(q, k_pages, v_pages, k_scale, v_scale, page_table,
                       q_pos, out, B, n_pp, ps, hkv, g, dh, sm_scale, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
