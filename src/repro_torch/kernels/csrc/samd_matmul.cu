// SAMD packed-weight matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `samd_matmul` of
// src/repro/kernels/samd_matmul.py (`_kernel`, `unpack_codes`):
//
//   out[M, N] = x[M, K] @ (codes(packed[ceil(K/vpw), N]) * scale[1, N])
//
// `packed` holds b-bit lanes of width `lane_width` along K, `vpw` lanes per
// 32-bit word (lane 0 in the low bits). Lanes are unpacked in registers by
// shift and mask, sign-fixed unless `signed_lanes` is 0, and the raw integer
// codes are accumulated against the f32 activations; the per-column scale is
// applied once at the store, as in the reference.
//
// What bounds it on an H100: at decode (M <= max_batch = 8) the work is a
// matrix-vector product and the bound is the packed weight bytes over HBM
// (3.35 TB/s): 4-bit weights are a quarter of the bf16 bytes, which is the
// point of SAMD storage. At prefill (M = rows of a whole admission batch)
// the FMAs bound it. This first version is simple and right, not fast: one
// block per (32-row, 64-column) output tile, 256 threads, each owning one
// column and 8 rows; the block stages a K-step of activations in shared
// memory as f32 (rows past M and columns past K staged as zeros, so `x` is
// never read out of bounds and no zero padding of the weights is needed);
// each thread reads its column's words straight from global memory
// (coalesced across the warp) and unpacks them in registers. No tensor
// cores, no TMA and no pipelining yet: those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;                 // output rows per block
constexpr int BN = 64;                 // output columns per block
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;     // 4
constexpr int ROWS_PER_THREAD = BM / ROW_GROUPS;  // 8
constexpr int KT = 256;                // most activation values per K-step

__global__ void __launch_bounds__(THREADS)
samd_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint32_t* __restrict__ packed,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K,
                   int bits, int lane_width, int vpw, int signed_lanes) {
  __shared__ float xs[BM][KT];
  const int tid = threadIdx.x;
  const int col = blockIdx.x * BN + (tid % BN);
  const int rg = tid / BN;
  const int row0 = blockIdx.y * BM;
  // a K-step is a whole number of words, so every step starts on a word
  const int k_step = (KT / vpw) * vpw;
  const uint32_t vmask = (1u << bits) - 1u;
  // rows this thread owns that exist: rg, rg + 4, ... below M
  const int rows_left = M - row0 - rg;
  const int n_rows = rows_left <= 0 ? 0
      : min(ROWS_PER_THREAD, (rows_left + ROW_GROUPS - 1) / ROW_GROUPS);

  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += k_step) {
    const int kn = min(k_step, K - k0);
    __syncthreads();  // the previous step's reads of xs are done
    for (int idx = tid; idx < BM * k_step; idx += THREADS) {
      const int r = idx / k_step, c = idx - r * k_step;
      const int gr = row0 + r;
      float v = 0.f;
      if (gr < M && c < kn) v = __bfloat162float(x[(size_t)gr * K + k0 + c]);
      xs[r][c] = v;
    }
    __syncthreads();
    if (col < N && n_rows > 0) {
      const int w0 = k0 / vpw;
      const int nw = (kn + vpw - 1) / vpw;  // the last word may be partial
      for (int w = 0; w < nw; ++w) {
        const uint32_t word = packed[(size_t)(w0 + w) * N + col];
        for (int l = 0; l < vpw; ++l) {
          const uint32_t u = (word >> (l * lane_width)) & vmask;
          int code = (int)u;
          if (signed_lanes) code -= (int)((u >> (bits - 1)) & 1u) << bits;
          const float cf = (float)code;
          const int kk = w * vpw + l;  // lanes past K meet staged zeros
#pragma unroll
          for (int i = 0; i < ROWS_PER_THREAD; ++i)
            if (i < n_rows)
              acc[i] = fmaf(xs[rg + i * ROW_GROUPS][kk], cf, acc[i]);
        }
      }
    }
  }
  if (col < N) {
    const float s = scale[col];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i)
      if (i < n_rows)
        out[(size_t)(row0 + rg + i * ROW_GROUPS) * N + col] =
            __float2bfloat16(acc[i] * s);
  }
}

}  // namespace

extern "C" {

// x bf16 [M, K]; packed uint32 [>= ceil(K/vpw), N]; scale f32 [N];
// out bf16 [M, N]; all contiguous. Returns cudaGetLastError().
int samd_matmul_launch(const void* x, const void* packed, const void* scale,
                       void* out, int M, int N, int K, int bits,
                       int lane_width, int vpw, int signed_lanes,
                       void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  samd_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const uint32_t*)packed, (const float*)scale,
      (__nv_bfloat16*)out, M, N, K, bits, lane_width, vpw, signed_lanes);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
