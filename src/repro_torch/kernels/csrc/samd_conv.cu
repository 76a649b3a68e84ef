// SAMD convolution kernels for Hopper (sm_90a): the two Pallas TPU kernels of
// src/repro/kernels/samd_conv.py.
//
// 1. samd_conv2d_launch replaces `samd_conv2d` (`_conv2d_kernel`): a stride-1
//    2D convolution with SAMD-packed HWIO weights,
//
//      out[oh, ow, n] = scale[n] * sum_{c, kh, kw} x[c, oh+kh-p, ow+kw-p]
//                                                 * code[kh, kw, c, n]
//
//    x is CHW (f32 or bf16), packed is uint32 [KH, KW, CW = ceil(C/vpw), N]
//    with b-bit lanes along C (lane 0 in the low bits), scale f32 [N], out
//    HWC in x's type. Taps outside the image and channels at or past C count
//    as zero. One block per (32 output columns, 64 output channels, output
//    row); 128 threads, each owning 4 columns x 4 channels. The C reduction
//    is a loop inside the block (the TPU's sequential grid axis): each step
//    stages the KH input rows of `bcw` words' worth of channels in shared
//    memory as f32 (zero at the borders and past C, so x is never read out of
//    bounds and the wrapper pads nothing), and unpacks the [KH, KW, bcw, 64]
//    word block to integer codes once (shift, mask, and the sign fix unless
//    `signed_lanes` is 0), also into shared memory. The raw codes are
//    accumulated against x in f32 on CUDA cores; the per-channel scale is
//    applied once at the store, as in the reference. Shared memory is sized
//    per launch from KH, KW and the channels per step (about 43 KB at 3x3).
//
//    What bounds it on an H100: at VGG-B's shapes the FMAs (2 * OH * OW * N
//    * C * KH * KW operations against a few MB of activations and packed
//    weights), so the bound is the f32 CUDA-core peak. This first version
//    reads one shared-memory value per two FMAs (4 x values and 4 codes for a
//    4 x 4 outer product), so shared-memory bandwidth caps it well below that
//    peak, and small images (conv5: 14 columns of a 32-column tile) leave
//    threads idle; no tensor cores, no TMA, no pipelining yet: those are
//    later work.
//
// 2. samd_conv_chunks_launch replaces `samd_conv_chunks` (`_conv_kernel`):
//    the paper's convolution as long multiplication (§5-6). One thread per
//    packed chunk word: the 32x32 -> 64-bit product with the kernel word
//    (Hopper's native wide multiply replaces the reference's 16-bit limbs),
//    for signed plans the Grys high-half adjustment and the Fig. 12 borrow
//    fixup with its carry, then the extraction of `out_lanes` lanes of width
//    L (those that straddle bit 32 included), sign-extended when signed.
//    Bit-exact integer work, bound by bytes: 4 bytes read and 4 * out_lanes
//    written per word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BW = 32;    // output columns per block
constexpr int BN = 64;    // output channels per block
constexpr int TW = 4;     // columns per thread
constexpr int TN = 4;     // channels per thread
constexpr int THREADS_N = BN / TN;                 // 16
constexpr int THREADS = (BW / TW) * THREADS_N;     // 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
samd_conv2d_kernel(const T* __restrict__ x, const uint32_t* __restrict__ packed,
                   const float* __restrict__ scale, T* __restrict__ out, int C,
                   int H, int W, int KH, int KW, int CW, int N, int pad,
                   int OW, int bits, int lane_width, int vpw, int signed_lanes,
                   int bcw) {
  extern __shared__ float smem[];
  const int bc = bcw * vpw;        // channels per step
  const int sw = BW + KW - 1;      // staged columns of a row
  const int taps = KH * KW;
  float* xs = smem;                // [bc][KH][sw]
  float* cs = smem + bc * KH * sw; // [taps][bc][BN]
  const int tid = threadIdx.x;
  const int tn = tid % THREADS_N;
  const int tw = tid / THREADS_N;
  const int w0 = blockIdx.x * BW;
  const int n0 = blockIdx.y * BN;
  const int oh = blockIdx.z;
  const uint32_t vmask = (1u << bits) - 1u;

  float acc[TW][TN];
#pragma unroll
  for (int i = 0; i < TW; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int cw0 = 0; cw0 < CW; cw0 += bcw) {
    const int c0 = cw0 * vpw;
    __syncthreads();  // the previous step's reads of xs and cs are done
    const int nx = bc * KH * sw;
    for (int i = tid; i < nx; i += THREADS) {
      const int col = i % sw;
      const int r = (i / sw) % KH;
      const int gc = c0 + i / (sw * KH);
      const int ih = oh + r - pad, iw = w0 + col - pad;
      float v = 0.f;
      if (gc < C && ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = to_f32(x[((size_t)gc * H + ih) * W + iw]);
      xs[i] = v;
    }
    const int nw = taps * bcw * BN;
    for (int i = tid; i < nw; i += THREADS) {
      const int nn = i % BN;
      const int wd = (i / BN) % bcw;
      const int tap = i / (BN * bcw);
      const int gw = cw0 + wd, gn = n0 + nn;
      uint32_t word = 0;  // words past CW and channels past N: zero codes
      if (gw < CW && gn < N) word = packed[((size_t)tap * CW + gw) * N + gn];
      float* dst = cs + ((size_t)tap * bc + wd * vpw) * BN + nn;
      for (int l = 0; l < vpw; ++l) {
        const uint32_t u = (word >> (l * lane_width)) & vmask;
        int code = (int)u;
        if (signed_lanes) code -= (int)((u >> (bits - 1)) & 1u) << bits;
        dst[l * BN] = (float)code;
      }
    }
    __syncthreads();
    for (int c = 0; c < bc; ++c) {
      for (int r = 0; r < KH; ++r) {
        const float* xrow = xs + (c * KH + r) * sw + tw * TW;
        for (int q = 0; q < KW; ++q) {
          const float* crow = cs + ((size_t)(r * KW + q) * bc + c) * BN + tn;
          float a[TW], b[TN];
#pragma unroll
          for (int i = 0; i < TW; ++i) a[i] = xrow[q + i];
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = crow[j * THREADS_N];
#pragma unroll
          for (int i = 0; i < TW; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TW; ++i) {
    const int ow = w0 + tw * TW + i;
    if (ow >= OW) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + j * THREADS_N;
      if (n < N) store(out + ((size_t)oh * OW + ow) * N + n, acc[i][j] * scale[n]);
    }
  }
}

template <typename T>
int launch_conv2d(const void* x, const void* packed, const void* scale,
                  void* out, int C, int H, int W, int KH, int KW, int CW,
                  int N, int pad, int bits, int lane_width, int vpw,
                  int signed_lanes, int bcw, cudaStream_t stream) {
  const int OH = H + 2 * pad - KH + 1, OW = W + 2 * pad - KW + 1;
  const int bc = bcw * vpw;
  const size_t smem =
      sizeof(float) * ((size_t)bc * KH * (BW + KW - 1) + (size_t)KH * KW * bc * BN);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        samd_conv2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((OW + BW - 1) / BW, (N + BN - 1) / BN, OH);
  samd_conv2d_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const uint32_t*)packed, (const float*)scale, (T*)out, C,
      H, W, KH, KW, CW, N, pad, OW, bits, lane_width, vpw, signed_lanes, bcw);
  return (int)cudaGetLastError();
}

__global__ void samd_conv_chunks_kernel(const uint32_t* __restrict__ xw,
                                        const uint32_t* __restrict__ k_word,
                                        int* __restrict__ out, int nc, int L,
                                        int out_lanes, int signed_lanes,
                                        uint32_t m_hi, uint32_t m_lo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nc) return;
  const uint32_t a = xw[i], k = *k_word;
  const unsigned long long p = (unsigned long long)a * k;
  uint32_t lo = (uint32_t)p, hi = (uint32_t)(p >> 32);
  if (signed_lanes) {
    // Grys: the signed high half of an unsigned widening multiply
    if (a >> 31) hi -= k;
    if (k >> 31) hi -= a;
    // Fig. 12 borrow fixup across the 64-bit pair, carry from lo into hi
    const uint32_t s_lo = lo & m_lo, s_hi = hi & m_hi;
    const uint32_t q_lo = lo + s_lo;
    const uint32_t q_hi = hi + s_hi + (q_lo < lo ? 1u : 0u);
    hi = q_hi ^ s_hi;
    lo = q_lo ^ s_lo;
  }
  const unsigned long long both = ((unsigned long long)hi << 32) | lo;
  const unsigned long long lane_mask = (1ull << L) - 1ull;
  int* dst = out + (size_t)i * out_lanes;
  for (int t = 0; t < out_lanes; ++t) {  // t * L + L <= 64 (the plan's check)
    long long v = (long long)((both >> (t * L)) & lane_mask);
    if (signed_lanes && ((v >> (L - 1)) & 1)) v -= 1ll << L;
    dst[t] = (int)v;
  }
}

}  // namespace

extern "C" {

// x f32 (x_bf16 = 0) or bf16 [C, H, W]; packed uint32 [KH, KW, CW, N];
// scale f32 [N]; out [OH, OW, N] in x's type; all contiguous. `bcw` words
// of channels per reduction step. Returns cudaGetLastError().
int samd_conv2d_launch(const void* x, const void* packed, const void* scale,
                       void* out, int C, int H, int W, int KH, int KW, int CW,
                       int N, int pad, int bits, int lane_width, int vpw,
                       int signed_lanes, int bcw, int x_bf16, void* stream) {
  if (x_bf16)
    return launch_conv2d<__nv_bfloat16>(x, packed, scale, out, C, H, W, KH,
                                        KW, CW, N, pad, bits, lane_width, vpw,
                                        signed_lanes, bcw, (cudaStream_t)stream);
  return launch_conv2d<float>(x, packed, scale, out, C, H, W, KH, KW, CW, N,
                              pad, bits, lane_width, vpw, signed_lanes, bcw,
                              (cudaStream_t)stream);
}

// x_words uint32 [nc]; k_word uint32 [1]; out int32 [nc, out_lanes]; lanes
// of width L (out_lanes * L <= 64). Returns cudaGetLastError().
int samd_conv_chunks_launch(const void* x_words, const void* k_word, void* out,
                            int nc, int L, int out_lanes, int signed_lanes,
                            void* stream) {
  unsigned long long msb = 0;  // the top bit of every L-bit lane of 64
  for (int b = L - 1; b < 64; b += L) msb |= 1ull << b;
  const int threads = 256;
  samd_conv_chunks_kernel<<<(nc + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)x_words, (const uint32_t*)k_word, (int*)out, nc, L,
      out_lanes, signed_lanes, (uint32_t)(msb >> 32), (uint32_t)msb);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
