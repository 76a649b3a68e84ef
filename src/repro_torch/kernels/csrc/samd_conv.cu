// SAMD convolution kernels for Hopper (sm_90a): the two Pallas TPU kernels of
// src/repro/kernels/samd_conv.py.
//
// 1. samd_conv2d_launch and samd_conv2d_im2col_launch replace `samd_conv2d`
//    (`_conv2d_kernel`): a stride-1 2D convolution with SAMD-packed HWIO
//    weights,
//
//      out[oh, ow, n] = scale[n] * sum_{c, kh, kw} x[c, oh+kh-p, ow+kw-p]
//                                                 * code[kh, kw, c, n]
//
//    x is CHW (f32 or bf16), packed is uint32 [KH, KW, CW = ceil(C/vpw), N]
//    with b-bit lanes along C (lane 0 in the low bits, sign-fixed unless
//    `signed_lanes` is 0), scale f32 [N], out HWC in x's type. Taps outside
//    the image count as zero.
//
//    What bounds it on an H100. VGG-B's layers do 0.17-3.7 GFLOP each
//    against 0.6-26 MB of activations and packed weights: hundreds of
//    operations per byte, so the tensor-core rate bounds every layer but
//    conv1_1, which does 27 products per output pixel against a 12.8 MB
//    f32 output and is bound by bytes. f32 x runs two bf16 MMAs per
//    product (below), so its bound is the operations over half the bf16
//    peak. The first version ran f32 FMAs on CUDA cores fed from shared
//    memory (1.4-12.5 TFLOP/s), one block per output row, so conv4 and
//    conv5 (28 and 14 columns) left most SMs idle.
//
//    Design: an implicit GEMM on the tensor cores, M = output pixels, N =
//    C_out, K = KH * KW * C, with `mma.sync.m16n8k16` (bf16 in, f32
//    accumulate) on 128 x 64 output tiles. A block is 4 MMA warps (32 x
//    64 each) and 4 warps that load and unpack (below).
//    * A pre-pass kernel stages x once, pixel-major and zero-padded, into a
//      bf16 workspace [rows][cols] that the wrapper allocates. bf16 x is
//      copied as it is. f32 x is split into two bf16 terms, hi = bf16(x)
//      and lo = bf16(x - hi), which keep 16 of its 24 bits (|x - hi - lo|
//      <= 2^-17 |x|), and each term runs its own MMA into the same f32 sum.
//    * samd_conv2d_launch (every layer whose channels fill a K-step): rows
//      are the padded image's pixels, (H + 2p) x (W + 2p), so tap (kh, kw)
//      of output pixel m = oh * (W + 2p) + ow is workspace row m + kh *
//      (W + 2p) + kw: every K-step's A tile is one run of contiguous rows.
//      M tiles run over the flattened padded rows, not one output row, so
//      small images fill whole tiles; the 2p padding columns of each row
//      are computed and dropped.
//    * samd_conv2d_im2col_launch (few channels, conv1_1's C = 3): the
//      pre-pass writes the KH * KW * C products of each output pixel side
//      by side (27 for conv1_1, padded to one K-step, not nine taps of 16
//      channels). The direct launcher takes 1.5x its time on conv1_1.
//    * A K-step is SW words of channels of one tap: 32, 48 or 80 values of
//      K for f32 x; bf16 x (one term, half the bytes) takes 64 where 8
//      words or fewer make 32.
//      The loading warps copy a step's A tiles (one per x term) and its
//      word tile with `cp.async` into a 3-stage ring, each thread's chunks
//      at fixed offsets (one pointer add a step); when the copies of step
//      s - 1 have landed they unpack its words once per block into the
//      stage's bf16 B tile [k][n] (two channels a thread, one 32-bit store
//      per pair of codes) and mark the stage full on a named barrier. The
//      MMA warps wait for a full stage, read A with `ldmatrix` and B with
//      `ldmatrix.trans`, multiply, and free the stage on a second named
//      barrier. So loads, unpack and MMAs of different steps overlap, and
//      the MMA warps run nothing else.
//    * Codes go to bf16 as the reference's `codes.astype(x.dtype)`: exact
//      up to 8 unsigned / 9 signed bits, rounded above that for bf16 x.
//      For f32 x, wider codes are split into two exact bf16 parts, the
//      high bits times 256 and the low 8 bits, so the f32 result keeps them
//      exactly (two B tiles, twice the MMAs).
//    * Where the tiles alone fill fewer than 132 SMs (conv3-conv5), the
//      wrapper's rule cuts K into `splits` equal runs of whole steps (a
//      divisor of the step count, at most 8). The splits of one tile form
//      one thread-block cluster: each leaves its f32 partial tile in its
//      own shared memory, and each rank sums its share of the rows over all
//      ranks in rank order through distributed shared memory. No atomics:
//      two calls are bit-identical.
//    * Epilogue: the tile goes through shared memory, the per-channel scale
//      is applied once, and rows are stored HWC, four consecutive channels
//      a thread.
//    What holds it back (`tools/conv_ablation.py`, numbers in `PERF.md`):
//    the loading warps. Taking out the MMAs saves nothing; taking out the
//    x loads or the unpack saves at most a fifth each, and the skeleton
//    of barriers, word loads and `ldmatrix` keeps most of the time.

// 2. Conv as long multiplication (paper §5-6), the reference's
//    `samd_conv_chunks` (`_conv_kernel`) and the op around it
//    (`ops.samd_conv1d`: pack the chunks, run the kernel, overlap-add).
//    One device function, `chunk_product`, does the kernel's arithmetic on
//    a chunk word and the kernel word: the native 32x32 -> 64-bit multiply
//    (for signed plans the signed one, which is the unsigned product with
//    Grys' high-half adjustment) and, for signed plans, the Fig. 12 borrow
//    fixup as one 64-bit add, so the carry from lo into hi is in it;
//    `product_lane` extracts lane t at bit t * L (straddling bit 32 or
//    not), sign-extended when signed. Two launchers share them.
//
//    samd_conv1d_launch, the op users call, fused: the raw integer values
//    x [n] (int8, uint8, int16, int32 or int64, one instantiation each)
//    and the kernel values k [taps] -> out int32 [n + taps - 1] =
//    np.convolve(x, k). Bound by bytes: n values read once in x's own
//    type and n + taps - 1 int32 written once, nothing else; the unfused
//    op (PyTorch packing over int64 temporaries, the chunk kernel's
//    [nc, lanes + taps - 1] intermediate, a strided add per lane over a
//    zeroed output) moved many times those bytes in a chain of launches.
//    A block owns a tile of `tile_chunks` chunks (a multiple of 16, from
//    the wrapper's conv1d_plan), i.e. tile_chunks * lanes values and as
//    many outputs. Blocks are persistent (four an SM, each walking the
//    tiles with stride gridDim.x): with a block launched per tile the
//    launch alone took 0.0026-0.0039 ms of a ~0.018 ms call, persistent
//    0.0014-0.0018 (tools/conv1d_ablation.py, H100 80GB HBM3, 700 W).
//    * Loads: each tile's values, and the whole 16-byte vectors before
//      it that hold the chunk before it (the halo), come into shared
//      memory as 16-byte `cp.async` copies (zero-filled outside x), into
//      one of two buffers, so the next tile's copies are in flight while
//      this one is computed and stored; an x that is not 16-byte aligned
//      (a view such as x[1:]) or not contiguous is read element-wise
//      instead, in this kernel.
//    * Packing: each thread packs its chunk word from shared memory, each
//      value truncated to `bits` bits and sign-extended into the spacer
//      bits (pack_conv_operand + sign_extend_for_mul, out-of-range values
//      included); the block packs the kernel word from k itself.
//    * Products: each chunk's 64-bit product goes to shared memory once,
//      the halo chunk's (recomputed in the block) before the tile's.
//    * Epilogue: output j gets lane j mod lanes of chunk j div lanes and,
//      when j mod lanes < taps - 1, lane j mod lanes + lanes of the chunk
//      before (lanes >= taps, so never a third term). Each thread makes
//      four consecutive outputs from the products and stores them as one
//      16-byte vector, so the sum needs no atomics and no zero-fill and
//      two calls are bit-identical; the last tile stops at n + taps - 1.
//      No host sync: the call can be captured in a CUDA graph.
//    What holds it back (same tool and card): the bytes. With int64 x
//    the loads and stores alone take 0.016 of its 0.017 ms; with int8 x
//    they take 0.0096 of 0.0114 (four bytes written an output against
//    one read), the packing and products 0.0025.
//
//    samd_conv_chunks_launch, the counterpart of the TPU function:
//    [nc] chunk words -> int32 [nc, lanes + taps - 1], one thread a word,
//    its lanes staged in shared memory and stored as 16-byte vectors
//    (stored one by one, each thread's out_lanes * 4 bytes from its
//    neighbour's, the 2-bit plan took 4.2x as long). Bound by bytes: 4
//    read and 4 * (lanes + taps - 1) written a word.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;          // output pixels per block
constexpr int BN = 64;           // output channels per block
constexpr int MI = 2;            // m16 tiles per warp
constexpr int NI = 8;            // n8 tiles per warp
constexpr int WARPS_M = BM / (16 * MI);
constexpr int WARPS_N = BN / (8 * NI);
constexpr int C_WARPS = WARPS_M * WARPS_N;  // MMA (consumer) warps
constexpr int C_THREADS = C_WARPS * 32;
constexpr int P_THREADS = 128;   // load-and-unpack (producer) warps' threads
constexpr int THREADS = C_THREADS + P_THREADS;
constexpr int SB = BN + 8;       // bf16 row stride of the B tile [k][n]
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int MAX_SPLITS = 8;    // the portable cluster size
constexpr int WPAD = 4;          // words of padding per word-tile row
constexpr int RED_STRIDE = BN + 4;

// words of channels per K-step for each lanes-per-word count: SW * VPW is
// a multiple of 16 (the MMA's k), 32-80 values of K; one x term (bf16 x)
// takes twice the words where that makes 32 values from at most 8 words.
// The wrapper's plan chooses the step (samd_conv.STEP_WORDS); a launch
// whose step is not this instantiation's is refused
template <int VPW>
struct Words {
  static constexpr int SW = VPW == 1 ? 32 : VPW == 2 ? 16 : VPW == 3 ? 16
                          : VPW == 4 ? 8 : VPW == 5 ? 16 : VPW == 6 ? 8
                          : VPW == 8 ? 4 : VPW == 10 ? 8 : VPW == 16 ? 2 : 1;
};
constexpr int ONE_TERM_MULT = 2;

template <int VPW, int TERMS>
struct Step {
  static constexpr int SW =
      Words<VPW>::SW *
      (TERMS == 1 && Words<VPW>::SW * VPW == 32 && Words<VPW>::SW <= 8
           ? ONE_TERM_MULT
           : 1);
  static constexpr int KC = SW * VPW;     // values of K per step
  static constexpr int SA = KC + 8;       // bf16 row stride of A tiles
  static_assert(KC % 16 == 0, "a K-step must be whole k16 MMA steps");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
// four consecutive outputs (16-byte aligned for f32, 8-byte for bf16)
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// C[16x8] += A[16x16] . B[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Lanes {
  int lane_width;
  uint32_t mask;      // (1 << bits) - 1
  uint32_t magic;     // 0x4B000000 | sign bit (0 for unsigned lanes)
  float bias;         // 2^23 + sign bit
};

// lane `l` of `word` as its sign-fixed integer code, in f32
__device__ __forceinline__ float lane_code(uint32_t word, int l,
                                           const Lanes& ln) {
  const uint32_t v = ((word >> (l * ln.lane_width)) & ln.mask) ^ ln.magic;
  return __uint_as_float(v) - ln.bias;
}

// code -> B tile(s): CT = 1 casts to bf16 (the reference's
// codes.astype(x.dtype)); CT = 2 writes two exact parts, the high bits
// times 256 into the first tile and the low 8 bits into the second
template <int CT>
__device__ __forceinline__ void put_code(bf16* dst, int ct_stride, float f) {
  if (CT == 1) {
    dst[0] = __float2bfloat16_rn(f);
  } else {
    const int code = (int)f;
    const int hi = (code >> 8) * 256;
    dst[0] = __float2bfloat16_rn((float)hi);
    dst[ct_stride] = __float2bfloat16_rn((float)(code - hi));
  }
}

// two codes of neighbouring channels -> B tile(s), as put_code
template <int CT>
__device__ __forceinline__ void put_code2(bf16* dst, int ct_stride, float f0,
                                          float f1) {
  if (CT == 1) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(f0, f1);
  } else {
    const int c0 = (int)f0, c1 = (int)f1;
    const int h0 = (c0 >> 8) * 256, h1 = (c1 >> 8) * 256;
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn((float)h0, (float)h1);
    *reinterpret_cast<__nv_bfloat162*>(dst + ct_stride) =
        __floats2bfloat162_rn((float)(c0 - h0), (float)(c1 - h1));
  }
}

struct Geo {
  int C, H, W, KW, taps, CW, N, pad, OH, OW;
  int ldm;        // pixels per output row in M (W + 2p, or OW for im2col)
  int mtot;       // rows of M: OH * ldm
  int arows;      // workspace rows
  int lda;        // workspace columns (bf16)
  long long term_stride;  // workspace elements per x term
  int nchunks;    // K-steps per tap (direct)
  int steps, per, splits;
  int im2col, w_vec, o_vec;
  int bits, lane_width, signed_lanes;
};

// x [C, H, W] -> workspace [(H + 2p) * (W + 2p)][lda] bf16, per x term;
// channels at or past C and the border are zero. 32 pixels x 64 channels
// a block: read along the pixels (x's rows), written two channels a thread
template <typename XT, int TERMS>
__global__ void __launch_bounds__(256)
stage_x_kernel(const XT* __restrict__ x, bf16* __restrict__ ws, Geo g) {
  __shared__ float tile[64][33];
  const int Wp = g.W + 2 * g.pad;
  const int wp0 = blockIdx.x * 32, c0 = blockIdx.y * 64, hp = blockIdx.z;
  const int ih = hp - g.pad;
  for (int i = threadIdx.y; i < 64; i += 8) {
    const int c = c0 + i, iw = wp0 + threadIdx.x - g.pad;
    float v = 0.f;
    if (c < g.C && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
      v = to_f32(x[((size_t)c * g.H + ih) * g.W + iw]);
    tile[i][threadIdx.x] = v;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int wp = wp0 + i, c = c0 + 2 * threadIdx.x;
    if (wp >= Wp || c >= g.lda) continue;  // lda is even
    const float v0 = tile[2 * threadIdx.x][i], v1 = tile[2 * threadIdx.x + 1][i];
    const size_t o = ((size_t)hp * Wp + wp) * g.lda + c;
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(ws + o) = hi;
    if (TERMS == 2)
      *reinterpret_cast<__nv_bfloat162*>(ws + g.term_stride + o) =
          __floats2bfloat162_rn(v0 - __low2float(hi), v1 - __high2float(hi));
  }
}

// x [C, H, W] -> workspace [OH * OW][lda]: column k = tap * C + c holds
// x[c, oh + kh - p, ow + kw - p] (zero past the taps and outside the
// image); 32 pixels x 32 columns a block, read along the pixels (x's
// rows) and written along the columns through shared memory
template <typename XT, int TERMS>
__global__ void __launch_bounds__(256)
im2col_x_kernel(const XT* __restrict__ x, bf16* __restrict__ ws, Geo g) {
  __shared__ float tile[32][33];
  const int m0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  {
    const int m = m0 + threadIdx.x;
    const int oh = m / g.OW, ow = m - oh * g.OW;
    for (int i = threadIdx.y; i < 32; i += 8) {
      const int k = k0 + i, tap = k / g.C, c = k - tap * g.C;
      float v = 0.f;
      if (m < g.arows && tap < g.taps) {
        const int kh = tap / g.KW;
        const int ih = oh + kh - g.pad, iw = ow + tap - kh * g.KW - g.pad;
        if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
          v = to_f32(x[((size_t)c * g.H + ih) * g.W + iw]);
      }
      tile[i][threadIdx.x] = v;
    }
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int m = m0 + i, k = k0 + threadIdx.x;
    if (m >= g.arows || k >= g.lda) continue;
    const float v = tile[threadIdx.x][i];
    const size_t o = (size_t)m * g.lda + k;
    const bf16 hi = __float2bfloat16_rn(v);
    ws[o] = hi;
    if (TERMS == 2)
      ws[g.term_stride + o] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
}

template <int VPW, int TERMS, int CT>
struct Smem {
  using S = Step<VPW, TERMS>;
  static constexpr int A_BYTES = BM * S::SA * 2;               // one term
  static constexpr int W_BYTES = S::SW * (BN + WPAD) * 4;
  static constexpr int B_BYTES = CT * S::KC * SB * 2;
  static constexpr int STAGE = TERMS * A_BYTES + W_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = BM * RED_STRIDE * 4;
  static constexpr int BYTES = RING > RED ? RING : RED;
};

// named barriers (0 is __syncthreads): stage s is full (loaded and
// unpacked) at FULL + s, free again at EMPTY + s; PRODUCE joins the
// producer warps alone
constexpr int FULL = 1, EMPTY = FULL + STAGES, PRODUCE = EMPTY + STAGES;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <typename OutT, int VPW, int TERMS, int CT>
__global__ void __launch_bounds__(THREADS, 2)
conv_mma_kernel(const bf16* __restrict__ ws, const uint32_t* __restrict__ packed,
                const float* __restrict__ scale, OutT* __restrict__ out,
                Geo g) {
  using S = Step<VPW, TERMS>;
  using SM = Smem<VPW, TERMS, CT>;
  constexpr int KC = S::KC, SA = S::SA, SW = S::SW;
  constexpr int CPR = KC / 8;                        // 16-byte chunks a row
  constexpr int A_IT = BM * CPR / P_THREADS;         // A chunks a producer
  constexpr int W4_IT = (SW * BN / 4 + P_THREADS - 1) / P_THREADS;
  constexpr int W1_IT = (SW * BN + P_THREADS - 1) / P_THREADS;
  constexpr int PAIRS = SW * BN / 2;                 // word pairs a step
  constexpr int W2_IT = (PAIRS + P_THREADS - 1) / P_THREADS;
  constexpr int LG = PAIRS >= P_THREADS ? 1 : P_THREADS / PAIRS;  // lane shares
  static_assert(VPW % LG == 0, "whole lanes a share");
  constexpr int CTS = KC * SB;                       // elements of a B tile
  static_assert(BM * CPR % P_THREADS == 0, "whole A chunks a producer");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int s_begin = blockIdx.z * g.per;
  const int nsteps = g.per;

  auto stage_a = [&](int st, int t) {
    return reinterpret_cast<bf16*>(smem + (size_t)st * SM::STAGE +
                                   t * SM::A_BYTES);
  };
  auto stage_w = [&](int st) {
    return reinterpret_cast<uint32_t*>(smem + (size_t)st * SM::STAGE +
                                       TERMS * SM::A_BYTES);
  };
  auto stage_b = [&](int st) {
    return reinterpret_cast<bf16*>(smem + (size_t)st * SM::STAGE +
                                   TERMS * SM::A_BYTES + SM::W_BYTES);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (warp >= C_WARPS) {
    // producers: load step s into its stage, then unpack step s - 1's
    // words into its B tile and mark that stage full
    const int ptid = tid - C_THREADS;
    Lanes ln;
    ln.lane_width = g.lane_width;
    ln.mask = (1u << g.bits) - 1u;
    const uint32_t sb = g.signed_lanes ? (1u << (g.bits - 1)) : 0u;
    ln.magic = 0x4B000000u | sb;
    ln.bias = 8388608.f + (float)sb;

    // the next step to load: its tap (kh, kw) and its chunk j of the
    // tap's channels (the direct launcher); the im2col launcher's steps
    // are columns s * KC of one tap
    int ld_s = s_begin, ld_j = 0, ld_kh = 0, ld_kw = 0;
    if (!g.im2col) {
      const int tap = s_begin / g.nchunks;
      ld_j = s_begin % g.nchunks;
      ld_kh = tap / g.KW;
      ld_kw = tap % g.KW;
    }
    // each producer's A chunks sit at the same place in every step:
    // their pointers are set once, and a step adds one offset
    const bf16* a_src[A_IT];
    int a_row[A_IT], a_off[A_IT];
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int c = ptid + it * P_THREADS;
      a_row[it] = m0 + c / CPR;
      a_off[it] = (c / CPR) * SA + (c % CPR) * 8;
      a_src[it] = ws + (size_t)a_row[it] * g.lda + (c % CPR) * 8;
    }

    auto load_next = [&](int st) {
      const int row_off = g.im2col ? 0 : ld_kh * g.ldm + ld_kw;
      const int col = g.im2col ? ld_s * KC : ld_j * KC;
      const long long step_off = (long long)row_off * g.lda + col;
      const int rows_left = g.arows - row_off;
#pragma unroll
      for (int t = 0; t < TERMS; ++t) {
        bf16* sa = stage_a(st, t);
        const long long off = step_off + t * g.term_stride;
#pragma unroll
        for (int it = 0; it < A_IT; ++it) {
          const bool ok = a_row[it] < rows_left;
          cp_async16(sa + a_off[it], ok ? a_src[it] + off : ws, ok);
        }
      }
      if (!g.im2col) {
        uint32_t* sw = stage_w(st);
        const int w0 = ld_j * SW;
        const uint32_t* wsrc =
            packed + ((size_t)(ld_kh * g.KW + ld_kw) * g.CW + w0) * g.N;
        const int w_rows = g.CW - w0;  // words left in this tap
        if (g.w_vec) {
#pragma unroll
          for (int it = 0; it < W4_IT; ++it) {
            const int c = ptid + it * P_THREADS;
            const int r = c / (BN / 4), cc = (c % (BN / 4)) * 4;
            const bool ok = r < w_rows && n0 + cc < g.N;
            if (c < SW * BN / 4)
              cp_async16(sw + r * (BN + WPAD) + cc,
                         ok ? wsrc + r * g.N + n0 + cc : packed, ok);
          }
        } else {
#pragma unroll
          for (int it = 0; it < W1_IT; ++it) {
            const int c = ptid + it * P_THREADS;
            const int r = c / BN, cc = c % BN;
            const bool ok = r < w_rows && n0 + cc < g.N;
            if (c < SW * BN)
              cp_async4(sw + r * (BN + WPAD) + cc,
                        ok ? wsrc + r * g.N + n0 + cc : packed, ok);
          }
        }
        if (++ld_j == g.nchunks) {
          ld_j = 0;
          if (++ld_kw == g.KW) { ld_kw = 0; ++ld_kh; }
        }
      }
      ++ld_s;
    };

    // codes of global step s (in stage st) -> its B tile [CT][KC][SB],
    // n contiguous (consecutive threads store consecutive channels)
    auto unpack_step = [&](int s, int st) {
      bf16* bt = stage_b(st);
      if (g.im2col) {
        // gather words eight at a time, so their loads are in flight
        // together
        constexpr int G_IT = KC * BN / P_THREADS;
        static_assert(G_IT % 8 == 0, "whole groups of eight codes");
#pragma unroll 1
        for (int g0 = 0; g0 < G_IT; g0 += 8) {
          uint32_t word[8];
          int lane_of[8];
#pragma unroll
          for (int it = 0; it < 8; ++it) {
            const int i = ptid + (g0 + it) * P_THREADS;
            const int n = i % BN, kk = i / BN;
            const int kg = s * KC + kk, tap = kg / g.C, c = kg - tap * g.C;
            const bool ok = tap < g.taps && n0 + n < g.N;
            word[it] = ok ? packed[((size_t)tap * g.CW + c / VPW) * g.N + n0 +
                                   n]
                          : 0u;  // a zero word is zero codes
            lane_of[it] = c % VPW;
          }
#pragma unroll
          for (int it = 0; it < 8; ++it) {
            const int i = ptid + (g0 + it) * P_THREADS;
            put_code<CT>(bt + (i / BN) * SB + i % BN, CTS,
                         lane_code(word[it], lane_of[it], ln));
          }
        }
        return;
      }
      // two neighbouring channels' words a thread (and a share of their
      // lanes where the words are fewer than the threads): one 32-bit
      // store per pair of codes
      const uint32_t* sw = stage_w(st);
      const int lg = ptid / PAIRS, l0 = lg * (VPW / LG);
#pragma unroll
      for (int it = 0; it < W2_IT; ++it) {
        const int i = ptid % PAIRS + it * P_THREADS;
        if (i < PAIRS && lg < LG) {
          const int w = i / (BN / 2), n = (i % (BN / 2)) * 2;
          const uint2 word =
              *reinterpret_cast<const uint2*>(sw + w * (BN + WPAD) + n);
          bf16* dst = bt + (w * VPW + l0) * SB + n;
#pragma unroll
          for (int l = 0; l < VPW / LG; ++l)
            put_code2<CT>(dst + l * SB, CTS, lane_code(word.x, l0 + l, ln),
                          lane_code(word.y, l0 + l, ln));
        }
      }
    };

    for (int s = 0; s < nsteps; ++s) {
      const int st = s % STAGES;
      if (s >= STAGES) bar_sync(EMPTY + st, THREADS);  // step s - STAGES read
      load_next(st);
      cp_async_commit();
      if (s > 0) {
        cp_async_wait<1>();            // this thread's copies of s - 1 landed
        bar_sync(PRODUCE, P_THREADS);  // and every producer's
        unpack_step(s_begin + s - 1, (s - 1) % STAGES);
        bar_arrive(FULL + (s - 1) % STAGES, THREADS);
      }
    }
    cp_async_wait<0>();
    bar_sync(PRODUCE, P_THREADS);
    unpack_step(s_begin + nsteps - 1, (nsteps - 1) % STAGES);
    bar_arrive(FULL + (nsteps - 1) % STAGES, THREADS);
  } else {
    // consumers: warp tile 16 * MI pixels x 8 * NI channels
    const int wm = warp % WARPS_M, wn = warp / WARPS_M;
    const int a_lrow = wm * 16 * MI + (lane & 15);
    const int a_col = (lane >> 4) * 8;
    // x4.trans matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
    // (k 8-15, n 8-15) -> b0, b1 of n8 tile 2j, b0, b1 of tile 2j + 1
    const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int b_n = wn * 8 * NI + (lane >> 4) * 8;
    for (int s = 0; s < nsteps; ++s) {
      const int st = s % STAGES;
      bar_sync(FULL + st, THREADS);
      const bf16* bt = stage_b(st);
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[TERMS][MI][4];
#pragma unroll
        for (int t = 0; t < TERMS; ++t) {
          const bf16* sa = stage_a(st, t);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            ldmatrix_x4(a[t][mi], sa + (a_lrow + mi * 16) * SA + kk + a_col);
        }
#pragma unroll
        for (int ct = 0; ct < CT; ++ct) {
          uint32_t b[NI / 2][4];  // [n16 pair][b0, b1 of n8 tile 0, of 1]
#pragma unroll
          for (int nj = 0; nj < NI / 2; ++nj)
            ldmatrix_x4_trans(b[nj], bt + ct * CTS + (kk + b_k) * SB + b_n +
                                         nj * 16);
#pragma unroll
          for (int t = 0; t < TERMS; ++t)
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
              for (int ni = 0; ni < NI; ++ni)
                mma_bf16(acc[mi][ni], a[t][mi], b[ni >> 1][(ni & 1) * 2],
                         b[ni >> 1][(ni & 1) * 2 + 1]);
        }
      }
      if (s + STAGES < nsteps) bar_arrive(EMPTY + st, THREADS);
    }
  }
  __syncthreads();  // every warp is done with the ring

  // C fragment: c0, c1 at (pixel g, channels 2t, 2t + 1), c2, c3 at pixel
  // g + 8; the consumers' tile goes to shared memory as [BM][BN] f32
  float* red = reinterpret_cast<float*>(smem);
  if (warp < C_WARPS) {
    const int wm = warp % WARPS_M, wn = warp / WARPS_M;
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              red + (wm * 16 * MI + mi * 16 + gq + 8 * h) * RED_STRIDE +
              wn * 8 * NI + ni * 8 + 2 * tq) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (g.splits > 1) cluster.sync(); else __syncthreads();
  // rank r sums rows [r * share, (r + 1) * share) of the tile over the
  // ranks' partials, in rank order (deterministic, no atomics), four
  // channels a thread
  const int share = (BM + g.splits - 1) / g.splits;
  const int r0 = (g.splits > 1 ? (int)cluster.block_rank() : 0) * share;
  const int r1 = min(r0 + share, BM);
  for (int i = r0 * (BN / 4) + tid; i < r1 * (BN / 4); i += THREADS) {
    const int r = i / (BN / 4), n = (i % (BN / 4)) * 4;
    const int m = m0 + r, gn = n0 + n;
    const int oh = m / g.ldm, ow = m - oh * g.ldm;
    if (m >= g.mtot || ow >= g.OW || gn >= g.N) continue;
    float4 v;
    if (g.splits > 1) {
      v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < g.splits; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, k) + r * RED_STRIDE + n);
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
    } else {
      v = *reinterpret_cast<const float4*>(red + r * RED_STRIDE + n);
    }
    OutT* o = out + ((size_t)oh * g.OW + ow) * g.N + gn;
    if (g.o_vec) {
      const float4 sc = *reinterpret_cast<const float4*>(scale + gn);
      store4(o, v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (gn + q < g.N) store(o + q, vv[q] * scale[gn + q]);
    }
  }
  if (g.splits > 1) cluster.sync();  // no block leaves while read
}

template <typename XT, typename OutT, int VPW, int TERMS, int CT>
int run_conv2d(const void* x, const void* packed, const void* scale,
               void* out, void* ws, long long ws_elems, Geo g, int step_k,
               cudaStream_t stream) {
  using S = Step<VPW, TERMS>;
  using SM = Smem<VPW, TERMS, CT>;
  const int Hp = g.H + 2 * g.pad, Wp = g.W + 2 * g.pad;
  // the wrapper's plan (samd_conv.conv2d_plan) chose the K-step and the
  // step count; this instantiation takes only its own step, and only
  // counts that cover K
  if (step_k != S::KC) return (int)cudaErrorInvalidValue;
  if (g.im2col) {
    g.ldm = g.OW;
    g.arows = g.OH * g.OW;
    g.lda = g.steps * S::KC;
    g.nchunks = 0;
    if (g.lda < g.taps * g.C) return (int)cudaErrorInvalidValue;
  } else {
    g.ldm = Wp;
    g.arows = Hp * Wp;
    if (g.steps % g.taps) return (int)cudaErrorInvalidValue;
    g.nchunks = g.steps / g.taps;
    g.lda = g.nchunks * S::KC;
    if (g.nchunks * S::SW < g.CW) return (int)cudaErrorInvalidValue;
  }
  g.mtot = g.OH * g.ldm;
  g.term_stride = (long long)g.arows * g.lda;
  if (g.steps % g.splits) return (int)cudaErrorInvalidValue;
  g.per = g.steps / g.splits;
  if (ws_elems < TERMS * g.term_stride || g.term_stride >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  g.w_vec = (g.N % 4 == 0) && ((uintptr_t)packed % 16 == 0);
  g.o_vec = (g.N % 4 == 0) && ((uintptr_t)scale % 16 == 0) &&
            ((uintptr_t)out % (4 * sizeof(OutT)) == 0);

  bf16* w = (bf16*)ws;
  if (g.im2col) {
    dim3 grid((g.arows + 31) / 32, (g.lda + 31) / 32);
    im2col_x_kernel<XT, TERMS><<<grid, dim3(32, 8), 0, stream>>>((const XT*)x,
                                                                  w, g);
  } else {
    dim3 grid((Wp + 31) / 32, (g.lda + 63) / 64, Hp);
    stage_x_kernel<XT, TERMS><<<grid, dim3(32, 8), 0, stream>>>((const XT*)x,
                                                                 w, g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kernel = conv_mma_kernel<OutT, VPW, TERMS, CT>;
  constexpr int smem = SM::BYTES;
  if (smem > 48 * 1024) {
    // once per device: the attribute outlives the launch
    static bool opted[64] = {};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !opted[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) opted[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.mtot + BM - 1) / BM, (g.N + BN - 1) / BN, g.splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = g.splits;  // the K splits of one output tile
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)ws,
                           (const uint32_t*)packed, (const float*)scale,
                           (OutT*)out, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// one instantiation per lanes-per-word count and route: bf16 x (one term),
// f32 x (two terms), f32 x with codes bf16 cannot hold (vpw <= 3 only)
template <int VPW>
int dispatch_vpw(const void* x, const void* packed, const void* scale,
                 void* out, void* ws, long long ws_elems, const Geo& g,
                 int step_k, int x_bf16, int wide, cudaStream_t s) {
  if (x_bf16)
    return run_conv2d<bf16, bf16, VPW, 1, 1>(x, packed, scale, out, ws,
                                             ws_elems, g, step_k, s);
  if (!wide)
    return run_conv2d<float, float, VPW, 2, 1>(x, packed, scale, out, ws,
                                               ws_elems, g, step_k, s);
  if constexpr (VPW <= 3)
    return run_conv2d<float, float, VPW, 2, 2>(x, packed, scale, out, ws,
                                               ws_elems, g, step_k, s);
  return (int)cudaErrorInvalidValue;  // lanes of 8 bits or fewer are narrow
}

// static shared memory of a kernel as ptxas allocated it, -1 where the
// runtime cannot read its attributes
template <typename F>
int static_smem(F kernel) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes;
}

// the most shared memory one block of a run_conv2d launch takes: the
// pre-pass kernel's static tile, or conv_mma_kernel's static bytes plus
// the dynamic bytes run_conv2d passes
template <typename XT, typename OutT, int VPW, int TERMS, int CT>
int conv2d_block_smem(int im2col) {
  const int mma = static_smem(conv_mma_kernel<OutT, VPW, TERMS, CT>);
  const int pre = im2col ? static_smem(im2col_x_kernel<XT, TERMS>)
                         : static_smem(stage_x_kernel<XT, TERMS>);
  if (mma < 0 || pre < 0) return -1;
  const int gemm = mma + Smem<VPW, TERMS, CT>::BYTES;
  return gemm > pre ? gemm : pre;
}

// conv2d_block_smem of the instantiation dispatch_vpw picks; -1 where it
// has none
template <int VPW>
int conv2d_smem_of(int x_bf16, int wide, int im2col) {
  if (x_bf16) return conv2d_block_smem<bf16, bf16, VPW, 1, 1>(im2col);
  if (!wide) return conv2d_block_smem<float, float, VPW, 2, 1>(im2col);
  if constexpr (VPW <= 3)
    return conv2d_block_smem<float, float, VPW, 2, 2>(im2col);
  return -1;
}

int launch_conv2d(const void* x, const void* packed, const void* scale,
                  void* out, void* ws, long long ws_elems, int C, int H,
                  int W, int KH, int KW, int CW, int N, int pad, int bits,
                  int lane_width, int vpw, int signed_lanes, int x_bf16,
                  int splits, int step_k, int steps, int im2col,
                  void* stream) {
  Geo g = {};
  g.C = C; g.H = H; g.W = W; g.KW = KW; g.taps = KH * KW; g.CW = CW;
  g.N = N; g.pad = pad;
  g.OH = H + 2 * pad - KH + 1;
  g.OW = W + 2 * pad - KW + 1;
  g.splits = splits; g.steps = steps; g.im2col = im2col;
  g.bits = bits; g.lane_width = lane_width; g.signed_lanes = signed_lanes;
  if (splits < 1 || splits > MAX_SPLITS || bits < 1 || bits > 16 ||
      bits > lane_width || lane_width * vpw > 32 || g.OH < 1 || g.OW < 1 ||
      C < 1 || N < 1 || CW * vpw < C || (N + BN - 1) / BN > 65535 ||
      steps < 1)
    return (int)cudaErrorInvalidValue;
  const int wide = signed_lanes ? bits > 9 : bits > 8;
  cudaStream_t s = (cudaStream_t)stream;
#define SAMD_VPW(V)                                                       \
  case V:                                                                 \
    return dispatch_vpw<V>(x, packed, scale, out, ws, ws_elems, g, step_k, \
                           x_bf16, wide, s);
  switch (vpw) {
    SAMD_VPW(1) SAMD_VPW(2) SAMD_VPW(3) SAMD_VPW(4) SAMD_VPW(5)
    SAMD_VPW(6) SAMD_VPW(8) SAMD_VPW(10) SAMD_VPW(16) SAMD_VPW(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SAMD_VPW
}

// -- conv as long multiplication ---------------------------------------------

typedef unsigned long long u64;

// The reference's `_conv_kernel` on chunk word a and kernel word k: the
// 64-bit product; for signed plans the signed one (mul.wide.s32 is the
// unsigned product with Grys' adjustment hi -= sa * k + sk * a) and the
// Fig. 12 fixup q = p + (p & msb), p = q ^ (p & msb), whose 64-bit add
// carries from lo into hi as the reference's (q_lo < lo) does.
__device__ __forceinline__ u64 chunk_product(uint32_t a, uint32_t k,
                                             bool signed_lanes, u64 msb) {
  if (!signed_lanes) return (u64)a * k;
  const u64 p = (u64)((long long)(int)a * (int)k);
  const u64 s = p & msb;
  return (p + s) ^ s;
}

// lane t (t * L + L <= 64) of width L of a product, sign-extended when
// signed, as int32 bits
__device__ __forceinline__ int product_lane(u64 p, int t, int L,
                                            bool signed_lanes) {
  const u64 top = p << (64 - (t + 1) * L);
  return signed_lanes ? (int)((long long)top >> (64 - L))
                      : (int)(top >> (64 - L));
}

// one chunk word from `lanes` values, each truncated to its b bits
// (vmask) and, when signed (vsign = the value's sign bit), sign-extended
// into the spacer bits above it: pack + sign_extend_for_mul
template <typename T>
__device__ __forceinline__ uint32_t pack_chunk(const T* v, int lanes, int L,
                                               uint32_t vmask,
                                               uint32_t vsign) {
  uint32_t w = 0;
  for (int i = 0; i < lanes; ++i) {
    const uint32_t u = (uint32_t)v[i] & vmask;
    w += ((u ^ vsign) - vsign) << (i * L);
  }
  return w;
}

// k's integer types by code: int8, uint8, int16, int32, int64
__device__ __forceinline__ long long read_int(const void* p, long long i,
                                              int code) {
  switch (code) {
    case 0: return ((const int8_t*)p)[i];
    case 1: return ((const uint8_t*)p)[i];
    case 2: return ((const int16_t*)p)[i];
    case 3: return ((const int32_t*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

constexpr int C1D_THREADS = 256;
constexpr int C1D_BLOCKS_PER_SM = 4;    // registers for at least these
constexpr int C1D_MAX_SMEM = 48 * 1024;  // no opt-in attribute needed
constexpr int CHUNK_THREADS = 128;

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

struct Conv1dArgs {
  long long n, stride, k_stride, n_out, tiles;
  u64 msb;  // the top bit of every L-bit lane of 64
  uint32_t vmask, vsign;
  uint32_t lanes_magic;  // ceil(2^32 / lanes): j / lanes = umulhi(j, it)
  int tile_chunks, L, lanes, taps, k_code, signed_lanes;
};

// shared memory of one block, in bytes: two tile buffers, each the
// `pre` values before the tile (whole 16-byte vectors that hold the halo
// chunk's `lanes` values) and the tile's own; the 64-bit products of the
// halo chunk and the tile's chunks; the kernel word
struct Conv1dSmem {
  int pre, buf, prods, kw, bytes;
  __host__ __device__ Conv1dSmem(int tile_chunks, int lanes, int isz) {
    pre = align16(lanes * isz) / isz;
    buf = (pre + tile_chunks * lanes) * isz;  // a multiple of 16
    prods = 2 * buf;
    kw = prods + (tile_chunks + 1) * 8;
    bytes = kw + 16;
  }
};

// values [base - pre, base + V) of x into a tile buffer: 16-byte
// `cp.async` copies (zero-filled outside [0, n)) where x is contiguous
// and 16-byte aligned, the one vector that holds x's last value and any
// other x element-wise; then one commit group
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ x,
                                          const Conv1dArgs& a, int pre,
                                          int V, long long base,
                                          bool vectors) {
  const long long first = base - pre;
  if (vectors) {
    constexpr int VEC = 16 / sizeof(T);
    for (int v = threadIdx.x; v < (pre + V) / VEC; v += C1D_THREADS) {
      const long long e = first + (long long)v * VEC;
      if (e + VEC <= a.n || e >= a.n) {
        const bool in = e >= 0 && e < a.n;
        cp_async16(dst + v * VEC, in ? x + e : x, in);
      } else {
        for (int j = 0; j < VEC; ++j)
          dst[v * VEC + j] = e + j < a.n ? x[e + j] : T(0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < pre + V; i += C1D_THREADS) {
      const long long e = first + i;
      dst[i] = e >= 0 && e < a.n ? x[e * a.stride] : T(0);
    }
  }
  cp_async_commit();
}

// Persistent: block b takes tiles b, b + gridDim.x, ...; the next tile's
// values load into the other buffer while this one's are computed and
// stored.
template <typename T>
__global__ void __launch_bounds__(C1D_THREADS, C1D_BLOCKS_PER_SM)
    samd_conv1d_kernel(const T* __restrict__ x, const void* __restrict__ k,
                       int* __restrict__ out, Conv1dArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Conv1dSmem lay(a.tile_chunks, a.lanes, (int)sizeof(T));
  u64* prods = (u64*)(smem + lay.prods);
  uint32_t* kw_s = (uint32_t*)(smem + lay.kw);
  const int tid = threadIdx.x;
  const int V = a.tile_chunks * a.lanes;  // values and outputs of a tile
  const bool vectors = a.stride == 1 && ((uintptr_t)x & 15) == 0;
  const bool sg = a.signed_lanes != 0;
  const int tl = a.taps - 1;

  if (tid == 0) {
    uint32_t w = 0;
    for (int t = 0; t < a.taps; ++t) {
      const uint32_t u =
          (uint32_t)read_int(k, t * a.k_stride, a.k_code) & a.vmask;
      w += ((u ^ a.vsign) - a.vsign) << (t * a.L);
    }
    *kw_s = w;
  }
  long long b = blockIdx.x;
  load_tile((T*)smem, x, a, lay.pre, V, b * V, vectors);
  for (int it = 0; b < a.tiles; b += gridDim.x, ++it) {
    const T* xs = (const T*)(smem + (it & 1) * lay.buf) + lay.pre;
    const long long next = b + gridDim.x;
    if (next < a.tiles)
      load_tile((T*)(smem + ((it + 1) & 1) * lay.buf), x, a, lay.pre, V,
                next * V, vectors);
    else
      cp_async_commit();  // an empty group: the wait below stays one back
    cp_async_wait<1>();
    __syncthreads();

    // each chunk's product once; the halo chunk's first (prods[0])
    const uint32_t kw = *kw_s;
    for (int i = tid; i < a.tile_chunks; i += C1D_THREADS)
      prods[i + 1] = chunk_product(
          pack_chunk(xs + i * a.lanes, a.lanes, a.L, a.vmask, a.vsign), kw,
          sg, a.msb);
    if (tid == C1D_THREADS - 1)
      prods[0] = chunk_product(
          pack_chunk(xs - a.lanes, a.lanes, a.L, a.vmask, a.vsign), kw, sg,
          a.msb);
    __syncthreads();

    // four consecutive outputs a thread, stored as one 16-byte vector:
    // output j = lane j mod lanes of chunk j div lanes (+ lane j mod
    // lanes + lanes of the chunk before when j mod lanes < taps - 1)
    const long long base = b * V;
    const long long left = a.n_out - base;
    const int count = left < V ? (int)left : V;
    int* dst = out + base;
    for (int v = tid; 4 * v < count; v += C1D_THREADS) {
      const int j = 4 * v;
      int c = a.lanes == 1 ? j : (int)__umulhi((uint32_t)j, a.lanes_magic);
      int t = j - c * a.lanes;
      int r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t val = (uint32_t)product_lane(prods[c + 1], t, a.L, sg);
        if (t < tl)
          val += (uint32_t)product_lane(prods[c], t + a.lanes, a.L, sg);
        r[q] = (int)val;
        if (++t == a.lanes) {
          t = 0;
          ++c;
        }
      }
      if (j + 4 <= count) {
        *reinterpret_cast<int4*>(dst + j) = make_int4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < count) dst[j + q] = r[q];
      }
    }
    __syncthreads();  // prods and this buffer are free for the next tile
  }
}

__global__ void __launch_bounds__(CHUNK_THREADS)
    samd_conv_chunks_kernel(const uint32_t* __restrict__ xw,
                            const uint32_t* __restrict__ k_word,
                            int* __restrict__ out, int nc, int L,
                            int out_lanes, int signed_lanes, u64 msb) {
  extern __shared__ __align__(16) int staged[];  // [CHUNK_THREADS][out_lanes]
  const int tid = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * CHUNK_THREADS;
  if (c0 + tid < nc) {
    const bool sg = signed_lanes != 0;
    const u64 p = chunk_product(xw[c0 + tid], *k_word, sg, msb);
    for (int t = 0; t < out_lanes; ++t)
      staged[tid * out_lanes + t] = product_lane(p, t, L, sg);
  }
  __syncthreads();
  const long long left = nc - c0;
  const int count = (left < CHUNK_THREADS ? (int)left : CHUNK_THREADS) *
                    out_lanes;
  int* dst = out + c0 * out_lanes;
  for (int v = tid; 4 * v < count; v += CHUNK_THREADS) {
    const int j = 4 * v;
    if (j + 4 <= count) {
      *reinterpret_cast<int4*>(dst + j) =
          *reinterpret_cast<const int4*>(staged + j);
    } else {
      for (int q = j; q < count; ++q) dst[q] = staged[q];
    }
  }
}

u64 lane_msb(int L) {
  u64 msb = 0;
  for (int b = L - 1; b < 64; b += L) msb |= 1ull << b;
  return msb;
}

template <typename T>
int run_conv1d(const void* x, const void* k, void* out, const Conv1dArgs& a,
               int blocks, cudaStream_t s) {
  const int smem = Conv1dSmem(a.tile_chunks, a.lanes, (int)sizeof(T)).bytes;
  if (smem > C1D_MAX_SMEM) return (int)cudaErrorInvalidValue;
  samd_conv1d_kernel<T><<<blocks, C1D_THREADS, smem, s>>>(
      (const T*)x, k, (int*)out, a);
  return (int)cudaGetLastError();
}

// static and dynamic shared memory of one samd_conv1d_kernel<T> block
template <typename T>
int conv1d_block_smem(int tile_chunks, int lanes) {
  const int s = static_smem(samd_conv1d_kernel<T>);
  if (s < 0) return -1;
  return s + Conv1dSmem(tile_chunks, lanes, (int)sizeof(T)).bytes;
}

}  // namespace

extern "C" {

// x f32 (x_bf16 = 0) or bf16 [C, H, W]; packed uint32 [KH, KW, CW, N];
// scale f32 [N]; out [OH, OW, N] in x's type; ws bf16 workspace of
// ws_elems; all contiguous. The plan is the wrapper's
// (samd_conv.conv2d_plan): K runs in `steps` steps of `step_k` values
// (refused unless `step_k` is the one this build has for vpw and x's
// type, and the steps cover K), cut into `splits` equal runs (a divisor
// of the steps, at most 8), one cluster of `splits` blocks per output
// tile. Both return cudaGetLastError().

// x staged pixel-major with its padding; each tap a row offset
int samd_conv2d_launch(const void* x, const void* packed, const void* scale,
                       void* out, void* ws, long long ws_elems, int C, int H,
                       int W, int KH, int KW, int CW, int N, int pad,
                       int bits, int lane_width, int vpw, int signed_lanes,
                       int x_bf16, int splits, int step_k, int steps,
                       void* stream) {
  return launch_conv2d(x, packed, scale, out, ws, ws_elems, C, H, W, KH, KW,
                       CW, N, pad, bits, lane_width, vpw, signed_lanes,
                       x_bf16, splits, step_k, steps, 0, stream);
}

// x staged as KH * KW * C products per output pixel (few channels)
int samd_conv2d_im2col_launch(const void* x, const void* packed,
                              const void* scale, void* out, void* ws,
                              long long ws_elems, int C, int H, int W,
                              int KH, int KW, int CW, int N, int pad,
                              int bits, int lane_width, int vpw,
                              int signed_lanes, int x_bf16, int splits,
                              int step_k, int steps, void* stream) {
  return launch_conv2d(x, packed, scale, out, ws, ws_elems, C, H, W, KH, KW,
                       CW, N, pad, bits, lane_width, vpw, signed_lanes,
                       x_bf16, splits, step_k, steps, 1, stream);
}

// x [n] of element stride `stride` (int8, uint8, int16, int32, int64 by
// x_code 0-4) and k [taps] of element stride `k_stride` (k_code, the
// same codes), both on the card;
// out int32 [n_out = n + taps - 1]. The plan is the wrapper's
// (samd_conv.conv1d_plan): `tiles` tiles of `tile_chunks` chunks of
// `lanes` values of width L, covering n_out exactly (refused otherwise),
// taken by `blocks` persistent blocks. Returns cudaGetLastError().
int samd_conv1d_launch(const void* x, long long n, long long stride,
                       const void* k, long long k_stride, int k_code,
                       void* out, long long n_out,
                       int tile_chunks, int tiles, int blocks, int L,
                       int lanes, int taps, int bits, int signed_lanes,
                       int x_code, void* stream) {
  const long long tile = (long long)tile_chunks * lanes;
  if (L < 1 || L > 32 || lanes < 1 || lanes * L > 32 || taps < 1 ||
      taps > lanes || (lanes + taps - 1) * L > 64 || bits < 1 || bits > L ||
      tile_chunks < 16 || tile_chunks % 16 || n < 0 || stride < 0 ||
      k_stride < 0 || n_out != n + taps - 1 || n_out < 1 || tiles < 1 ||
      (long long)tiles * tile < n_out ||
      (long long)(tiles - 1) * tile >= n_out || blocks < 1 ||
      blocks > tiles || k_code < 0 || k_code > 4)
    return (int)cudaErrorInvalidValue;
  Conv1dArgs a;
  a.n = n; a.stride = stride; a.k_stride = k_stride; a.n_out = n_out;
  a.tiles = tiles;
  a.msb = lane_msb(L);
  a.vmask = bits >= 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
  a.vsign = signed_lanes ? 1u << (bits - 1) : 0u;
  a.lanes_magic = lanes == 1 ? 0u
                             : (uint32_t)(((1ull << 32) + lanes - 1) / lanes);
  a.tile_chunks = tile_chunks; a.L = L; a.lanes = lanes; a.taps = taps;
  a.k_code = k_code; a.signed_lanes = signed_lanes;
  cudaStream_t s = (cudaStream_t)stream;
  switch (x_code) {
    case 0: return run_conv1d<int8_t>(x, k, out, a, blocks, s);
    case 1: return run_conv1d<uint8_t>(x, k, out, a, blocks, s);
    case 2: return run_conv1d<int16_t>(x, k, out, a, blocks, s);
    case 3: return run_conv1d<int32_t>(x, k, out, a, blocks, s);
    case 4: return run_conv1d<long long>(x, k, out, a, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x_words uint32 [nc]; k_word uint32 [1]; out int32 [nc, out_lanes]; lanes
// of width L (out_lanes * L <= 64). Returns cudaGetLastError().
int samd_conv_chunks_launch(const void* x_words, const void* k_word, void* out,
                            int nc, int L, int out_lanes, int signed_lanes,
                            void* stream) {
  if (L < 1 || L > 32 || out_lanes < 1 || out_lanes * L > 64 || nc < 1)
    return (int)cudaErrorInvalidValue;
  samd_conv_chunks_kernel<<<(nc + CHUNK_THREADS - 1) / CHUNK_THREADS,
                            CHUNK_THREADS, CHUNK_THREADS * out_lanes * 4,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)x_words, (const uint32_t*)k_word, (int*)out, nc, L,
      out_lanes, signed_lanes, lane_msb(L));
  return (int)cudaGetLastError();
}

// bytes of shared memory, static and dynamic, the largest block of a
// samd_conv2d launch (im2col = 0) or samd_conv2d_im2col launch
// (im2col = 1) takes at vpw values a word, bf16 x or f32 x, with wide
// codes (signed lanes over 9 bits, unsigned over 8); -1 where no
// instantiation exists or on a runtime error. Launches nothing.
int samd_conv2d_smem_bytes(int vpw, int x_bf16, int wide, int im2col) {
#define SAMD_VPW(V) \
  case V:           \
    return conv2d_smem_of<V>(x_bf16, wide, im2col);
  switch (vpw) {
    SAMD_VPW(1) SAMD_VPW(2) SAMD_VPW(3) SAMD_VPW(4) SAMD_VPW(5)
    SAMD_VPW(6) SAMD_VPW(8) SAMD_VPW(10) SAMD_VPW(16) SAMD_VPW(32)
    default:
      return -1;
  }
#undef SAMD_VPW
}

// bytes of shared memory, static and dynamic, one samd_conv1d block takes
// for a tile of `tile_chunks` chunks of `lanes` values of x's type
// (`x_code` as samd_conv1d_launch takes it); -1 for an unknown code or
// on a runtime error. Launches nothing.
int samd_conv1d_smem_bytes(int tile_chunks, int lanes, int x_code) {
  switch (x_code) {
    case 0: return conv1d_block_smem<int8_t>(tile_chunks, lanes);
    case 1: return conv1d_block_smem<uint8_t>(tile_chunks, lanes);
    case 2: return conv1d_block_smem<int16_t>(tile_chunks, lanes);
    case 3: return conv1d_block_smem<int32_t>(tile_chunks, lanes);
    case 4: return conv1d_block_smem<long long>(tile_chunks, lanes);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
