// SAMD packed-weight matmul for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel `samd_matmul` of
// src/repro/kernels/samd_matmul.py (`_kernel`, `unpack_codes`):
//
//   out[M, N] = x[M, K] @ (codes(packed[ceil(K/vpw), N]) * scale[1, N])
//
// `packed` holds b-bit lanes of width `lane_width` along K, `vpw` lanes per
// 32-bit word (lane 0 in the low bits), sign-fixed unless `signed_lanes` is
// 0. As in the reference, the raw integer codes are cast to bf16 (exact up
// to 9 bits; wider codes round as the reference's `codes.astype(x.dtype)`
// does), multiplied by the bf16 activations with f32 accumulation, and the
// per-column scale is applied once at the store.
//
// What bounds it on an H100. At decode (M = 8 rows, the draft and plain
// decode; M = 24 in the 4-bit verify) the product reads each packed weight
// byte once and does 2*M*vpw/4 operations per byte: 32 at 4 bits, under
// the card's ~295 bf16 operations per byte, so HBM bytes bound it. At
// prefill (M = 8 x prompt bucket, 256-2048 rows) it does hundreds of
// operations per byte and the tensor-core rate bounds it. CUDA cores
// cannot reach the byte bound even at decode (4-bit at 3.35 TB/s needs
// ~107 TFLOP/s, above the 67 TFLOP/s f32 peak), so every M runs on the
// tensor cores.
//
// Design. The block computes the transposed product
//
//   out^T[N, M] = W^T[N, K] . x^T[K, M]
//
// with `mma.sync.m16n8k16` (bf16 in, f32 accumulate): the unpacked codes
// are the A operand (16 output columns as the MMA's rows) and x^T is B
// (8 rows of x per MMA). So M = 8 fills an MMA exactly, and one body
// serves every M. `wgmma` would need 64-row A tiles staged in shared
// memory in its own layout; `mma.sync` takes A from registers, which is
// where the codes are unpacked, and at decode the kernel is bound by
// bytes, not by the MMA rate.
//
// * A K-step is 16 words per column (16 * vpw values of K, a multiple of
//   the MMA's k = 16 for every vpw). Each thread of an MMA owns 4 slots of
//   k per k-tile (PTX fragment columns 2t, 2t+1, 2t+8, 2t+9 for the
//   thread with index t in its quad); the kernel maps them onto the
//   thread's own 4 consecutive words of the step (values 4t*vpw ...
//   4(t+1)*vpw - 1), so with vpw a compile-time constant every lane's word
//   and shift are constants, and B's four values are four consecutive
//   bf16 of x: one 8-byte shared load. The sum over K does not depend on
//   the order, so A and B agree slot by slot and nothing is permuted in
//   memory.
// * A lane unpacks in three instructions: shift, one LOP3
//   ((u & mask) ^ (0x4B000000 | sign_bit)) and one FADD, which read the
//   code as a float (sign-fixed by the xor-and-subtract identity), then
//   two codes pack to bf16x2.
// * Word tiles [16, BN] and x tiles [rows, 16 * vpw] are copied with
//   `cp.async` into a ring of STAGES stages in shared memory, so the next
//   steps' loads are in flight while the current step unpacks and
//   multiplies. Copies are 16 bytes where N % 4 == 0 (words) or
//   K % 8 == 0 (x) and the base is aligned, else 4-byte word copies and
//   plain x loads in the same kernel. Out-of-range words and x are
//   zero-filled, so lanes past K meet x = 0 and nothing is read out of
//   bounds.
// * Decode (`samd_matmul_splitk_launch`, M <= 32): blocks of 32 output
//   columns x all M rows, split along K into as many blocks as the
//   K-steps allow, up to 8 splits (the split rule is the wrapper's): a
//   block of 2 warps and a few K-steps hides little latency alone, and
//   the main path's shapes run 256-704 blocks. The splits of
//   one output tile form one thread-block cluster (at most 8 blocks):
//   each leaves its f32 partial in its own shared memory, then each rank
//   sums its share of the tile over all ranks' partials, in rank order,
//   through distributed shared memory, scales and stores. One launch, no
//   workspace, and two calls give bit-identical outputs (no atomics).
// * Prefill (`samd_matmul_tile_launch`, M > 32): blocks of 128 output
//   columns x 64 rows of x (4 warps, each 32 columns x 64 rows: 16 MMAs
//   per k-tile for 16 unpacked codes per thread), 3 stages; it splits K
//   the same way only when the tiles fill fewer than half the 132 SMs,
//   and then toward one wave (a part-filled second wave of these large
//   blocks costs more than the split saves).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int STEP_WORDS = 16;  // words per column per K-step
constexpr int W_PAD = 4;        // words of padding per word-tile row
constexpr int X_PAD = 8;        // bf16 of padding per x-tile row
constexpr int MAX_SPLITS = 8;   // the portable cluster size

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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

template <int VPW, int WARPS, int NT, int MT>
struct Tile {
  static constexpr int BN = WARPS * NT * 16;  // output columns per block
  static constexpr int BM = MT * 8;           // rows of x per block
  static constexpr int THREADS = WARPS * 32;
  static constexpr int KS = STEP_WORDS * VPW; // values of K per step
  static constexpr int SW = BN + W_PAD;       // word-tile row stride
  static constexpr int SX = KS + X_PAD;       // x-tile row stride
  static constexpr int W_BYTES = STEP_WORDS * SW * 4;
  // bytes of one stage when the x tile holds `xrows` rows
  static __host__ __device__ int stage_bytes(int xrows) {
    return W_BYTES + xrows * SX * 2;
  }
};

template <int VPW, int WARPS, int NT, int MT, int STAGES>
__global__ void __launch_bounds__(WARPS * 32)
samd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const uint32_t* __restrict__ packed,
                const float* __restrict__ scale,
                __nv_bfloat16* __restrict__ out, int M, int N, int K,
                int kw, int bits, int lane_width, int signed_lanes,
                int splits, int steps_per_split, int total_steps, int xrows,
                int x_vec, int w_vec) {
  using T = Tile<VPW, WARPS, NT, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_bytes = T::stage_bytes(xrows);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * T::BN;
  const int m0 = blockIdx.y * T::BM;
  const int split = blockIdx.z;
  const int s_begin = split * steps_per_split;
  const int s_end = min(s_begin + steps_per_split, total_steps);
  const int nsteps = max(0, s_end - s_begin);
  const int mtc = (min(T::BM, M - m0) + 7) / 8;  // m8 tiles of this block
  const int rows = mtc * 8;                      // x rows it stages

  Lanes ln;
  ln.lane_width = lane_width;
  ln.mask = bits >= 32 ? 0xffffffffu : (1u << bits) - 1u;
  const uint32_t sb = signed_lanes ? (1u << (bits - 1)) : 0u;
  ln.magic = 0x4B000000u | sb;
  ln.bias = 8388608.f + (float)sb;

  auto stage_w = [&](int st) {
    return reinterpret_cast<uint32_t*>(smem + (size_t)st * stage_bytes);
  };
  auto stage_x = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + (size_t)st * stage_bytes +
                                            T::W_BYTES);
  };

  // copy K-step `s` (words w0 .. w0 + 15, values k0 .. k0 + KS - 1) into
  // stage `st`; everything out of range is zero-filled
  auto load_step = [&](int s, int st) {
    uint32_t* sw = stage_w(st);
    __nv_bfloat16* sx = stage_x(st);
    const int w0 = s * STEP_WORDS;
    const int k0 = w0 * VPW;
    if (w_vec) {
      constexpr int CPR = T::BN / 4;
      for (int c = tid; c < STEP_WORDS * CPR; c += T::THREADS) {
        const int r = c / CPR, cc = (c % CPR) * 4;
        const int gr = w0 + r, gc = n0 + cc;
        const bool ok = gr < kw && gc < N;
        cp_async16(sw + r * T::SW + cc,
                   ok ? packed + (size_t)gr * N + gc : packed, ok);
      }
    } else {
      for (int c = tid; c < STEP_WORDS * T::BN; c += T::THREADS) {
        const int r = c / T::BN, cc = c % T::BN;
        const int gr = w0 + r, gc = n0 + cc;
        const bool ok = gr < kw && gc < N;
        cp_async4(sw + r * T::SW + cc,
                  ok ? packed + (size_t)gr * N + gc : packed, ok);
      }
    }
    if (x_vec) {
      constexpr int CPR = T::KS / 8;
      for (int c = tid; c < rows * CPR; c += T::THREADS) {
        const int r = c / CPR, kc = (c % CPR) * 8;
        const int gm = m0 + r, gk = k0 + kc;
        const bool ok = gm < M && gk < K;
        cp_async16(sx + r * T::SX + kc, ok ? x + (size_t)gm * K + gk : x, ok);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int c = tid; c < rows * T::KS; c += T::THREADS) {
        const int r = c / T::KS, kc = c % T::KS;
        const int gm = m0 + r, gk = k0 + kc;
        sx[r * T::SX + kc] =
            (gm < M && gk < K) ? x[(size_t)gm * K + gk] : zero;
      }
    }
  };

  float acc[NT][MT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nsteps) load_step(s_begin + i, i);
    cp_async_commit();
  }

  const int col_w = warp * NT * 16;  // this warp's first column in the tile
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    if (s + STAGES - 1 < nsteps)
      load_step(s_begin + s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();

    const uint32_t* sw = stage_w(s % STAGES);
    const __nv_bfloat16* sx = stage_x(s % STAGES);
    // this thread's 4 words of the step, for rows g and g + 8 of each
    // of the warp's n16 tiles
    uint32_t wv[NT][2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[nt][r][j] = sw[(4 * t + j) * T::SW + col_w + nt * 16 + g + 8 * r];
    const __nv_bfloat16* xrow = sx + g * T::SX + 4 * t * VPW;

#pragma unroll
    for (int kt = 0; kt < VPW; ++kt) {
      // values 4kt .. 4kt + 3 of the thread's 4 * VPW: word v / VPW,
      // lane v % VPW (constants), in slots 2t, 2t + 1, 2t + 8, 2t + 9
      uint32_t a[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float f[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int v = 4 * kt + q;
            f[r][q] = lane_code(wv[nt][r][v / VPW], v % VPW, ln);
          }
        a[nt][0] = pack_bf16x2(f[0][0], f[0][1]);
        a[nt][1] = pack_bf16x2(f[1][0], f[1][1]);
        a[nt][2] = pack_bf16x2(f[0][2], f[0][3]);
        a[nt][3] = pack_bf16x2(f[1][2], f[1][3]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mtc) {
          const uint2 b = *reinterpret_cast<const uint2*>(
              xrow + mt * 8 * T::SX + 4 * kt);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][mt], a[nt], b.x, b.y);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment: c0, c1 at (column g, rows 2t, 2t + 1), c2, c3 at column
  // g + 8; columns are the output's N, rows its M
  if (splits > 1) {
    // the K splits of this output tile are one cluster: each leaves its
    // partial sums in its own shared memory, then every rank sums a
    // 1/splits share of the tile over the ranks' memories in rank order
    // (deterministic, no atomics), scales it and stores it
    cg::cluster_group cluster = cg::this_cluster();
    float* red = reinterpret_cast<float*>(smem);
    const int used = NT * mtc * 4 * T::THREADS;  // slot-major, then thread
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (mt < mtc) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            red[((nt * mtc + mt) * 4 + q) * T::THREADS + tid] =
                acc[nt][mt][q];
        }
    cluster.sync();
    const int share = (used + splits - 1) / splits;
    const int lo = (int)cluster.block_rank() * share;
    const int hi = min(lo + share, used);
    for (int i = lo + tid; i < hi; i += T::THREADS) {
      float part[MAX_SPLITS];
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r)
        if (r < splits) part[r] = cluster.map_shared_rank(red, r)[i];
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r)
        if (r < splits) v += part[r];
      const int slot = i / T::THREADS, owner = i % T::THREADS;
      const int q = slot & 3, nt = (slot >> 2) / mtc, mt = (slot >> 2) % mtc;
      const int ol = owner & 31;
      const int n = n0 + (owner >> 5) * NT * 16 + nt * 16 + (ol >> 2) +
                    (q >= 2 ? 8 : 0);
      const int m = m0 + mt * 8 + 2 * (ol & 3) + (q & 1);
      if (n < N && m < M)
        out[(size_t)m * N + n] = __float2bfloat16(v * scale[n]);
    }
    cluster.sync();  // no block leaves while another reads its memory
    return;
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= mtc) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + col_w + nt * 16 + g + (q >= 2 ? 8 : 0);
        const int m = m0 + mt * 8 + 2 * t + (q & 1);
        if (n < N && m < M)
          out[(size_t)m * N + n] = __float2bfloat16(acc[nt][mt][q] * scale[n]);
      }
    }
  }
}

// rows of x a block stages, and the dynamic shared memory a launch of M
// rows in `splits` K splits takes: the stage ring, or the split-K
// reduction buffer where that is larger
template <int VPW, int WARPS, int NT, int MT>
int x_rows(int M) {
  using T = Tile<VPW, WARPS, NT, MT>;
  return M < T::BM ? (M + 7) / 8 * 8 : T::BM;
}

template <int VPW, int WARPS, int NT, int MT, int STAGES>
size_t dynamic_smem(int M, int splits) {
  using T = Tile<VPW, WARPS, NT, MT>;
  size_t smem = (size_t)STAGES * T::stage_bytes(x_rows<VPW, WARPS, NT, MT>(M));
  const size_t red = (size_t)NT * MT * 4 * T::THREADS * sizeof(float);
  if (splits > 1 && red > smem) smem = red;
  return smem;
}

template <int VPW, int WARPS, int NT, int MT, int STAGES>
int launch_vpw(const void* x, const void* packed, const void* scale,
               void* out, int M, int N, int K, int bits, int lane_width,
               int signed_lanes, int splits, int steps_per_split,
               cudaStream_t stream) {
  using T = Tile<VPW, WARPS, NT, MT>;
  const int kw = (K + VPW - 1) / VPW;
  const int total_steps = (kw + STEP_WORDS - 1) / STEP_WORDS;
  const int xrows = x_rows<VPW, WARPS, NT, MT>(M);
  const size_t smem = dynamic_smem<VPW, WARPS, NT, MT, STAGES>(M, splits);
  auto kernel = samd_mma_kernel<VPW, WARPS, NT, MT, STAGES>;
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
  const int x_vec = (K % 8 == 0) && ((uintptr_t)x % 16 == 0);
  const int w_vec = (N % 4 == 0) && ((uintptr_t)packed % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM,
                     splits);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;  // the K splits of one output tile
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const __nv_bfloat16*)x, (const uint32_t*)packed,
      (const float*)scale, (__nv_bfloat16*)out, M, N, K, kw, bits,
      lane_width, signed_lanes, splits, steps_per_split, total_steps, xrows,
      x_vec, w_vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// one instantiation per lanes-per-word count 32 / lane_width can take
template <int WARPS, int NT, int MT, int STAGES>
int launch(const void* x, const void* packed, const void* scale, void* out,
           int M, int N, int K, int bits, int lane_width, int vpw,
           int signed_lanes, int splits, int steps_per_split, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || steps_per_split < 1 || bits < 1 ||
      bits > lane_width ||
      lane_width * vpw > 32 || M > 65535 * MT * 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SAMD_VPW(V)                                                        \
  case V:                                                                  \
    return launch_vpw<V, WARPS, NT, MT, STAGES>(                           \
        x, packed, scale, out, M, N, K, bits, lane_width, signed_lanes,     \
        splits, steps_per_split, s);
  switch (vpw) {
    SAMD_VPW(1) SAMD_VPW(2) SAMD_VPW(3) SAMD_VPW(4) SAMD_VPW(5)
    SAMD_VPW(6) SAMD_VPW(8) SAMD_VPW(10) SAMD_VPW(16) SAMD_VPW(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SAMD_VPW
}

// the shared memory one block of a launch takes: the kernel's static
// bytes (as ptxas allocated them) plus the dynamic bytes launch_vpw
// passes; -1 where the runtime cannot read the kernel's attributes
template <int VPW, int WARPS, int NT, int MT, int STAGES>
int block_smem(int M, int splits) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr,
                            samd_mma_kernel<VPW, WARPS, NT, MT, STAGES>) !=
      cudaSuccess)
    return -1;
  return (int)(attr.sharedSizeBytes +
               dynamic_smem<VPW, WARPS, NT, MT, STAGES>(M, splits));
}

// block_smem of the instantiation launch picks, -1 for a vpw without one
template <int WARPS, int NT, int MT, int STAGES>
int smem_of(int M, int vpw, int splits) {
#define SAMD_VPW(V)                                                        \
  case V:                                                                  \
    return block_smem<V, WARPS, NT, MT, STAGES>(M, splits);
  switch (vpw) {
    SAMD_VPW(1) SAMD_VPW(2) SAMD_VPW(3) SAMD_VPW(4) SAMD_VPW(5)
    SAMD_VPW(6) SAMD_VPW(8) SAMD_VPW(10) SAMD_VPW(16) SAMD_VPW(32)
    default:
      return -1;
  }
#undef SAMD_VPW
}

}  // namespace

extern "C" {

// x bf16 [M, K]; packed uint32 [>= ceil(K/vpw), N]; scale f32 [N];
// out bf16 [M, N]; all contiguous. The K-steps of 16 words are cut into
// `splits` (at most MAX_SPLITS) runs of `steps_per_split`, one cluster of
// `splits` blocks per output tile. Both return cudaGetLastError().

// decode: 2 warps, 32 output columns x up to 32 rows a block, 4 stages
int samd_matmul_splitk_launch(const void* x, const void* packed,
                              const void* scale, void* out, int M, int N,
                              int K, int bits, int lane_width, int vpw,
                              int signed_lanes, int splits,
                              int steps_per_split, void* stream) {
  if (M > 32) return (int)cudaErrorInvalidValue;
  return launch<2, 1, 4, 4>(x, packed, scale, out, M, N, K, bits,
                            lane_width, vpw, signed_lanes, splits,
                            steps_per_split, stream);
}

// prefill: 4 warps, 128 output columns x 64 rows a block, 3 stages
int samd_matmul_tile_launch(const void* x, const void* packed,
                            const void* scale, void* out, int M, int N,
                            int K, int bits, int lane_width, int vpw,
                            int signed_lanes, int splits, int steps_per_split,
                            void* stream) {
  return launch<4, 2, 8, 3>(x, packed, scale, out, M, N, K, bits,
                            lane_width, vpw, signed_lanes, splits,
                            steps_per_split, stream);
}

// bytes of shared memory, static and dynamic, one block of the split-K
// (tile = 0) or tile (tile = 1) launcher takes at M rows, vpw values a
// word and `splits` K splits; -1 on a runtime error. Launches nothing.
int samd_matmul_smem_bytes(int tile, int M, int vpw, int splits) {
  return tile ? smem_of<4, 2, 8, 3>(M, vpw, splits)
              : smem_of<2, 1, 4, 4>(M, vpw, splits);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
