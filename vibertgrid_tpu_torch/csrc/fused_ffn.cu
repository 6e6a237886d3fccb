// Fused transformer FFN tail: out = LN(x + gelu(x W1^T + b1) W2^T + b2)
// over rows of x [N, D], with W1 [F, D] and W2 [D, F] in nn.Linear layout.
//
// Replaces: vibertgrid_tpu/ops/fused_ffn.py::_ffn_kernel (the inference
// fused_ffn) and, with the SAVED template flag, ::_ffn_saved_kernel (the
// training forward, which also writes the pre-gelu intermediate h1, the
// normalised rows yhat and each row's inverse deviation rsig so the backward
// needs no rematerialisation). One body serves both, so they cannot drift.
// In training the second product's output is dropped by the stateless hash
// of ops/dropout.py before the residual. The TPU kernel kept W1, W2 and a whole [R, 4D] fp32
// intermediate in 16 MB of VMEM (_row_tile, fused_ffn.py:180). A Hopper
// block has 227 KB of shared memory, so this kernel streams the F axis.
//
// Bound on this card: operations. At the flagship (N=8192, D=768, F=3072,
// bf16) the work is 4*N*D*F = 77.3 GFLOP, 78 us at the 989 TFLOP/s bf16
// tensor peak, against 21.9 MB of bytes (x, out, W1, W2), 7 us at 3.35 TB/s.
//
// Two bodies. bf16 with D = 768 (BERT-base, RoBERTa-base: every full-width
// configuration) runs as two wgmma kernels, an up-projection and a
// down-projection with the LayerNorm, through an [N, F] bf16 scratch that the
// caller passes: namespace hopper at the end of this file, which has its own
// note. Every other case (fp32; bf16 at D = 64, the tiny configuration's
// width, or 128-512, which no configuration runs) takes fp32 FMAs on the CUDA
// cores, with bf16 storage where the inputs are bf16.
//
// Design of the FMA body: one block owns R = 32 full rows and walks the F
// axis in chunks of FC = 128:
//   A) h = gelu(x . W1[c:c+FC]^T + b1[c:c+FC]), fp32, rounded to the storage
//      dtype (as the TPU kernel casts before its second dot, fused_ffn.py:152)
//      and kept in shared memory [32, 128];
//   B) acc += h . W2[:, c:c+FC]^T into the block's fp32 [32, D] accumulator,
//      which stays in registers for the whole walk (96 floats a thread at
//      D = 768), so the [N, 4D] intermediate never reaches device memory.
// The epilogue adds b2 and the residual and normalises each row with fp32
// statistics, variance E[x^2] - E[x]^2 as models/norm.py's LayerNorm.
// gelu is the exact (erf) form with the same rational erf polynomial the TPU
// kernel used (fused_ffn.py::_erf_f32), so the plain twin and the kernel
// differ only in summation order and rounding.

#include <atomic>

#include "common.cuh"
#include "ffn_down_ln.cuh"
#include "wgmma.cuh"

namespace {

// fp32 FMA body: the 32 x D accumulator is 4 rows x D/32 columns a thread;
// x rows (fp32, 96 KB at D = 768), a 16 x 128 W1 tile, h [32, 128] and a
// 16 x D W2 tile sit in shared memory (168 KB at D = 768).
constexpr int kThreads = 256;  // 8 warps
constexpr int kR = 32;         // rows per block, 4 per warp
constexpr int kFC = 128;       // F-chunk width
constexpr int kKT = 16;        // D-depth of a W1 tile
constexpr int kKB = 16;        // F-depth of a W2 tile

// The quotient is taken by the approximate division (within 2 ulps of fp32
// for this denominator, whose magnitude stays below 1): the exact one made
// the wgmma up-projection, whose epilogue runs gelu on every element of h,
// about a tenth slower on an H100 (PERF.md has the times).
__device__ __forceinline__ float erf_poly(float x) {
  x = fminf(fmaxf(x, -3.832506856900711f), 3.832506856900711f);
  const float z = x * x;
  float a = -2.72614225801306e-10f;
  a = a * z + 2.77068142495902e-08f;
  a = a * z + -2.10102402082508e-06f;
  a = a * z + -5.69250639462346e-05f;
  a = a * z + -7.34990630326855e-04f;
  a = a * z + -2.95459980854025e-03f;
  a = a * z + -1.60960333262415e-02f;
  a = a * x;
  float b = -1.45660718464996e-05f;
  b = b * z + -2.13374055278905e-04f;
  b = b * z + -1.68282697438203e-03f;
  b = b * z + -7.37332916720468e-03f;
  b = b * z + -1.42647390514189e-02f;
  return __fdividef(a, b);
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erf_poly(x * 0.70710678118654752f));
}

// Raises a kernel's dynamic shared-memory limit to `bytes` once for each
// device (the attribute holds for the device current at the call) rather
// than on every call. `ready` is the caller's record for that kernel, one bit
// a device.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, std::atomic<uint32_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

// What the saved-residual variant also writes (null otherwise).
template <typename T>
struct Saved {
  T* h1;        // [N, F] x W1^T + b1 before gelu
  T* yhat;      // [N, D] normalised rows before gamma, beta
  float* rsig;  // [N] 1 / sqrt(var + eps)
};

// NJ = D / 32: accumulator columns per thread.
template <typename T, int NJ, bool SAVED>
__global__ void __launch_bounds__(kThreads, 1)
ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
           const T* __restrict__ w2, const float* __restrict__ b2,
           const float* __restrict__ gamma, const float* __restrict__ beta,
           T* __restrict__ out, Saved<T> saved, int N, int F, float eps, vg::Dropout drop) {
  constexpr int D = NJ * 32;
  drop.load();
  extern __shared__ float smem[];
  float* Xs = smem;                      // [kR][D]
  float* W1s = Xs + kR * D;              // [kKT][kFC + 1]
  float* Hs = W1s + kKT * (kFC + 1);     // [kR][kFC]
  float* W2s = Hs + kR * kFC;            // [kKB][D + 1]

  const int row_base = blockIdx.x * kR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 4;  // this warp's 4 rows within the block

  for (int i = threadIdx.x; i < kR * D; i += kThreads) {
    const int r = i / D, row = row_base + r;
    Xs[i] = row < N ? vg::to_f32(x[(size_t)row * D + i % D]) : 0.f;
  }

  float acc[4][NJ] = {};
  for (int c0 = 0; c0 < F; c0 += kFC) {
    // A) h[:, c0:c0+FC]; thread owns rows r0..r0+3, columns lane + 32 j.
    float hacc[4][4] = {};
    for (int k0 = 0; k0 < D; k0 += kKT) {
      __syncthreads();
      for (int i = threadIdx.x; i < kKT * kFC; i += kThreads) {
        const int f = i / kKT, kk = i % kKT;
        W1s[kk * (kFC + 1) + f] = vg::to_f32(w1[(size_t)(c0 + f) * D + k0 + kk]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        float a[4], bw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Xs[(r0 + i) * D + k0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = W1s[kk * (kFC + 1) + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) hacc[i][j] = fmaf(a[i], bw[j], hacc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bias = b1[c0 + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pre = hacc[i][j] + bias;
        if (SAVED && row_base + r0 + i < N)
          saved.h1[(size_t)(row_base + r0 + i) * F + c0 + lane + 32 * j] = vg::from_f32<T>(pre);
        Hs[(r0 + i) * kFC + lane + 32 * j] = vg::round_through<T>(gelu_exact(pre));
      }
    }

    // B) acc += h . W2[:, c0:c0+FC]^T.
    for (int f0 = 0; f0 < kFC; f0 += kKB) {
      __syncthreads();
      for (int i = threadIdx.x; i < kKB * D; i += kThreads) {
        const int n = i / kKB, f = i % kKB;
        W2s[f * (D + 1) + n] = vg::to_f32(w2[(size_t)n * F + c0 + f0 + f]);
      }
      __syncthreads();
#pragma unroll 4
      for (int f = 0; f < kKB; ++f) {
        float hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) hv[i] = Hs[(r0 + i) * kFC + f0 + f];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float w = W2s[f * (D + 1) + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(hv[i], w, acc[i][j]);
        }
      }
    }
  }

  // Epilogue: + b2, + residual, LayerNorm over each of the warp's rows.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      float o = acc[i][j] + b2[c];
      if (drop.on)
        o = drop.keep((uint32_t)(row_base + r0 + i) * (uint32_t)D + c) ? o / drop.scale : 0.f;
      const float res = Xs[(r0 + i) * D + c] + o;
      acc[i][j] = res;
      s1 += res;
      s2 += res * res;
    }
    s1 = vg::warp_sum(s1);
    s2 = vg::warp_sum(s2);
    const float mean = s1 / D;
    const float var = s2 / D - mean * mean;
    const float rs = rsqrtf(var + eps);
    const int row = row_base + r0 + i;
    if (row < N) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        const float yh = (acc[i][j] - mean) * rs;
        if (SAVED) saved.yhat[(size_t)row * D + c] = vg::from_f32<T>(yh);
        out[(size_t)row * D + c] = vg::from_f32<T>(yh * gamma[c] + beta[c]);
      }
      if (SAVED && lane == 0) saved.rsig[row] = rs;
    }
  }
}

// One call's arguments, as the C entry point takes them.
struct Args {
  const void *x, *w1;
  const float* b1;
  const void* w2;
  const float *b2, *gamma, *beta;
  void *out, *h1, *yhat;  // h1 null: the inference kernel
  float* rsig;
  void* h;  // [N, F] scratch of the wgmma body
  int N, D, F;
  float eps;
  vg::Dropout drop;
  cudaStream_t stream;
};

template <typename T, int NJ, bool SAVED>
cudaError_t launch(const Args& a) {
  constexpr int D = NJ * 32;
  const size_t smem =
      ((size_t)kR * D + kKT * (kFC + 1) + kR * kFC + (size_t)kKB * (D + 1)) * sizeof(float);
  static std::atomic<uint32_t> ready{0};
  const cudaError_t err = allow_smem(ffn_kernel<T, NJ, SAVED>, (int)smem, ready);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + kR - 1) / kR);
  const Saved<T> saved{static_cast<T*>(a.h1), static_cast<T*>(a.yhat), a.rsig};
  ffn_kernel<T, NJ, SAVED><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w1), a.b1,
      static_cast<const T*>(a.w2), a.b2, a.gamma, a.beta, static_cast<T*>(a.out), saved, a.N,
      a.F, a.eps, a.drop);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch(const Args& a) {
  return a.h1 != nullptr ? launch<T, NJ, true>(a) : launch<T, NJ, false>(a);
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  switch (a.D) {
    case 64: return launch<T, 2>(a);
    case 128: return launch<T, 4>(a);
    case 256: return launch<T, 8>(a);
    case 512: return launch<T, 16>(a);
    case 768: return launch<T, 24>(a);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16, D = 768, on wgmma (the flagship's body): two kernels a call.
//
// What limited the 16x16x16-mma body this replaced (1.01 ms at this shape,
// 7.8% of the tensor peak): 32 rows a block, so every one of 256 blocks streamed all of W1 and
// W2 (2.4 GB through L2 a call); 16x16x16 mma with every warp reloading its
// fragments; two block barriers for each of 480 stages; the intermediate
// through shared memory three times. A 64-row block cannot keep a whole
// 768-wide fp32 output row in registers (192 KB of the SM's 256 KB) beside
// the h chunk's accumulator, so the products are split at h:
//
//   up:   h = bf16(gelu(x W1^T + b1)) into the [N, F] scratch (and h1 =
//         bf16(x W1^T + b1) when SAVED). A block owns a 128 x 128 tile of h:
//         two warpgroups of m64n128k16, 64 fp32 accumulators a thread, over
//         K = 768 in 64-deep stages (x 16 KB + W1 16 KB) through a ring of
//         three. Bias and gelu (the same erf polynomial) run in registers;
//         rows leave through shared memory as 16-byte stores. Two blocks
//         share an SM, so one block's epilogue (gelu costs ~20 operations an
//         element) overlaps the other's products; 128 x 256 tiles at one
//         block an SM were slower.
//   down: y = LN(x + drop(h W2^T + b2)) (and yhat, rsig when SAVED). A block
//         owns 64 whole rows: three warpgroups of m64n256k16, each 256 of the
//         768 columns, over K = F in 32-deep stages (h 4 KB + W2 48 KB,
//         64-byte swizzle) through a ring of four; 64-deep stages fit only a
//         ring of two and were slower. The epilogue adds b2, drops by the
//         hash of each element's global (row, col) (kept values times
//         1 / (1 - rate), within an ulp of the twin's division, which was
//         most of dropout's cost), adds the residual, and takes the row
//         statistics in registers: sums over the quad of lanes that share a
//         row, then the three warpgroups' partials through shared memory,
//         added in a fixed order. b2, gamma and beta are read from shared
//         memory. Grid N/64 (128 blocks, one wave). The fused attention
//         epilogue runs this same kernel with h = its context rows, W2 = its
//         out-projection and K = 768 (vg::ffn_down_ln, ffn_down_ln.cuh).
//
// Both kernels take their tiles by TMA (rows past N read as zeros, which
// makes any N work): thread 0 issues a stage's loads S - 1 stages ahead and
// re-arms a buffer once every warp has released it on its mbarrier; the
// products of stage s are in flight while the warps wait for stage s + 1.
// Only the wgmma accumulate, no atomics: two runs give the same bits. The
// split costs h's round trip through device memory (50 MB written and read
// at the flagship, ~30 us at 3.35 TB/s); the saved-residual call writes h1 of
// the same size anyway. Pairs of blocks sharing the weight tiles by TMA
// multicast (a cluster of two) were slower in both kernels: the stage rate of
// a block is bounded by the bytes its SM takes in, not by L2's reads.
//
// Resources (ptxas -v, kept in the build's fused_ffn.cu.log; 0 bytes spilled):
// up 125 registers (127 SAVED), 99,376 bytes of dynamic shared memory, 256
// threads, two blocks an SM; down 162 registers, 224,832 bytes, 384 threads,
// one block an SM. Measured at the flagship (H100 80GB HBM3, 700 W): 0.176 ms
// a call, 0.190 with SAVED and dropout, where the WMMA body took 1.01 and 1.04.

namespace hopper {

using bf16 = __nv_bfloat16;
using namespace vg::gmma;
constexpr int kD = vg::kDownLnWidth;

// up: 128 rows x 128 columns of h a block, two warpgroups of m64n128k16 over
// 64-deep stages (128-byte swizzle) through a ring of three; two blocks an SM.
constexpr int kUpBK = 64, kUpRows = 128, kUpCols = 128, kUpThreads = 256, kUpStages = 3;
constexpr int kUpX = kUpRows * kUpBK * 2, kUpStage = kUpX + kUpCols * kUpBK * 2;
constexpr int kUpSmem = 1024 + kUpStages * kUpStage + 2 * kUpStages * 8;
static_assert(kUpThreads / 32 * 2 * stage_bytes<kUpCols>() <= kUpStages * kUpStage,
              "staging fits");

// down: 64 whole rows a block, three warpgroups of m64n256k16 over 32-deep
// stages (64-byte swizzle) through a ring of four.
constexpr int kDownBK = 32, kDownRowBytes = kDownBK * 2, kDownStages = 4;
constexpr int kDownRows = 64, kDownCols = 256, kDownGroups = kD / kDownCols;
constexpr int kDownThreads = 128 * kDownGroups;
constexpr int kDownH = kDownRows * kDownRowBytes, kDownStage = kDownH + kD * kDownRowBytes;
constexpr int kDownSmem = 1024 + kDownStages * kDownStage + 2 * kDownStages * 8 +
                          kDownGroups * kDownRows * 8 + 3 * kD * 4;
static_assert(kDownThreads / 32 * 2 * stage_bytes<kDownCols>() <= kDownStages * kDownStage,
              "staging fits");

// The k-loop both kernels share: KT stages of BK-deep tiles through a ring
// of S buffers. Thread 0 issues stage kt's loads with load(kt, buffer, bar),
// S - 1 stages ahead. Each warpgroup's A operand is at a_off and its B
// operand at b_off in a buffer. A warp releases a buffer once its products on
// it are done (the products of the next stage are then in flight).
template <int BK, int S, int N, typename Load>
__device__ __forceinline__ void mainloop(float (&acc)[N], unsigned char* smem, int stage_bytes,
                                         uint64_t* full, uint64_t* empty, int KT, int a_off,
                                         int b_off, Load load) {
  if (threadIdx.x == 0)
    for (int kt = 0; kt < S && kt < KT; ++kt) load(kt, smem + kt * stage_bytes, &full[kt]);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    unsigned char* st = smem + s * stage_bytes;
    const uint64_t da = descriptor<BK * 2>(st + a_off), db = descriptor<BK * 2>(st + b_off);
    fence_regs(acc);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_ss_wide(acc, da + kk * kStepK, db + kk * kStepK, kt > 0 || kk > 0);
    mma_commit();
    mma_wait<1>();
    fence_regs(acc);
    if (kt > 0) {
      const int sp = (kt - 1) % S;
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[sp]);
      if (threadIdx.x == 0 && kt - 1 + S < KT) {
        mbar_wait(&empty[sp], ((kt - 1) / S) & 1);
        load(kt - 1 + S, smem + sp * stage_bytes, &full[sp]);
      }
      __syncwarp();
    }
  }
  mma_wait<0>();
  fence_regs(acc);
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, int stages,
                                              int warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], warps);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

template <bool SAVED>
__global__ void __launch_bounds__(kUpThreads, 2)
ffn_up_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w1_map,
              const float* __restrict__ b1, bf16* __restrict__ h, bf16* __restrict__ h1, int N,
              int F) {
  extern __shared__ unsigned char smem_up[];
  unsigned char* smem = align1024(smem_up);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kUpStages * kUpStage);
  uint64_t* empty = full + kUpStages;
  const int n0 = blockIdx.x * kUpCols, m0 = blockIdx.y * kUpRows;
  const int warp = threadIdx.x >> 5, wg = warp >> 2, quad = threadIdx.x & 3;
  init_barriers(full, empty, kUpStages, kUpThreads / 32);

  float acc[kUpCols / 2];
  mainloop<kUpBK, kUpStages>(acc, smem, kUpStage, full, empty, kD / kUpBK, wg * 64 * kUpBK * 2,
                             kUpX, [&](int kt, unsigned char* buf, uint64_t* bar) {
                               mbar_expect_tx(bar, kUpStage);
                               tma_load(buf, &x_map, kt * kUpBK, m0, bar);
                               tma_load(buf + kUpX, &w1_map, kt * kUpBK, n0, bar);
                             });
  __syncthreads();  // every warp's products are done: the ring holds output rows now

#pragma unroll
  for (int j = 0; j < kUpCols / 8; ++j) {
    const int col = n0 + 8 * j + 2 * quad;
    const float2 bb = col < F ? *reinterpret_cast<const float2*>(b1 + col) : make_float2(0.f, 0.f);
    acc[4 * j] += bb.x;
    acc[4 * j + 1] += bb.y;
    acc[4 * j + 2] += bb.x;
    acc[4 * j + 3] += bb.y;
  }
  // the warp's 16 rows (warpgroup wg holds rows 64 wg ..): h1, and gelu as h
  unsigned char* stage = smem + 2 * warp * stage_bytes<kUpCols>();
  const int row0 = m0 + 16 * warp;
  stage_rows<kUpCols>(
      stage, acc,
      [](int, int, float lo, float hi) {
        return pack_bf16(gelu_exact(lo), gelu_exact(hi));
      },
      SAVED ? stage + stage_bytes<kUpCols>() : nullptr);
  __syncwarp();
  if (SAVED) copy_rows<kUpCols>(stage + stage_bytes<kUpCols>(), h1, row0, N, F, n0, F);
  copy_rows<kUpCols>(stage, h, row0, N, F, n0, F);
}

template <bool SAVED>
__global__ void __launch_bounds__(kDownThreads, 1)
ffn_down_ln_kernel(const __grid_constant__ CUtensorMap h_map,
                   const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ x,
                   const float* __restrict__ b2, const float* __restrict__ gamma,
                   const float* __restrict__ beta, bf16* __restrict__ out,
                   bf16* __restrict__ yhat, float* __restrict__ rsig, int N, int F, float eps,
                   vg::Dropout drop) {
  drop.load();
  extern __shared__ unsigned char smem_down[];
  unsigned char* smem = align1024(smem_down);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDownStages * kDownStage);
  uint64_t* empty = full + kDownStages;
  float2* part = reinterpret_cast<float2*>(empty + kDownStages);  // [group][row] (sum, sum sq)
  const int m0 = blockIdx.x * kDownRows;
  const int warp = threadIdx.x >> 5, wg = warp >> 2, lane = threadIdx.x & 31, quad = lane & 3;
  // b2, gamma, beta: read from shared memory in the epilogue, whose loads then
  // hold no registers across the accumulator's lifetime (0 bytes spilled)
  float* vecs = reinterpret_cast<float*>(part + kDownGroups * kDownRows);
  for (int i = threadIdx.x; i < kD; i += kDownThreads) {
    vecs[i] = b2[i];
    vecs[kD + i] = gamma[i];
    vecs[2 * kD + i] = beta[i];
  }
  init_barriers(full, empty, kDownStages, kDownThreads / 32);

  float acc[128];
  mainloop<kDownBK, kDownStages>(
      acc, smem, kDownStage, full, empty, F / kDownBK, 0, kDownH + wg * kDownCols * kDownRowBytes,
      [&](int kt, unsigned char* buf, uint64_t* bar) {
        mbar_expect_tx(bar, kDownStage);
        tma_load(buf, &h_map, kt * kDownBK, m0, bar);
#pragma unroll
        for (int g = 0; g < kDownGroups; ++g)
          tma_load(buf + kDownH + g * kDownCols * kDownRowBytes, &w2_map, kt * kDownBK,
                   g * kDownCols, bar);
      });

  // + b2, dropout, + residual; the row sums. This thread: rows r + 8 hh,
  // columns c0 + 8 j + 2 quad (+1).
  const int r = 16 * (warp & 3) + (lane >> 2), c0 = wg * kDownCols + 2 * quad;
  const float keep_factor = 1.f / drop.scale;  // drop.scale is 1 - rate
  const float *pb2 = vecs, *pg = vecs + kD, *pbt = vecs + 2 * kD;
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j % 8 == 0) asm volatile("" ::: "memory");  // loads of eight column groups at a time
    const int col = c0 + 8 * j;
    const float2 bb = *reinterpret_cast<const float2*>(pb2 + col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + r + 8 * hh;
      float2 xv = make_float2(0.f, 0.f);
      if (row < N)
        xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * kD + col));
      float o0 = acc[4 * j + 2 * hh] + bb.x, o1 = acc[4 * j + 2 * hh + 1] + bb.y;
      if (drop.on) {
        const uint32_t idx = (uint32_t)row * (uint32_t)kD + (uint32_t)col;
        o0 = drop.keep(idx) ? o0 * keep_factor : 0.f;
        o1 = drop.keep(idx + 1) ? o1 * keep_factor : 0.f;
      }
      o0 += xv.x;
      o1 += xv.y;
      acc[4 * j + 2 * hh] = o0;
      acc[4 * j + 2 * hh + 1] = o1;
      s1[hh] += o0 + o1;
      s2[hh] += o0 * o0 + o1 * o1;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    s1[hh] = quad_sum(s1[hh]);
    s2[hh] = quad_sum(s2[hh]);
    if (quad == 0) part[wg * kDownRows + r + 8 * hh] = make_float2(s1[hh], s2[hh]);
  }
  __syncthreads();  // the partials are in; every warp's products are done with the ring

  float mean[2], rs[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int g = 0; g < kDownGroups; ++g) {
      const float2 p = part[g * kDownRows + r + 8 * hh];
      t1 += p.x;
      t2 += p.y;
    }
    mean[hh] = t1 / kD;
    rs[hh] = rsqrtf(t2 / kD - mean[hh] * mean[hh] + eps);
    if (SAVED && wg == 0 && quad == 0 && m0 + r + 8 * hh < N) rsig[m0 + r + 8 * hh] = rs[hh];
  }
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = (acc[i] - mean[(i >> 1) & 1]) * rs[(i >> 1) & 1];

  // yhat, and y = yhat * gamma + beta formed pair by pair as it is staged
  unsigned char* stage = smem + 2 * warp * stage_bytes<kDownCols>();
  const int row0 = m0 + 16 * (warp & 3), col0 = wg * kDownCols;
  const auto affine = [&](int j, int, float lo, float hi) {
    const float2 g = *reinterpret_cast<const float2*>(pg + c0 + 8 * j);
    const float2 bt = *reinterpret_cast<const float2*>(pbt + c0 + 8 * j);
    return pack_bf16(lo * g.x + bt.x, hi * g.y + bt.y);
  };
  stage_rows<kDownCols>(stage, acc, affine, SAVED ? stage + stage_bytes<kDownCols>() : nullptr);
  __syncwarp();
  if (SAVED) copy_rows<kDownCols>(stage + stage_bytes<kDownCols>(), yhat, row0, N, kD, col0, kD);
  copy_rows<kDownCols>(stage, out, row0, N, kD, col0, kD);
}

// The down-projection alone: also the fused attention epilogue's bf16 body
// at D = 768 (vg::ffn_down_ln, below).
template <bool SAVED>
cudaError_t launch_down(const vg::DownLn& a) {
  CUtensorMap h_map, w2_map;
  cudaError_t err;
  if ((err = tensor_map(&h_map, a.h, a.F, a.N, kDownRows, kDownBK)) != cudaSuccess ||
      (err = tensor_map(&w2_map, a.w2, a.F, kD, kDownCols, kDownBK)) != cudaSuccess)
    return err;
  static std::atomic<uint32_t> ready{0};
  if ((err = allow_smem(ffn_down_ln_kernel<SAVED>, kDownSmem, ready)) != cudaSuccess) return err;
  ffn_down_ln_kernel<SAVED><<<(a.N + kDownRows - 1) / kDownRows, kDownThreads, kDownSmem,
                              a.stream>>>(
      h_map, w2_map, static_cast<const bf16*>(a.x), a.b2, a.gamma, a.beta,
      static_cast<bf16*>(a.out), static_cast<bf16*>(a.yhat), a.rsig, a.N, a.F, a.eps, a.drop);
  return cudaGetLastError();
}

template <bool SAVED>
cudaError_t launch(const Args& a) {
  if (a.h == nullptr) return cudaErrorInvalidValue;
  CUtensorMap x_map, w1_map;
  cudaError_t err;
  if ((err = tensor_map(&x_map, a.x, kD, a.N, kUpRows)) != cudaSuccess ||
      (err = tensor_map(&w1_map, a.w1, kD, a.F, kUpCols)) != cudaSuccess)
    return err;
  static std::atomic<uint32_t> ready{0};
  if ((err = allow_smem(ffn_up_kernel<SAVED>, kUpSmem, ready)) != cudaSuccess) return err;
  const dim3 up_grid((a.F + kUpCols - 1) / kUpCols, (a.N + kUpRows - 1) / kUpRows);
  ffn_up_kernel<SAVED><<<up_grid, kUpThreads, kUpSmem, a.stream>>>(
      x_map, w1_map, a.b1, static_cast<bf16*>(a.h), static_cast<bf16*>(a.h1), a.N, a.F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_down<SAVED>(vg::DownLn{a.h, a.w2, a.x, a.b2, a.gamma, a.beta, a.out, a.yhat,
                                       a.rsig, a.N, a.F, a.eps, a.drop, a.stream});
}

}  // namespace hopper

cudaError_t dispatch_bf16(const Args& a) {
  if (a.D != hopper::kD) return dispatch<__nv_bfloat16>(a);
  return a.h1 != nullptr ? hopper::launch<true>(a) : hopper::launch<false>(a);
}

}  // namespace

cudaError_t vg::ffn_down_ln(const DownLn& a) {
  if (a.N < 1 || a.F < 32 || a.F % 32 != 0 || (a.yhat == nullptr) != (a.rsig == nullptr))
    return cudaErrorInvalidValue;
  return a.yhat != nullptr ? hopper::launch_down<true>(a) : hopper::launch_down<false>(a);
}

// x, out: [N, D]; w1: [F, D]; w2: [D, F] (dtype 0 = fp32, 1 = bf16);
// b1 [F], b2, gamma, beta [D]: fp32. D in {64, 128, 256, 512, 768},
// F a multiple of 128. With h1 non-null this is the saved-residual kernel and
// also writes h1 [N, F] and yhat [N, D] in the storage dtype and rsig [N]
// fp32. Dropout of the second product's output when dropout != 0: element
// (row, col) is kept where splitmix32(row * D + col, seed) >= threshold, and
// kept values are divided by keep_div = 1 - rate (the wgmma body multiplies
// by its reciprocal), after + b2 and before the residual; seed: a device
// pointer to the int32 seed (unused when dropout == 0). h: an [N, F] bf16
// scratch that bf16 at D = 768 needs (it then holds bf16(gelu(h1))); null
// otherwise.
extern "C" int vg_fused_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* gamma, const void* beta, void* out,
                            void* h1, void* yhat, void* rsig, void* h, int N, int D, int F,
                            float eps, int dtype, int dropout, const void* seed,
                            unsigned threshold, float keep_div, void* stream) {
  if (F % kFC != 0 || N < 1) return cudaErrorInvalidValue;
  if (h1 != nullptr && (yhat == nullptr || rsig == nullptr)) return cudaErrorInvalidValue;
  const Args a{x, w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
               static_cast<const float*>(gamma), static_cast<const float*>(beta), out, h1, yhat,
               static_cast<float*>(rsig), h, N, D, F, eps,
               vg::Dropout{dropout, static_cast<const uint32_t*>(seed), threshold, keep_div, 0u},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch_bf16(a);
  return cudaErrorInvalidValue;
}
