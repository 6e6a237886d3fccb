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
// Design: one block owns R = 32 full rows and walks the F axis in chunks of
// FC = 128:
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
//
// Two bodies share that plan. bf16 with D a multiple of 128 (the flagship)
// runs the products on the tensor cores as 16x16x16 mma (WMMA) with the
// weight tiles double-buffered by cp.async (namespace tc below). Every
// other case (the fp32 forward, narrow widths) runs fp32 FMAs on the CUDA
// cores: the next section. Neither uses wgmma or TMA yet, which is why the
// kernel runs at a small share of the tensor peak.

#include <mma.h>

#include "common.cuh"

namespace {

// fp32 FMA body: the 32 x D accumulator is 4 rows x D/32 columns a thread;
// x rows (fp32, 96 KB at D = 768), a 16 x 128 W1 tile, h [32, 128] and a
// 16 x D W2 tile sit in shared memory (168 KB at D = 768).
constexpr int kThreads = 256;  // 8 warps
constexpr int kR = 32;         // rows per block, 4 per warp
constexpr int kFC = 128;       // F-chunk width
constexpr int kKT = 16;        // D-depth of a W1 tile
constexpr int kKB = 16;        // F-depth of a W2 tile

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
  return a / b;
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erf_poly(x * 0.70710678118654752f));
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
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T, NJ, SAVED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
// bf16 on the tensor cores. Same blocking (32 rows a block, F in chunks of
// 128), with both products as 16x16x16 bf16 mma (WMMA), fp32 accumulate:
//   A) h[32, 128]: warp w owns columns 16w..16w+15 of the chunk (2 fragments);
//      W1[c:c+128, k:k+64] is staged in shared memory 64 deep at a time.
//   B) acc[32, D]: warp w owns columns 16*NB*w .. (NB = D/128 fragments a
//      row block, 2 row blocks: 12 fragments, 96 floats a thread at D=768);
//      W2[:, c+f:c+f+16] is staged 16 deep at a time.
// The weight tiles stream through double buffers with cp.async: the whole
// walk is one sequence of stages (D/64 W1 tiles then 8 W2 tiles per chunk)
// and stage s+1 is in flight while stage s computes.
// Shared memory at D = 768: x 49 KB, two W1 tiles 36 KB, h 17 + 9 KB, two W2
// tiles 72 KB (182 KB), one block per SM. After the loop the accumulators go
// to shared memory as fp32 rows (97 KB, over the tiles) for the LayerNorm.

namespace tc {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
constexpr int kKT = 64;  // D-depth of a W1 tile
constexpr int kKB = 16;  // F-depth of a W2 tile

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

template <int D>
struct Smem {
  static constexpr int kLdX = D + 8, kLdW1 = kKT + 8, kLdHf = kFC + 4, kLdHb = kFC + 8,
                       kLdW2 = kKB + 8, kLdO = D + 4;
  static constexpr int kX = align128(kR * kLdX * 2);
  static constexpr int kW1 = align128(kFC * kLdW1 * 2);  // one buffer
  static constexpr int kHf = align128(kR * kLdHf * 4);
  static constexpr int kHb = align128(kR * kLdHb * 2);
  static constexpr int kW2 = align128(D * kLdW2 * 2);    // one buffer
  static constexpr int kWork = 2 * kW1 + kHf + kHb + 2 * kW2;
  static_assert(kR * kLdO * 4 <= kWork, "fp32 rows must fit over the tiles");
  static constexpr int kBytes = kX + kWork;
  static constexpr int kStagesA = D / kKT, kStages = kStagesA + kFC / kKB;
};

template <int D, bool SAVED>
__global__ void __launch_bounds__(kThreads, 1)
ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ gamma,
           const float* __restrict__ beta, bf16* __restrict__ out, Saved<bf16> saved, int N,
           int F, float eps, vg::Dropout drop) {
  using L = Smem<D>;
  constexpr int NB = D / 128;  // accumulator column fragments per warp
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_tc);
  unsigned char* work = smem_tc + L::kX;
  bf16* W1s = reinterpret_cast<bf16*>(work);  // [2][kFC][kLdW1]
  float* Hf = reinterpret_cast<float*>(work + 2 * L::kW1);
  bf16* Hb = reinterpret_cast<bf16*>(work + 2 * L::kW1 + L::kHf);
  bf16* W2s = reinterpret_cast<bf16*>(work + 2 * L::kW1 + L::kHf + L::kHb);  // [2][D][kLdW2]
  float* Os = reinterpret_cast<float*>(work);  // after the main loop

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row_base = blockIdx.x * kR;
  for (int i = tid; i < kR * D / 8; i += kThreads) {
    const int r = i / (D / 8), c8 = i % (D / 8), row = row_base + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < N) v = reinterpret_cast<const uint4*>(x + (size_t)row * D)[c8];
    *reinterpret_cast<uint4*>(Xs + r * L::kLdX + c8 * 8) = v;
  }

  // Stage s: chunk s / kStages; its first kStagesA stages are W1 tiles,
  // the rest W2 tiles; consecutive tiles of a kind alternate buffers.
  auto prefetch = [&](int s) {
    const int c0 = s / L::kStages * kFC, i = s % L::kStages;
    if (i < L::kStagesA) {
      bf16* dst = W1s + (i & 1) * (L::kW1 / 2);
      for (int e = tid; e < kFC * kKT / 8; e += kThreads) {
        const int n = e / (kKT / 8), c8 = e % (kKT / 8);
        vg::cp_async16(dst + n * L::kLdW1 + c8 * 8, w1 + (size_t)(c0 + n) * D + i * kKT + c8 * 8);
      }
    } else {
      const int j = i - L::kStagesA;
      bf16* dst = W2s + (j & 1) * (L::kW2 / 2);
      for (int e = tid; e < D * kKB / 8; e += kThreads) {
        const int n = e / (kKB / 8), c8 = e % (kKB / 8);
        vg::cp_async16(dst + n * L::kLdW2 + c8 * 8, w2 + (size_t)n * F + c0 + j * kKB + c8 * 8);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NB];
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int j = 0; j < NB; ++j) wmma::fill_fragment(acc[rb][j], 0.f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> h[2];

  const int total = F / kFC * L::kStages;
  prefetch(0);
  vg::cp_async_commit();
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) prefetch(s + 1);
    vg::cp_async_commit();
    vg::cp_async_wait<1>();
    __syncthreads();
    const int c0 = s / L::kStages * kFC, i = s % L::kStages;
    if (i < L::kStagesA) {
      // A) h += x[:, i*64 : i*64+64] . W1 tile^T
      if (i == 0) {
        wmma::fill_fragment(h[0], 0.f);
        wmma::fill_fragment(h[1], 0.f);
      }
      const bf16* tile = W1s + (i & 1) * (L::kW1 / 2);
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, tile + warp * 16 * L::kLdW1 + kk, L::kLdW1);
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, Xs + rb * 16 * L::kLdX + i * kKT + kk, L::kLdX);
          wmma::mma_sync(h[rb], a, bw, h[rb]);
        }
      }
      if (i == L::kStagesA - 1) {  // h complete: gelu, round to bf16
#pragma unroll
        for (int rb = 0; rb < 2; ++rb)
          wmma::store_matrix_sync(Hf + rb * 16 * L::kLdHf + warp * 16, h[rb], L::kLdHf,
                                  wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < kR * 16; e += 32) {
          const int r = e / 16, col = warp * 16 + e % 16;
          const float pre = Hf[r * L::kLdHf + col] + b1[c0 + col];
          if (SAVED && row_base + r < N)
            saved.h1[(size_t)(row_base + r) * F + c0 + col] = __float2bfloat16_rn(pre);
          Hb[r * L::kLdHb + col] = __float2bfloat16_rn(gelu_exact(pre));
        }
      }
    } else {
      // B) acc += h[:, j*16 : j*16+16] . W2 tile^T
      const int j = i - L::kStagesA;
      const bf16* tile = W2s + (j & 1) * (L::kW2 / 2);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int rb = 0; rb < 2; ++rb)
        wmma::load_matrix_sync(a[rb], Hb + rb * 16 * L::kLdHb + j * kKB, L::kLdHb);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, tile + (warp * NB + n) * 16 * L::kLdW2, L::kLdW2);
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) wmma::mma_sync(acc[rb][n], a[rb], bw, acc[rb][n]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      wmma::store_matrix_sync(Os + rb * 16 * L::kLdO + (warp * NB + j) * 16, acc[rb][j],
                              L::kLdO, wmma::mem_row_major);
  __syncthreads();
  // + b2, + residual, LayerNorm: warp w normalises rows 4w..4w+3.
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i, row = row_base + r;
    float vals[D / 32];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      const int c = lane + 32 * j;
      float o = Os[r * L::kLdO + c] + b2[c];
      if (drop.on) o = drop.keep((uint32_t)row * (uint32_t)D + c) ? o / drop.scale : 0.f;
      const float res = __bfloat162float(Xs[r * L::kLdX + c]) + o;
      vals[j] = res;
      s1 += res;
      s2 += res * res;
    }
    s1 = vg::warp_sum(s1);
    s2 = vg::warp_sum(s2);
    const float mean = s1 / D;
    const float rs = rsqrtf(s2 / D - mean * mean + eps);
    if (row < N) {
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        const int c = lane + 32 * j;
        const float yh = (vals[j] - mean) * rs;
        if (SAVED) saved.yhat[(size_t)row * D + c] = __float2bfloat16_rn(yh);
        out[(size_t)row * D + c] = __float2bfloat16_rn(yh * gamma[c] + beta[c]);
      }
      if (SAVED && lane == 0) saved.rsig[row] = rs;
    }
  }
}

template <int D, bool SAVED>
cudaError_t launch(const Args& a) {
  constexpr int smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<D, SAVED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const Saved<bf16> saved{static_cast<bf16*>(a.h1), static_cast<bf16*>(a.yhat), a.rsig};
  ffn_kernel<D, SAVED><<<(a.N + kR - 1) / kR, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w1), a.b1,
      static_cast<const bf16*>(a.w2), a.b2, a.gamma, a.beta, static_cast<bf16*>(a.out), saved,
      a.N, a.F, a.eps, a.drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a) {
  return a.h1 != nullptr ? launch<D, true>(a) : launch<D, false>(a);
}

}  // namespace tc

cudaError_t dispatch_bf16(const Args& a) {
  switch (a.D) {
    case 128: return tc::launch<128>(a);
    case 256: return tc::launch<256>(a);
    case 512: return tc::launch<512>(a);
    case 768: return tc::launch<768>(a);
    default: return dispatch<__nv_bfloat16>(a);
  }
}

}  // namespace

// x, out: [N, D]; w1: [F, D]; w2: [D, F] (dtype 0 = fp32, 1 = bf16);
// b1 [F], b2, gamma, beta [D]: fp32. D in {64, 128, 256, 512, 768},
// F a multiple of 128. With h1 non-null this is the saved-residual kernel and
// also writes h1 [N, F] and yhat [N, D] in the storage dtype and rsig [N]
// fp32. Dropout of the second product's output when dropout != 0: element
// (row, col) is kept where splitmix32(row * D + col, seed) >= threshold, and
// kept values are divided by keep_div = 1 - rate, after + b2 and before the
// residual.
extern "C" int vg_fused_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* gamma, const void* beta, void* out,
                            void* h1, void* yhat, void* rsig, int N, int D, int F, float eps,
                            int dtype, int dropout, int seed, unsigned threshold,
                            float keep_div, void* stream) {
  if (F % kFC != 0 || N < 1) return cudaErrorInvalidValue;
  if (h1 != nullptr && (yhat == nullptr || rsig == nullptr)) return cudaErrorInvalidValue;
  const Args a{x, w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
               static_cast<const float*>(gamma), static_cast<const float*>(beta), out, h1, yhat,
               static_cast<float*>(rsig), N, D, F, eps,
               vg::Dropout{dropout, (uint32_t)seed, threshold, keep_div},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch_bf16(a);
  return cudaErrorInvalidValue;
}
