// Fused attention epilogue: out = LN(res + dropout(ctx W^T + b)) over rows of
// ctx, res [N, D], with W [D, D] in nn.Linear layout (row n holds the weights
// of output column n).
//
// Replaces: vibertgrid_tpu/ops/fused_ffn.py::_proj_ln_kernel (fused_proj_ln,
// the encoder's attn_epilogue="fused"). The TPU kernel kept W and a 1024-row
// tile of ctx, res and out in 13 MB of VMEM (_proj_row_tile, fused_ffn.py:620).
// A Hopper block has 227 KB of shared memory and the LayerNorm needs a whole
// D-wide row, so here a block owns R = 32 full rows, keeps their fp32 [32, D]
// accumulator in registers (96 floats a thread at D = 768, which is what caps
// R) and streams W through shared memory along K. The projection never
// reaches device memory: bias, dropout, residual and the row's mean and mean
// of squares (variance E[r^2] - E[r]^2, as models/norm.py's LayerNorm) are
// applied to the accumulator and the row is written once.
//
// Bound on this card: bytes. At the flagship (N = 8192, D = 768, bf16) ctx and
// res are read and out written once (37.7 MB) and W once (1.2 MB): 11.6 us at
// 3.35 TB/s, against 2 N D^2 = 9.7 GFLOP, 9.8 us at the 989 TFLOP/s bf16
// tensor peak. W is re-read by every block, from L2.
//
// Two bodies share that plan, as in fused_ffn.cu: bf16 with D a multiple of
// 128 runs the product on the tensor cores as 16x16x16 mma (WMMA) with the W
// tiles double-buffered by cp.async (namespace tc); every other case (fp32,
// narrow widths) runs fp32 FMAs on the CUDA cores. Neither uses wgmma or TMA.
//
// Dropout is the stateless hash of ops/dropout.py on the [N, D] projection:
// element (row, col) is kept where splitmix32(row * D + col, seed) reaches
// the threshold, with the global row, so the fused and the unfused epilogue
// drop the same elements for one seed.

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kR = 32;         // rows per block, 4 per warp in the epilogue

// Bias, dropout, residual and LayerNorm of one row by one warp. `vals[j]`
// holds the projection at column lane + 32 j on entry; `res_at(c)` returns the
// residual at column c. Every lane of the warp must call it (warp sums); the
// row is stored only where `store` is set.
template <typename T, int NJ, typename ResAt>
__device__ __forceinline__ void finish_row(float (&vals)[NJ], ResAt res_at, int row, int lane,
                                           bool store, const float* __restrict__ b,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta, T* __restrict__ out,
                                           float eps, const vg::Dropout& drop) {
  constexpr int D = NJ * 32;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    float o = vals[j] + b[c];
    if (drop.on) o = drop.keep((uint32_t)row * (uint32_t)D + c) ? o / drop.scale : 0.f;
    const float r = res_at(c) + o;
    vals[j] = r;
    s1 += r;
    s2 += r * r;
  }
  s1 = vg::warp_sum(s1);
  s2 = vg::warp_sum(s2);
  const float mean = s1 / D;
  const float rs = rsqrtf(s2 / D - mean * mean + eps);
  if (store) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      out[(size_t)row * D + c] = vg::from_f32<T>((vals[j] - mean) * rs * gamma[c] + beta[c]);
    }
  }
}

// fp32 FMA body: thread (warp, lane) owns rows 4 warp .. 4 warp + 3 and columns
// lane + 32 j of the accumulator. ctx rows (as fp32, 96 KB at D = 768) and a
// 16-deep W tile [16][D + 1] (49 KB) sit in shared memory.
constexpr int kKB = 16;  // K-depth of a W tile

// NJ = D / 32: accumulator columns per thread.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
proj_ln_kernel(const T* __restrict__ ctx, const T* __restrict__ res, const T* __restrict__ w,
               const float* __restrict__ b, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ out, int N, float eps,
               vg::Dropout drop) {
  constexpr int D = NJ * 32;
  extern __shared__ float smem[];
  float* Cs = smem;           // [kR][D]
  float* Ws = Cs + kR * D;    // [kKB][D + 1]

  const int row_base = blockIdx.x * kR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 4;

  for (int i = threadIdx.x; i < kR * D; i += kThreads) {
    const int row = row_base + i / D;
    Cs[i] = row < N ? vg::to_f32(ctx[(size_t)row * D + i % D]) : 0.f;
  }

  float acc[4][NJ] = {};
  for (int k0 = 0; k0 < D; k0 += kKB) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKB * D; i += kThreads) {
      const int n = i / kKB, kk = i % kKB;
      Ws[kk * (D + 1) + n] = vg::to_f32(w[(size_t)n * D + k0 + kk]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKB; ++kk) {
      float cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = Cs[(r0 + i) * D + k0 + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float wv = Ws[kk * (D + 1) + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(cv[i], wv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row_base + r0 + i;
    const bool live = row < N;
    const T* res_row = res + (size_t)(live ? row : 0) * D;
    finish_row<T, NJ>(
        acc[i], [&](int c) { return live ? vg::to_f32(res_row[c]) : 0.f; }, row, lane, live, b,
        gamma, beta, out, eps, drop);
  }
}

// One call's arguments, as the C entry point takes them.
struct Args {
  const void *ctx, *res, *w;
  const float *b, *gamma, *beta;
  void* out;
  int N, D;
  float eps;
  vg::Dropout drop;
  cudaStream_t stream;
};

template <typename T, int NJ>
cudaError_t launch(const Args& a) {
  constexpr int D = NJ * 32;
  const size_t smem = ((size_t)kR * D + (size_t)kKB * (D + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      proj_ln_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  proj_ln_kernel<T, NJ><<<(a.N + kR - 1) / kR, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.ctx), static_cast<const T*>(a.res), static_cast<const T*>(a.w),
      a.b, a.gamma, a.beta, static_cast<T*>(a.out), a.N, a.eps, a.drop);
  return cudaGetLastError();
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
// bf16 on the tensor cores. The block's ctx and res rows sit in shared memory
// (2 x 49 KB at D = 768); W[:, k:k+32] tiles stream through a double buffer
// with cp.async (2 x 60 KB), stage s + 1 in flight while stage s computes.
// Warp w owns accumulator columns 16 NB w .. (NB = D / 128 fragments for each
// of the 2 row blocks: 12 fragments, 96 floats a thread at D = 768). After the
// walk the accumulators go to shared memory as fp32 rows (97 KB, over ctx and
// the tiles) and warp w finishes rows 4 w .. 4 w + 3.

namespace tc {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
constexpr int kKB = 32;  // K-depth of a W tile

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

template <int D>
struct Smem {
  static constexpr int kLdA = D + 8, kLdW = kKB + 8, kLdO = D + 4;
  static constexpr int kA = align128(kR * kLdA * 2);  // ctx; res the same
  static constexpr int kW = align128(D * kLdW * 2);   // one buffer
  static_assert(kR * kLdO * 4 <= kA + 2 * kW, "fp32 rows must fit over ctx and the tiles");
  static constexpr int kBytes = 2 * kA + 2 * kW;
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
  static constexpr int kStages = D / kKB;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
proj_ln_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ res,
               const bf16* __restrict__ w, const float* __restrict__ b,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               bf16* __restrict__ out, int N, float eps, vg::Dropout drop) {
  using L = Smem<D>;
  constexpr int NB = D / 128;  // accumulator column fragments per warp
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_tc);                         // [kR][kLdA]
  bf16* Ws = reinterpret_cast<bf16*>(smem_tc + L::kA);                 // [2][D][kLdW]
  bf16* Rs = reinterpret_cast<bf16*>(smem_tc + L::kA + 2 * L::kW);     // [kR][kLdA]
  float* Os = reinterpret_cast<float*>(smem_tc);                       // after the walk

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row_base = blockIdx.x * kR;
  for (int i = tid; i < kR * D / 8; i += kThreads) {
    const int r = i / (D / 8), c8 = i % (D / 8), row = row_base + r;
    uint4 cv = make_uint4(0, 0, 0, 0), rv = cv;
    if (row < N) {
      cv = reinterpret_cast<const uint4*>(ctx + (size_t)row * D)[c8];
      rv = reinterpret_cast<const uint4*>(res + (size_t)row * D)[c8];
    }
    *reinterpret_cast<uint4*>(Cs + r * L::kLdA + c8 * 8) = cv;
    *reinterpret_cast<uint4*>(Rs + r * L::kLdA + c8 * 8) = rv;
  }

  auto prefetch = [&](int s) {
    bf16* dst = Ws + (s & 1) * (L::kW / 2);
    for (int e = tid; e < D * kKB / 8; e += kThreads) {
      const int n = e / (kKB / 8), c8 = e % (kKB / 8);
      vg::cp_async16(dst + n * L::kLdW + c8 * 8, w + (size_t)n * D + s * kKB + c8 * 8);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NB];
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int j = 0; j < NB; ++j) wmma::fill_fragment(acc[rb][j], 0.f);

  prefetch(0);
  vg::cp_async_commit();
  for (int s = 0; s < L::kStages; ++s) {
    if (s + 1 < L::kStages) prefetch(s + 1);
    vg::cp_async_commit();
    vg::cp_async_wait<1>();
    __syncthreads();  // tile s has landed (and, at s = 0, the ctx rows)
    const bf16* tile = Ws + (s & 1) * (L::kW / 2);
#pragma unroll
    for (int kk = 0; kk < kKB; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int rb = 0; rb < 2; ++rb)
        wmma::load_matrix_sync(a[rb], Cs + rb * 16 * L::kLdA + s * kKB + kk, L::kLdA);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, tile + (warp * NB + n) * 16 * L::kLdW + kk, L::kLdW);
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) wmma::mma_sync(acc[rb][n], a[rb], bw, acc[rb][n]);
      }
    }
    __syncthreads();  // every warp is done with tile s before it is refilled
  }

#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      wmma::store_matrix_sync(Os + rb * 16 * L::kLdO + (warp * NB + j) * 16, acc[rb][j],
                              L::kLdO, wmma::mem_row_major);
  __syncthreads();
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i, row = row_base + r;
    float vals[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) vals[j] = Os[r * L::kLdO + lane + 32 * j];
    finish_row<bf16, D / 32>(
        vals, [&](int c) { return __bfloat162float(Rs[r * L::kLdA + c]); }, row, lane, row < N,
        b, gamma, beta, out, eps, drop);
  }
}

template <int D>
cudaError_t launch(const Args& a) {
  constexpr int smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      proj_ln_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  proj_ln_kernel<D><<<(a.N + kR - 1) / kR, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.ctx), static_cast<const bf16*>(a.res),
      static_cast<const bf16*>(a.w), a.b, a.gamma, a.beta, static_cast<bf16*>(a.out), a.N,
      a.eps, a.drop);
  return cudaGetLastError();
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

// ctx, res, out: [N, D]; w: [D, D] (dtype 0 = fp32, 1 = bf16); b, gamma,
// beta [D]: fp32. D in {64, 128, 256, 512, 768}, any N >= 1. Dropout of the
// projection when dropout != 0: element (row, col) is kept where
// splitmix32(row * D + col, seed) >= threshold, and kept values are divided
// by keep_div = 1 - rate, after + b and before the residual.
extern "C" int vg_fused_proj_ln(const void* ctx, const void* res, const void* w, const void* b,
                                const void* gamma, const void* beta, void* out, int N, int D,
                                float eps, int dtype, int dropout, int seed, unsigned threshold,
                                float keep_div, void* stream) {
  if (N < 1) return cudaErrorInvalidValue;
  const Args a{ctx, res, w, static_cast<const float*>(b), static_cast<const float*>(gamma),
               static_cast<const float*>(beta), out, N, D, eps,
               vg::Dropout{dropout, (uint32_t)seed, threshold, keep_div},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch_bf16(a);
  return cudaErrorInvalidValue;
}
