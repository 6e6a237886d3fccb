// Fused attention epilogue: out = LN(res + dropout(ctx W^T + b)) over rows of
// ctx, res [N, D], with W [D, D] in nn.Linear layout (row n holds the weights
// of output column n).
//
// Replaces: vibertgrid_tpu/ops/fused_ffn.py::_proj_ln_kernel (fused_proj_ln,
// the encoder's attn_epilogue="fused"). The TPU kernel kept W and a 1024-row
// tile of ctx, res and out in 13 MB of VMEM (_proj_row_tile, fused_ffn.py:620).
// A Hopper block has 227 KB of shared memory and the LayerNorm needs a whole
// D-wide row, so a block owns whole rows and streams W along K. The
// projection never reaches device memory: bias, dropout, residual and the
// row's mean and mean of squares (variance E[r^2] - E[r]^2, as
// models/norm.py's LayerNorm) are applied to the accumulator and the row is
// written once.
//
// Bound on this card: bytes. At the flagship (N = 8192, D = 768, bf16) ctx and
// res are read and out written once (37.7 MB) and W once (1.2 MB): 11.6 us at
// 3.35 TB/s, against 2 N D^2 = 9.7 GFLOP, 9.8 us at the 989 TFLOP/s bf16
// tensor peak.
//
// Two bodies. bf16 at D = 768 (every full-width configuration) is the fused
// FFN's down-projection with K = 768: the same function as LN(x + drop(h
// W2^T + b2)) with h = ctx, W2 = W and x = res, so it runs that kernel
// (vg::ffn_down_ln, fused_ffn.cu, one launch a call): 64 whole rows a block,
// three warpgroups of wgmma m64n256k16, ctx and W tiles by TMA through a ring
// of four 32-deep stages (24 stages at K = 768), the LayerNorm in registers.
// It multiplies kept values by 1 / (1 - rate) where the FMA body and the twin
// divide by 1 - rate: within an ulp of fp32 before the LayerNorm, and the
// dropped set is the same. Every other case (fp32; bf16 at D = 64, the tiny
// configuration's width, or 128-512, which no configuration runs) takes fp32
// FMAs on the CUDA cores, below, with bf16 storage where the inputs are bf16.
//
// Dropout is the stateless hash of ops/dropout.py on the [N, D] projection:
// element (row, col) is kept where splitmix32(row * D + col, seed) reaches
// the threshold, with the global row, so the fused and the unfused epilogue
// drop the same elements for one seed.

#include "common.cuh"
#include "ffn_down_ln.cuh"

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
  drop.load();
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

cudaError_t dispatch_bf16(const Args& a) {
  if (a.D != vg::kDownLnWidth) return dispatch<__nv_bfloat16>(a);
  return vg::ffn_down_ln(vg::DownLn{a.ctx, a.w, a.res, a.b, a.gamma, a.beta, a.out, nullptr,
                                    nullptr, a.N, a.D, a.eps, a.drop, a.stream});
}

}  // namespace

// ctx, res, out: [N, D]; w: [D, D] (dtype 0 = fp32, 1 = bf16); b, gamma,
// beta [D]: fp32. D in {64, 128, 256, 512, 768}, any N >= 1. Dropout of the
// projection when dropout != 0: element (row, col) is kept where
// splitmix32(row * D + col, seed) >= threshold, and kept values are divided
// by keep_div = 1 - rate (the wgmma body multiplies by its reciprocal), after
// + b and before the residual; seed: a device pointer to the int32 seed
// (unused when dropout == 0). bf16 at D = 768 needs ctx and W 16-byte
// aligned (TMA); a failed tensor-map encode returns cudaErrorInvalidValue.
extern "C" int vg_fused_proj_ln(const void* ctx, const void* res, const void* w, const void* b,
                                const void* gamma, const void* beta, void* out, int N, int D,
                                float eps, int dtype, int dropout, const void* seed,
                                unsigned threshold, float keep_div, void* stream) {
  if (N < 1) return cudaErrorInvalidValue;
  const Args a{ctx, res, w, static_cast<const float*>(b), static_cast<const float*>(gamma),
               static_cast<const float*>(beta), out, N, D, eps,
               vg::Dropout{dropout, static_cast<const uint32_t*>(seed), threshold, keep_div, 0u},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch_bf16(a);
  return cudaErrorInvalidValue;
}
