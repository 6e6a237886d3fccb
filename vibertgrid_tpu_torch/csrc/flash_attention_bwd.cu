// Backward of the fused self-attention on packed heads: dq, dk, dv and the
// key-bias cotangent from q, k, v, bias and d_out, all [B, T, H*D].
//
// Replaces: vibertgrid_tpu/ops/flash_attention.py::_bwd_kernel. The TPU
// kernel rematerialised a head's whole [T, T] fp32 probability tile in VMEM
// and took all five products from it in one program. A Hopper block has
// 227 KB, and dk/dv sum over query tiles while dq sums over key tiles, so
// the work is split into two deterministic passes (no atomics):
//
//   pass 1, one block per (32-query tile, head, batch): the tile's scores
//     against all keys and dp = d_out v^T live in shared memory as two
//     [32, T] fp32 arrays (K, then V, streamed in 64-row tiles). Each row
//     is normalised exactly as the forward does, the dropout keep mask is
//     regenerated from the same hash, delta = rowsum(dp * p) with the
//     un-dropped p, ds = p * (dp - delta), and dq = (ds k) * scale (K
//     streamed again). The row's max, sum and delta go to a [B, H, T, 3]
//     fp32 scratch tensor for pass 2.
//   pass 2, one block per (64-key tile, head, batch): query tiles stream
//     past the block's K and V tile; s and dp are recomputed for the
//     [32, 64] tile, p and ds rebuilt from the saved row statistics, and
//     dv += (keep * p)^T d_out, dk += ds^T q accumulate in shared memory;
//     the column sums of ds give this head's share of d_bias, written to a
//     [B, H, T] partial that the wrapper sums over heads.
//
// Roundings are the TPU kernel's: p, dp, delta and ds in fp32; ds and
// keep * p rounded to the storage dtype before their products; products
// accumulate in fp32; dq and dk scaled after the product.
//
// Bound on this card: operations. Five T x T x D products a head, at the
// flagship (B=16, H=12, T=512, D=64, bf16) 32.2 GFLOP, 33 us at the
// 989 TFLOP/s tensor peak, against 88 MB of bytes (q, k, v, d_out read, dq,
// dk, dv written), 26 us at 3.35 TB/s. The two-pass design computes s and
// dp twice (seven products). The products run through one helper,
// block_gemm, on shared-memory operands: bf16 with D a multiple of 16 on the
// tensor cores as 16x16x16 mma (WMMA), everything else (fp32, odd widths) as
// fp32 FMAs. No wgmma, TMA or double buffering yet.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr float kMaskBias = -1e9f;

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
// Row padding of an operand tile: 16 bytes for bf16 (WMMA wants a leading
// dimension that is a multiple of 8 elements; the skew spreads banks), one
// float for fp32.
__host__ __device__ constexpr int pad_of(int esize) { return esize == 2 ? 8 : 1; }

// C[M, N] (fp32, row-major, ldc) = (ACC ? C : 0) + A B on shared memory, with
// A(i, k) = AT ? A[k * lda + i] : A[i * lda + k] and
// B(k, j) = BT ? B[j * ldb + k] : B[k * ldb + j]. Callers synchronise.
template <bool AT, bool BT, bool ACC>
__device__ __forceinline__ void block_gemm(float* C, int ldc, const float* A, int lda,
                                           const float* B, int ldb, int M, int N, int K) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int i = idx / N, j = idx % N;
    float acc = ACC ? C[i * ldc + j] : 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(AT ? A[k * lda + i] : A[i * lda + k], BT ? B[j * ldb + k] : B[k * ldb + j], acc);
    C[i * ldc + j] = acc;
  }
}

// bf16 operands: M, N, K multiples of 16; each warp owns whole 16x16 tiles.
template <bool AT, bool BT, bool ACC>
__device__ __forceinline__ void block_gemm(float* C, int ldc, const bf16* A, int lda,
                                           const bf16* B, int ldb, int M, int N, int K) {
  using namespace nvcuda;
  using LayoutA = std::conditional_t<AT, wmma::col_major, wmma::row_major>;
  using LayoutB = std::conditional_t<BT, wmma::col_major, wmma::row_major>;
  const int warp = threadIdx.x / 32, nb = N / 16;
  for (int f = warp; f < (M / 16) * nb; f += kWarps) {
    const int i0 = f / nb * 16, j0 = f % nb * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (ACC)
      wmma::load_matrix_sync(c, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b;
      wmma::load_matrix_sync(a, AT ? A + k0 * lda + i0 : A + i0 * lda + k0, lda);
      wmma::load_matrix_sync(b, BT ? B + j0 * ldb + k0 : B + k0 * ldb + j0, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
  }
}

// Rows t0 .. t0+rows-1 of one head into shared memory as E (zeros past T).
template <typename T, typename E>
__device__ __forceinline__ void load_rows(E* dst, int ld, const T* src, size_t base, int t0,
                                          int rows, int T_len, int HD, int D) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D, t = t0 + r;
    dst[r * ld + d] =
        vg::from_f32<E>(t < T_len ? vg::to_f32(src[base + (size_t)t * HD + d]) : 0.f);
  }
}

// bf16 to bf16 with D a multiple of 16: 16-byte copies.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, size_t base,
                                          int t0, int rows, int T_len, int HD, int D) {
  const int n8 = D / 8;
  for (int i = threadIdx.x; i < rows * n8; i += kThreads) {
    const int r = i / n8, c8 = i % n8, t = t0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < T_len) val = *reinterpret_cast<const uint4*>(src + base + (size_t)t * HD + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c8 * 8) = val;
  }
}

struct LayoutDq {
  int q, d_out, kv, s, dp, total;
};

__host__ __device__ inline LayoutDq layout_dq(int D, int Tp, int esize) {
  const int ld = D + pad_of(esize);
  LayoutDq L;
  int o = 0;
  L.q = o, o += align128(kBQ * ld * esize);
  L.d_out = o, o += align128(kBQ * ld * esize);
  L.kv = o, o += align128(kBK * ld * esize);
  L.s = o, o += align128(kBQ * imax(Tp + 4, D + 4) * 4);  // scores, later the dq tile
  L.dp = o, o += align128(kBQ * (Tp + 4) * 4);            // dp, later ds as E
  L.total = o;
  return L;
}

// Pass 1. T: storage dtype in device memory; E: operand dtype in shared
// memory (bf16 for the tensor cores, else float).
template <typename T, typename E>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const T* __restrict__ d_out, T* __restrict__ dq,
                        float* __restrict__ stats, int T_len, int H, int D, int Tp,
                        float scale, vg::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem_dq[];
  const LayoutDq L = layout_dq(D, Tp, (int)sizeof(E));
  const int ldE = D + pad_of((int)sizeof(E)), ldS = Tp + 4, ldO = D + 4;
  const int ldDS = ldS * (int)(sizeof(float) / sizeof(E));
  E* Qs = reinterpret_cast<E*>(smem_dq + L.q);
  E* dOs = reinterpret_cast<E*>(smem_dq + L.d_out);
  E* KVs = reinterpret_cast<E*>(smem_dq + L.kv);
  float* Ss = reinterpret_cast<float*>(smem_dq + L.s);
  float* DPs = reinterpret_cast<float*>(smem_dq + L.dp);
  const E* DSs = reinterpret_cast<const E*>(DPs);
  float* dQs = Ss;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = (size_t)b * T_len * HD + (size_t)h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  drop.seed += (uint32_t)(b * H + h);
  const uint32_t drop_ld = (uint32_t)vg::round_up128(T_len);

  load_rows(Qs, ldE, q, base, q0, kBQ, T_len, HD, D);
  load_rows(dOs, ldE, d_out, base, q0, kBQ, T_len, HD, D);
  for (int k0 = 0; k0 < Tp; k0 += kBK) {  // raw scores q k^T
    __syncthreads();
    load_rows(KVs, ldE, k, base, k0, kBK, T_len, HD, D);
    __syncthreads();
    block_gemm<false, true, false>(Ss + k0, ldS, Qs, ldE, KVs, ldE, kBQ, kBK, D);
  }
  for (int k0 = 0; k0 < Tp; k0 += kBK) {  // dp = d_out v^T
    __syncthreads();
    load_rows(KVs, ldE, v, base, k0, kBK, T_len, HD, D);
    __syncthreads();
    block_gemm<false, true, false>(DPs + k0, ldS, dOs, ldE, KVs, ldE, kBQ, kBK, D);
  }
  __syncthreads();

  // Rows: p, keep, delta, ds. A warp owns 4 rows and holds a row's p and
  // dp in registers (at most 16 values a lane each at T <= 512), so ds can
  // be written as E over the row's own dp storage.
  const int nj = Tp / 32;
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i, row = q0 + r;
    const float* srow = Ss + r * ldS;
    float* dprow = DPs + r * ldS;
    float pv[16], dv[16];
    float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < nj) {
        const int c = lane + 32 * j;
        const float bv = c < T_len ? bias[(size_t)b * T_len + c] : kMaskBias;
        pv[j] = srow[c] * scale + bv;
        m = fmaxf(m, pv[j]);
      }
    }
    m = vg::warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < nj) {
        pv[j] = expf(pv[j] - m);
        l += pv[j];
      }
    }
    l = vg::warp_sum(l);
    float delta = 0.f;
    const uint32_t drop_row = (uint32_t)row * drop_ld;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < nj) {
        const int c = lane + 32 * j;
        pv[j] = pv[j] / l;
        float d = dprow[c];
        if (drop.on) d = drop.keep(drop_row + c) ? d * drop.scale : 0.f;
        dv[j] = d;
        delta += d * pv[j];
      }
    }
    delta = vg::warp_sum(delta);
    __syncwarp();
    E* dsrow = reinterpret_cast<E*>(dprow);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < nj)
        dsrow[lane + 32 * j] = vg::from_f32<E>(vg::round_through<T>(pv[j] * (dv[j] - delta)));
    if (lane == 0 && row < T_len) {
      float* st = stats + ((size_t)(b * H + h) * T_len + row) * 3;
      st[0] = m, st[1] = l, st[2] = delta;
    }
  }
  __syncthreads();

  // dq = (ds k) * scale, accumulated over the K tiles in the scores' storage.
  for (int i = threadIdx.x; i < kBQ * ldO; i += kThreads) dQs[i] = 0.f;
  for (int k0 = 0; k0 < Tp; k0 += kBK) {
    __syncthreads();
    load_rows(KVs, ldE, k, base, k0, kBK, T_len, HD, D);
    __syncthreads();
    block_gemm<false, false, true>(dQs, ldO, DSs + k0, ldDS, KVs, ldE, kBQ, D, kBK);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    if (t < T_len) dq[base + (size_t)t * HD + c] = vg::from_f32<T>(dQs[r * ldO + c] * scale);
  }
}

struct LayoutDkv {
  int k, v, q, d_out, s, dp, pd, ds, dk, dv, total;
};

__host__ __device__ inline LayoutDkv layout_dkv(int D, int esize) {
  const int ld = D + pad_of(esize), ldP = kBK + pad_of(esize);
  LayoutDkv L;
  int o = 0;
  L.k = o, o += align128(kBK * ld * esize);
  L.v = o, o += align128(kBK * ld * esize);
  L.q = o, o += align128(kBQ * ld * esize);
  L.d_out = o, o += align128(kBQ * ld * esize);
  L.s = o, o += align128(kBQ * (kBK + 4) * 4);
  L.dp = o, o += align128(kBQ * (kBK + 4) * 4);
  L.pd = o, o += align128(kBQ * ldP * esize);
  L.ds = o, o += align128(kBQ * ldP * esize);
  L.dk = o, o += align128(kBK * (D + 4) * 4);
  L.dv = o, o += align128(kBK * (D + 4) * 4);
  L.total = o;
  return L;
}

// Pass 2.
template <typename T, typename E>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         const T* __restrict__ d_out, const float* __restrict__ stats,
                         T* __restrict__ dk, T* __restrict__ dv,
                         float* __restrict__ d_bias_part, int T_len, int H, int D,
                         float scale, vg::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem_dkv[];
  const LayoutDkv L = layout_dkv(D, (int)sizeof(E));
  const int ldE = D + pad_of((int)sizeof(E)), ldT = kBK + 4, ldO = D + 4;
  const int ldP = kBK + pad_of((int)sizeof(E));
  E* Ks = reinterpret_cast<E*>(smem_dkv + L.k);
  E* Vs = reinterpret_cast<E*>(smem_dkv + L.v);
  E* Qs = reinterpret_cast<E*>(smem_dkv + L.q);
  E* dOs = reinterpret_cast<E*>(smem_dkv + L.d_out);
  float* Ss = reinterpret_cast<float*>(smem_dkv + L.s);
  float* DPs = reinterpret_cast<float*>(smem_dkv + L.dp);
  E* PDs = reinterpret_cast<E*>(smem_dkv + L.pd);
  E* DSs = reinterpret_cast<E*>(smem_dkv + L.ds);
  float* dKs = reinterpret_cast<float*>(smem_dkv + L.dk);
  float* dVs = reinterpret_cast<float*>(smem_dkv + L.dv);

  const int k0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = (size_t)b * T_len * HD + (size_t)h * D;
  drop.seed += (uint32_t)(b * H + h);
  const uint32_t drop_ld = (uint32_t)vg::round_up128(T_len);

  load_rows(Ks, ldE, k, base, k0, kBK, T_len, HD, D);
  load_rows(Vs, ldE, v, base, k0, kBK, T_len, HD, D);
  for (int i = threadIdx.x; i < kBK * ldO; i += kThreads) dKs[i] = 0.f, dVs[i] = 0.f;

  // Elementwise phase: a thread owns key column ecol and 8 of the 32 rows.
  const int ecol = threadIdx.x % kBK, erow0 = threadIdx.x / kBK * 8;
  const int key = k0 + ecol;
  const float bv = key < T_len ? bias[(size_t)b * T_len + key] : kMaskBias;
  const float* head_stats = stats + (size_t)(b * H + h) * T_len * 3;
  float colsum = 0.f;

  for (int q0 = 0; q0 < T_len; q0 += kBQ) {
    __syncthreads();
    load_rows(Qs, ldE, q, base, q0, kBQ, T_len, HD, D);
    load_rows(dOs, ldE, d_out, base, q0, kBQ, T_len, HD, D);
    __syncthreads();
    block_gemm<false, true, false>(Ss, ldT, Qs, ldE, Ks, ldE, kBQ, kBK, D);
    block_gemm<false, true, false>(DPs, ldT, dOs, ldE, Vs, ldE, kBQ, kBK, D);
    __syncthreads();
    for (int i = 0; i < 8; ++i) {
      const int r = erow0 + i, row = q0 + r;
      float pd = 0.f, ds = 0.f;
      if (row < T_len) {
        const float* st = head_stats + (size_t)row * 3;
        const float p = expf(Ss[r * ldT + ecol] * scale + bv - st[0]) / st[1];
        float dp = DPs[r * ldT + ecol];
        pd = p;
        if (drop.on) {
          const bool keep = drop.keep((uint32_t)row * drop_ld + (uint32_t)key);
          dp = keep ? dp * drop.scale : 0.f;
          pd = keep ? p * drop.scale : 0.f;
        }
        ds = p * (dp - st[2]);
      }
      PDs[r * ldP + ecol] = vg::from_f32<E>(vg::round_through<T>(pd));
      DSs[r * ldP + ecol] = vg::from_f32<E>(vg::round_through<T>(ds));
      colsum += ds;
    }
    __syncthreads();
    block_gemm<true, false, true>(dVs, ldO, PDs, ldP, dOs, ldE, kBK, D, kBQ);
    block_gemm<true, false, true>(dKs, ldO, DSs, ldP, Qs, ldE, kBK, D, kBQ);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, c = i % D, t = k0 + r;
    if (t < T_len) {
      dk[base + (size_t)t * HD + c] = vg::from_f32<T>(dKs[r * ldO + c] * scale);
      dv[base + (size_t)t * HD + c] = vg::from_f32<T>(dVs[r * ldO + c]);
    }
  }
  if (d_bias_part != nullptr) {  // this head's column sums of ds
    Ss[threadIdx.x] = colsum;    // [4 row groups][kBK]
    __syncthreads();
    if (threadIdx.x < kBK && key < T_len)
      d_bias_part[(size_t)(b * H + h) * T_len + key] =
          Ss[ecol] + Ss[kBK + ecol] + Ss[2 * kBK + ecol] + Ss[3 * kBK + ecol];
  }
}

template <typename T, typename E>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const void* d_out, void* dq, void* dk, void* dv, float* d_bias_part,
                   float* stats, int B, int T_len, int H, int D, float scale,
                   vg::Dropout drop, cudaStream_t stream) {
  const int Tp = (T_len + kBK - 1) / kBK * kBK;
  const int smem_dq = layout_dq(D, Tp, (int)sizeof(E)).total;
  const int smem_dkv = layout_dkv(D, (int)sizeof(E)).total;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(d_out);
  attention_bwd_dq_kernel<T, E><<<dim3((T_len + kBQ - 1) / kBQ, H, B), kThreads, smem_dq,
                                  stream>>>(qt, kt, vt, bias, dot, static_cast<T*>(dq), stats,
                                            T_len, H, D, Tp, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<T, E><<<dim3(Tp / kBK, H, B), kThreads, smem_dkv, stream>>>(
      qt, kt, vt, bias, dot, stats, static_cast<T*>(dk), static_cast<T*>(dv), d_bias_part,
      T_len, H, D, scale, drop);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, d_out, dq, dk, dv: [B, T, H*D] contiguous, dtype 0 = fp32,
// 1 = bf16; bias: [B, T] fp32; stats: [B, H, T, 3] fp32 scratch;
// d_bias_part: [B, H, T] fp32 or null when the bias cotangent is not wanted.
// T <= 512, D <= 128. The dropout arguments are those of vg_flash_attention.
extern "C" int vg_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* bias, const void* d_out, void* dq, void* dk,
                                      void* dv, void* d_bias_part, void* stats, int B,
                                      int T_len, int H, int D, float scale, int dtype,
                                      int dropout, int seed, unsigned threshold,
                                      float keep_scale, void* stream) {
  if (T_len < 1 || T_len > 512 || D < 1 || D > 128) return cudaErrorInvalidValue;
  const float* bs = static_cast<const float*>(bias);
  float* dbp = static_cast<float*>(d_bias_part);
  float* st = static_cast<float*>(stats);
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  const vg::Dropout drop{dropout, (uint32_t)seed, threshold, keep_scale};
  if (dtype == 0)
    return launch<float, float>(q, k, v, bs, d_out, dq, dk, dv, dbp, st, B, T_len, H, D, scale,
                                drop, sm);
  if (dtype == 1 && D % 16 == 0)
    return launch<bf16, bf16>(q, k, v, bs, d_out, dq, dk, dv, dbp, st, B, T_len, H, D, scale,
                              drop, sm);
  if (dtype == 1)
    return launch<bf16, float>(q, k, v, bs, d_out, dq, dk, dv, dbp, st, B, T_len, H, D, scale,
                               drop, sm);
  return cudaErrorInvalidValue;
}
