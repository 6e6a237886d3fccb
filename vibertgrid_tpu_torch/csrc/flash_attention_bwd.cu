// Backward of the fused self-attention on packed heads: dq, dk, dv and the
// key-bias cotangent from q, k, v, bias, d_out and the forward's row
// statistic lse = max + log(sum), all [B, T, H*D] but bias [B, T] and lse
// [B, H, T].
//
// Replaces: vibertgrid_tpu/ops/flash_attention.py::_bwd_kernel. The TPU
// kernel rematerialised a head's whole [T, T] fp32 probability tile in VMEM
// and took all five products from it in one program. A Hopper block has
// 227 KB, and dk/dv sum over query tiles while dq sums over key tiles, so
// the work is split into two deterministic passes (no atomics):
//
//   dq pass, a block per (query tile, head, batch): p = exp(s - lse) with no
//     max, no sum and no divide; dp = keep * (d_out v^T);
//     delta = rowsum(dp * p); ds = p * (dp - delta); dq = (ds k) * scale.
//     delta goes to a [B, H, T] fp32 scratch for the second pass.
//   dk/dv pass, a block per (key tile, head, batch): query tiles stream past
//     the block's K and V tile; p and ds are rebuilt from lse and delta,
//     dv += (keep * p)^T d_out, dk += ds^T q; the sums of ds over the queries
//     give this head's share of d_bias, written to a [B, H, T] partial that
//     the wrapper sums over heads.
//
// Roundings are the TPU kernel's: p, dp, delta and ds in fp32; ds and
// keep * p rounded to the storage dtype before their products; products
// accumulate in fp32; dq and dk scaled after the product.
//
// delta is summed from dp * p and not taken as rowsum(d_out * out), the
// usual shortcut: `out` carries the bf16 rounding of itself and of the
// forward's probabilities, which moves delta by 2e-3 and d_bias, a sum of
// ds over 6144 (query, head) pairs, by twenty times its tolerance. So the dq
// pass walks the keys twice, first for delta, and the two passes take nine
// T x T x D products for the five the gradient has.
//
// Bound on this card: operations. Five T x T x D products a head, at the
// flagship (B=16, H=12, T=512, D=64, bf16) 32.2 GFLOP, 33 us at the
// 989 TFLOP/s tensor peak, against 88 MB of bytes (q, k, v, d_out read, dq,
// dk, dv written), 26 us at 3.35 TB/s.
//
// Two sets of bodies. bf16 with D = 64 (every full-width configuration) runs
// on wgmma: namespace hopper at the end of this file, with its own note.
// Everything else runs the generic kernels that follow, whose products go
// through one helper, block_gemm, on shared-memory operands: bf16 with D a
// multiple of 16 as 16x16x16 mma (WMMA), fp32 and odd widths as fp32 FMAs.

#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

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

// The dq pass: the tile's scores against all keys and dp = d_out v^T live in
// shared memory as two [32, T] fp32 arrays (K, then V, streamed in 64-row
// tiles), so one walk gives delta. T: storage dtype in device memory; E:
// operand dtype in shared memory (bf16 for the tensor cores, else float).
template <typename T, typename E>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const T* __restrict__ d_out, const float* __restrict__ lse,
                        T* __restrict__ dq, float* __restrict__ delta_out, int T_len, int H,
                        int D, int Tp, float scale, vg::Dropout drop) {
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
  drop.load();
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

  // Rows: p from lse, keep, delta, ds. A warp owns 4 rows and holds a row's p
  // and dp in registers (at most 16 values a lane each at T <= 512), so ds can
  // be written as E over the row's own dp storage.
  const int nj = Tp / 32;
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i, row = q0 + r;
    const float* srow = Ss + r * ldS;
    float* dprow = DPs + r * ldS;
    float pv[16], dv[16];
    const float row_lse = row < T_len ? lse[(size_t)(b * H + h) * T_len + row] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < nj) {
        const int c = lane + 32 * j;
        const float bv = c < T_len ? bias[(size_t)b * T_len + c] : kMaskBias;
        pv[j] = expf(srow[c] * scale + bv - row_lse);
      }
    }
    float delta = 0.f;
    const uint32_t drop_row = (uint32_t)row * drop_ld;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < nj) {
        const int c = lane + 32 * j;
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
    if (lane == 0 && row < T_len) delta_out[(size_t)(b * H + h) * T_len + row] = delta;
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

// The dk/dv pass.
template <typename T, typename E>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         const T* __restrict__ d_out, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
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
  drop.load();
  drop.seed += (uint32_t)(b * H + h);
  const uint32_t drop_ld = (uint32_t)vg::round_up128(T_len);

  load_rows(Ks, ldE, k, base, k0, kBK, T_len, HD, D);
  load_rows(Vs, ldE, v, base, k0, kBK, T_len, HD, D);
  for (int i = threadIdx.x; i < kBK * ldO; i += kThreads) dKs[i] = 0.f, dVs[i] = 0.f;

  // Elementwise phase: a thread owns key column ecol and 8 of the 32 rows.
  const int ecol = threadIdx.x % kBK, erow0 = threadIdx.x / kBK * 8;
  const int key = k0 + ecol;
  const float bv = key < T_len ? bias[(size_t)b * T_len + key] : kMaskBias;
  const float* head_lse = lse + (size_t)(b * H + h) * T_len;
  const float* head_delta = delta + (size_t)(b * H + h) * T_len;
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
        const float p = expf(Ss[r * ldT + ecol] * scale + bv - head_lse[row]);
        float dp = DPs[r * ldT + ecol];
        pd = p;
        if (drop.on) {
          const bool keep = drop.keep((uint32_t)row * drop_ld + (uint32_t)key);
          dp = keep ? dp * drop.scale : 0.f;
          pd = keep ? p * drop.scale : 0.f;
        }
        ds = p * (dp - head_delta[row]);
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
                   const void* d_out, const float* lse, void* dq, void* dk, void* dv,
                   float* d_bias_part, float* delta, int B, int T_len, int H, int D,
                   float scale, vg::Dropout drop, cudaStream_t stream) {
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
                                  stream>>>(qt, kt, vt, bias, dot, lse, static_cast<T*>(dq),
                                            delta, T_len, H, D, Tp, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<T, E><<<dim3(Tp / kBK, H, B), kThreads, smem_dkv, stream>>>(
      qt, kt, vt, bias, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), d_bias_part,
      T_len, H, D, scale, drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, D = 64, on wgmma (the flagship's bodies).
//
// What limited the generic kernels at this shape: the dq pass held two
// [32, T] fp32 arrays in 132 KB of shared memory (one block an SM, 23 waves)
// and loaded its tiles synchronously; block_gemm gave a warp one 16x16
// fragment and took the dk and dv sums through shared memory on every call;
// the dk/dv pass read three statistics from device memory per element and
// paid an exp and a divide for each (19 TFLOP/s over seven products).
//
// Design, both passes: one warpgroup (128 threads) a block; 64 x 64 bf16
// tiles in the 128-byte-swizzled layout (wgmma.cuh), the streamed pair in a
// two-stage cp.async ring with one block barrier a tile; every product a
// wgmma m64n64k16 with its sum in registers; p, dp, ds only ever in
// registers, where an accumulator's layout is the next product's A operand;
// exp as ex2 of a pre-scaled argument; results leave through shared memory
// as whole 128-byte rows.
//   dq pass: the block owns 64 query rows, holds Q and d_out and streams
//     (K, V) twice: the first walk takes S = Q K^T and dP = d_out V^T and sums
//     delta = rowsum(p * dp) in registers; the second takes them again, forms
//     ds and adds ds K (K read MN-major from the same tile) to dQ.
//   dk/dv pass: the block owns 64 keys, holds K and V and streams (Q, d_out):
//     S^T = K Q^T and dP^T = V d_out^T come out transposed, so (keep p)^T and
//     ds^T are A operands as they stand; dV += (keep p)^T d_out and
//     dK += ds^T Q read the streamed tiles MN-major; the row sums of ds^T are
//     the d_bias partial.
// Resources (ptxas -v, kept in the build's flash_attention_bwd.cu.log; no
// spills): dq pass 51 KB of dynamic shared memory, 127 registers (158 with
// dropout), three blocks an SM; dk/dv pass 53 KB, 162 registers and three
// blocks an SM (192 and two with dropout: the hash costs the registers that
// a third block needs). Each grid is 8 x 12 x 16 = 1536 blocks at the
// flagship, 3.9 waves of 3 x 132. Measured there (H100, 700 W): 0.10 + 0.07 ms
// for nine products, 300-370 TFLOP/s; the tensor cores wait on the serial
// chain products - elementwise - products inside a warpgroup, which only the
// other blocks of the SM overlap, and on m64n64k16 reading 4 KB of shared
// memory for 32 cycles of product.

namespace hopper {

using namespace vg::gmma;
constexpr int kWgThreads = 128;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
// two resident tiles, the ring, 512 floats of per-key or per-query values
constexpr int kSmemDq = 1024 + kTileBytes * (2 + 2 * kStages) + 512 * 4;
constexpr int kSmemDkv = 1024 + kTileBytes * (2 + 2 * kStages) + 2 * 512 * 4;

template <bool DROP>
__global__ void __launch_bounds__(kWgThreads, 3)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const bf16* __restrict__ d_out, const float* __restrict__ lse,
                        bf16* __restrict__ dq, float* __restrict__ delta_out, int T_len, int H,
                        float scale, vg::Dropout drop) {
  extern __shared__ unsigned char smem_hdq[];
  unsigned char* Qs = align1024(smem_hdq);
  unsigned char* dOs = Qs + kTileBytes;
  unsigned char* KVs = dOs + kTileBytes;  // [stage][K tile, V tile]
  float* bias2 = reinterpret_cast<float*>(KVs + 2 * kStages * kTileBytes);  // bias * log2(e)

  const int q0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * 64;
  const size_t head = (size_t)b * T_len * HD + (size_t)h * 64;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const int n_tiles = (T_len + kTileRows - 1) / kTileRows, n_steps = 2 * n_tiles;
  const int lane = threadIdx.x & 31, quad = lane & 3;
  const int row0 = q0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // rows row0 and row0 + 8
  drop.load();
  drop.seed += (uint32_t)(b * H + h);
  const uint32_t drop_ld = (uint32_t)vg::round_up128(T_len);

  auto prefetch = [&](int step) {
    unsigned char* stage = KVs + (step % kStages) * 2 * kTileBytes;
    const int t0 = (step % n_tiles) * kTileRows;
    load_swizzled<kWgThreads>(stage, kh, t0, T_len, HD);
    load_swizzled<kWgThreads>(stage + kTileBytes, vh, t0, T_len, HD);
  };
  load_swizzled<kWgThreads>(Qs, q + head, q0, T_len, HD);
  load_swizzled<kWgThreads>(dOs, d_out + head, q0, T_len, HD);
  prefetch(0);
  vg::cp_async_commit();
  for (int i = threadIdx.x; i < n_tiles * kTileRows; i += kWgThreads)
    bias2[i] = (i < T_len ? bias[(size_t)b * T_len + i] : kMaskBias) * kLog2e;
  float lse2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    lse2[hh] = row < T_len ? lse[(size_t)(b * H + h) * T_len + row] * kLog2e : 0.f;
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float delta[2] = {0.f, 0.f};
  const float c = scale * kLog2e;
  const uint64_t desc_q = descriptor(Qs), desc_do = descriptor(dOs);

  // One step of either walk: S and dP of the key tile in the ring, then the
  // elementwise part; the first walk only sums delta, the second forms ds
  // and adds ds K to dQ.
  auto step_of = [&](int step, auto second_walk) {
    constexpr bool kSecond = decltype(second_walk)::value;
    vg::cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();  // this step's tiles have landed; every warp is done with the last
    if (step + 1 < n_steps) prefetch(step + 1);
    vg::cp_async_commit();
    const unsigned char* Ks = KVs + (step % kStages) * 2 * kTileBytes;
    const int it = step % n_tiles;

    float s[32], dp[32];
    mma_fence();
    product_ss(s, desc_q, descriptor(Ks));
    product_ss(dp, desc_do, descriptor(Ks + kTileBytes));
    mma_commit();
    mma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const float* bt = bias2 + it * kTileRows + 2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, hh = e >> 1;
        const float p = exp2_approx(fmaf(s[i], c, (e & 1) ? bb.y : bb.x) - lse2[hh]);
        float d = dp[i];
        if (DROP) {
          const uint32_t col = (uint32_t)(it * kTileRows + 8 * j + 2 * quad + (e & 1));
          d = drop.keep((uint32_t)(row0 + 8 * hh) * drop_ld + col) ? d * drop.scale : 0.f;
        }
        if (kSecond)
          s[i] = p * (d - delta[hh]);
        else
          delta[hh] = fmaf(p, d, delta[hh]);
      }
    }
    if (kSecond) {
      uint32_t a[4][4];
      to_operand(a, s);
      mma_fence();
      product_rs_acc(acc, a, descriptor(Ks));
      mma_commit();
      mma_wait<0>();
      fence_regs(acc);
    }
  };
  for (int step = 0; step < n_tiles; ++step) step_of(step, std::false_type{});
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    delta[hh] = quad_sum(delta[hh]);
    const int row = row0 + 8 * hh;
    if (quad == 0 && row < T_len) delta_out[(size_t)(b * H + h) * T_len + row] = delta[hh];
  }
  for (int step = n_tiles; step < n_steps; ++step) step_of(step, std::true_type{});
  const float factor[2] = {scale, scale};
  __syncthreads();  // every warp's products have read the Q tile
  store_tile(Qs, acc, factor, dq + head, q0, T_len, HD);
}

template <bool DROP>
__global__ void __launch_bounds__(kWgThreads, DROP ? 2 : 3)
attention_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         const bf16* __restrict__ d_out, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, float* __restrict__ d_bias_part, int T_len,
                         int H, float scale, vg::Dropout drop) {
  extern __shared__ unsigned char smem_hdkv[];
  unsigned char* Ks = align1024(smem_hdkv);
  unsigned char* Vs = Ks + kTileBytes;
  unsigned char* QdOs = Vs + kTileBytes;  // [stage][Q tile, d_out tile]
  float* lse2 = reinterpret_cast<float*>(QdOs + 2 * kStages * kTileBytes);  // lse * log2(e)
  float* deltas = lse2 + 512;

  const int k0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * 64;
  const size_t head = (size_t)b * T_len * HD + (size_t)h * 64;
  const bf16* qh = q + head;
  const bf16* doh = d_out + head;
  const int n_tiles = (T_len + kTileRows - 1) / kTileRows;
  const int lane = threadIdx.x & 31, quad = lane & 3;
  const int key0 = k0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // keys key0 and key0 + 8
  drop.load();
  drop.seed += (uint32_t)(b * H + h);
  const uint32_t drop_ld = (uint32_t)vg::round_up128(T_len);

  auto prefetch = [&](int it) {
    unsigned char* stage = QdOs + (it % kStages) * 2 * kTileBytes;
    load_swizzled<kWgThreads>(stage, qh, it * kTileRows, T_len, HD);
    load_swizzled<kWgThreads>(stage + kTileBytes, doh, it * kTileRows, T_len, HD);
  };
  load_swizzled<kWgThreads>(Ks, k + head, k0, T_len, HD);
  load_swizzled<kWgThreads>(Vs, v + head, k0, T_len, HD);
  prefetch(0);
  vg::cp_async_commit();
  for (int i = threadIdx.x; i < n_tiles * kTileRows; i += kWgThreads) {
    const bool valid = i < T_len;
    lse2[i] = valid ? lse[(size_t)(b * H + h) * T_len + i] * kLog2e : 0.f;
    deltas[i] = valid ? delta[(size_t)(b * H + h) * T_len + i] : 0.f;
  }
  float bias2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    bias2[hh] = (key < T_len ? bias[(size_t)b * T_len + key] : kMaskBias) * kLog2e;
  }

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = 0.f, dva[i] = 0.f;
  float colsum[2] = {0.f, 0.f};
  const float c = scale * kLog2e;
  const uint64_t desc_k = descriptor(Ks), desc_v = descriptor(Vs);

  for (int it = 0; it < n_tiles; ++it) {
    vg::cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();  // tile `it` has landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles) prefetch(it + 1);
    vg::cp_async_commit();
    const unsigned char* Qt = QdOs + (it % kStages) * 2 * kTileBytes;
    const uint64_t desc_q = descriptor(Qt), desc_do = descriptor(Qt + kTileBytes);

    float st[32], dpt[32];  // S^T and dP^T: rows are keys, columns are queries
    mma_fence();
    product_ss(st, desc_k, desc_q);
    product_ss(dpt, desc_v, desc_do);
    mma_commit();
    mma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    const int qcol = it * kTileRows + 2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(lse2 + qcol + 8 * j);
      const float2 dl = *reinterpret_cast<const float2*>(deltas + qcol + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, hh = e >> 1;
        const float p = exp2_approx(fmaf(st[i], c, bias2[hh]) - ((e & 1) ? ls.y : ls.x));
        float d = dpt[i], pd = p;
        if (DROP) {
          const uint32_t row = (uint32_t)(qcol + 8 * j + (e & 1));
          const bool keep = drop.keep(row * drop_ld + (uint32_t)(key0 + 8 * hh));
          d = keep ? d * drop.scale : 0.f;
          pd = keep ? p * drop.scale : 0.f;
        }
        const float ds = p * (d - ((e & 1) ? dl.y : dl.x));
        colsum[hh] += ds;
        st[i] = pd;
        dpt[i] = ds;
      }
    }
    uint32_t a_p[4][4], a_ds[4][4];
    to_operand(a_p, st);
    to_operand(a_ds, dpt);
    mma_fence();
    product_rs_acc(dva, a_p, desc_do);
    product_rs_acc(dka, a_ds, desc_q);
    mma_commit();
    mma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
  }
  const float by_scale[2] = {scale, scale}, by_one[2] = {1.f, 1.f};
  __syncthreads();  // every warp's products have read the K and V tiles
  store_tile(Ks, dka, by_scale, dk + head, k0, T_len, HD);
  store_tile(Vs, dva, by_one, dv + head, k0, T_len, HD);
  if (d_bias_part != nullptr) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float total = quad_sum(colsum[hh]);
      const int key = key0 + 8 * hh;
      if (quad == 0 && key < T_len) d_bias_part[(size_t)(b * H + h) * T_len + key] = total;
    }
  }
}

template <bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const void* d_out, const float* lse, void* dq, void* dk, void* dv,
                   float* d_bias_part, float* delta, int B, int T_len, int H, float scale,
                   vg::Dropout drop, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDkv);
  if (err != cudaSuccess) return err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(d_out);
  const dim3 grid((T_len + kTileRows - 1) / kTileRows, H, B);
  attention_bwd_dq_kernel<DROP><<<grid, kWgThreads, kSmemDq, stream>>>(
      qt, kt, vt, bias, dot, lse, static_cast<bf16*>(dq), delta, T_len, H, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<DROP><<<grid, kWgThreads, kSmemDkv, stream>>>(
      qt, kt, vt, bias, dot, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      d_bias_part, T_len, H, scale, drop);
  return cudaGetLastError();
}

}  // namespace hopper
}  // namespace

// q, k, v, d_out, dq, dk, dv: [B, T, H*D] contiguous, dtype 0 = fp32,
// 1 = bf16; bias: [B, T] fp32; lse: [B, H, T] fp32 from vg_flash_attention;
// delta: [B, H, T] fp32 scratch; d_bias_part: [B, H, T] fp32 or null when the
// bias cotangent is not wanted. T <= 512, D <= 128. The dropout arguments are
// those of vg_flash_attention.
extern "C" int vg_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* bias, const void* d_out, const void* lse,
                                      void* dq, void* dk, void* dv, void* d_bias_part,
                                      void* delta, int B, int T_len, int H, int D, float scale,
                                      int dtype, int dropout, const void* seed,
                                      unsigned threshold, float keep_scale, void* stream) {
  if (T_len < 1 || T_len > 512 || D < 1 || D > 128) return cudaErrorInvalidValue;
  const float* bs = static_cast<const float*>(bias);
  const float* ls = static_cast<const float*>(lse);
  float* dbp = static_cast<float*>(d_bias_part);
  float* dl = static_cast<float*>(delta);
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  const vg::Dropout drop{dropout, static_cast<const uint32_t*>(seed), threshold, keep_scale,
                         0u};
  if (dtype == 0)
    return launch<float, float>(q, k, v, bs, d_out, ls, dq, dk, dv, dbp, dl, B, T_len, H, D,
                                scale, drop, sm);
  if (dtype == 1 && D == 64)
    return drop.on ? hopper::launch<true>(q, k, v, bs, d_out, ls, dq, dk, dv, dbp, dl, B, T_len,
                                          H, scale, drop, sm)
                   : hopper::launch<false>(q, k, v, bs, d_out, ls, dq, dk, dv, dbp, dl, B,
                                           T_len, H, scale, drop, sm);
  if (dtype == 1 && D % 16 == 0)
    return launch<bf16, bf16>(q, k, v, bs, d_out, ls, dq, dk, dv, dbp, dl, B, T_len, H, D,
                              scale, drop, sm);
  if (dtype == 1)
    return launch<bf16, float>(q, k, v, bs, d_out, ls, dq, dk, dv, dbp, dl, B, T_len, H, D,
                               scale, drop, sm);
  return cudaErrorInvalidValue;
}
