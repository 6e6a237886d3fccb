// Fused self-attention on packed heads: out = softmax(q k^T * scale + bias) v
// per (batch, head), with q/k/v/out laid out [B, T, H*D].
//
// Replaces: vibertgrid_tpu/ops/flash_attention.py::_fwd_kernel. The TPU
// kernel held a whole [T, T] fp32 score tile in VMEM per head group; T is at
// most 512 (one framed 510-token window), so no online softmax was needed.
//
// Bound on this card: at the flagship (B=16, H=12, T=512, D=64, bf16) the
// work is 4*B*H*T^2*D = 12.9 GFLOP, 13 us at the 989 TFLOP/s bf16 tensor
// peak, and the bytes are q, k, v and out once each, 50 MB or 15 us at
// 3.35 TB/s: the two bounds are about equal.
//
// Design: one block per (query tile, head, batch). Head h is read straight
// out of the packed layout at columns h*D .. h*D+D, so no head transposes
// exist. Phase 1 streams K in 64-row tiles through shared memory and keeps
// the fp32 scores of the block's query rows against all keys in shared
// memory (64 KB for 32 rows at T=512). Phase 2 takes each row's max and sum
// and normalises, rounding p to the storage dtype as the TPU kernel does
// before its p.v product (flash_attention.py:123); in training it first drops
// probabilities by the stateless hash the backward kernel
// (flash_attention_bwd.cu) regenerates. Phase 3 streams V tiles
// and accumulates p.v in fp32. Keys past T get bias -1e9 (zero weight, as
// the TPU kernel's -1e9 padding gives) and query rows past T are not
// stored, so any T <= 512 works without the caller padding.
//
// Three bodies. bf16 with D = 64 (BERT-base, RoBERTa-base: every full-width
// configuration) runs on wgmma with an online softmax: namespace hopper at
// the end of this file, which has its own note. bf16 with D = 32 or 128 keeps
// the plan above on 16x16x16 mma (WMMA) with K/V tiles double-buffered by
// cp.async (namespace tc). Every other case (fp32, odd widths) runs fp32 FMAs
// on the CUDA cores: the next section.
//
// When the caller will take a gradient it passes `lse` and every body also
// writes lse[b, h, row] = max + log(sum) of the row's biased scores, from
// which the backward kernel rebuilds the probabilities.

#include <mma.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// fp32 FMA body: 64 query rows a block, scores 64 x Tp fp32 (128 KB at
// T = 512), each thread 8 rows x 2 key columns of a score tile and 8 rows x
// ceil(D/32) output columns.
constexpr int kThreads = 256;  // 8 warps
constexpr int kBQ = 64;        // query rows per block: 8 per warp
constexpr int kBK = 64;        // keys per K/V tile
constexpr float kMaskBias = -1e9f;

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, size_t base,
                                          int t0, int T_len, int HD, int D) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D, t = t0 + r;
    dst[r * ld + d] = t < T_len ? vg::to_f32(src[base + (size_t)t * HD + d]) : 0.f;
  }
}

// DJ = ceil(D / 32): output columns per thread in phase 3.
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads, 1)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int T_len, int H, int D, int Tp,
                 float scale, vg::Dropout drop) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // odd stride: lanes reading different rows hit different banks
  float* Qs = smem;             // [kBQ][ld]
  float* KVs = Qs + kBQ * ld;   // [kBK][ld], K tiles then V tiles
  float* Ss = KVs + kBK * ld;   // [kBQ][Tp] scores, then probabilities

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = (size_t)b * T_len * HD + (size_t)h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 8;  // this warp's 8 query rows within the tile
  drop.load();
  drop.seed += (uint32_t)(b * H + h);
  const uint32_t drop_ld = (uint32_t)vg::round_up128(T_len);

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    Qs[r * ld + d] = t < T_len ? vg::to_f32(q[base + (size_t)t * HD + d]) : 0.f;
  }

  // Phase 1: scores. Thread (warp, lane) owns rows row0..row0+7 and key
  // columns lane, lane+32 of each tile.
  for (int k0 = 0; k0 < Tp; k0 += kBK) {
    __syncthreads();
    load_tile(KVs, ld, k, base, k0, T_len, HD, D);
    __syncthreads();
    float acc[8][2] = {};
    for (int d = 0; d < D; ++d) {
      float a[8], bk[2];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Qs[(row0 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) bk[j] = KVs[(lane + 32 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = k0 + lane + 32 * j;
      const float bv = c < T_len ? bias[(size_t)b * T_len + c] : kMaskBias;
#pragma unroll
      for (int i = 0; i < 8; ++i) Ss[(row0 + i) * Tp + c] = acc[i][j] * scale + bv;
    }
  }
  __syncthreads();

  // Phase 2: each warp normalises its own 8 rows.
  for (int i = 0; i < 8; ++i) {
    float* row = Ss + (row0 + i) * Tp;
    float m = __int_as_float(0xff800000);  // -inf
    for (int c = lane; c < Tp; c += 32) m = fmaxf(m, row[c]);
    m = vg::warp_max(m);
    float l = 0.f;
    for (int c = lane; c < Tp; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      l += e;
    }
    l = vg::warp_sum(l);
    if (lse != nullptr && lane == 0 && q0 + row0 + i < T_len)
      lse[(size_t)(b * H + h) * T_len + q0 + row0 + i] = m + logf(l);
    const uint32_t drop_row = (uint32_t)(q0 + row0 + i) * drop_ld;
    for (int c = lane; c < Tp; c += 32) {
      float p = row[c] / l;
      if (drop.on) p = drop.keep(drop_row + c) ? p * drop.scale : 0.f;
      row[c] = vg::round_through<T>(p);
    }
  }

  // Phase 3: out = p v. Thread owns rows row0..row0+7, columns lane + 32 j.
  float o[8][DJ] = {};
  for (int k0 = 0; k0 < Tp; k0 += kBK) {
    __syncthreads();
    load_tile(KVs, ld, v, base, k0, T_len, HD, D);
    __syncthreads();
    for (int kk = 0; kk < kBK; ++kk) {
      float p[8], vv[DJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = Ss[(row0 + i) * Tp + k0 + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < D ? KVs[kk * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(p[i], vv[j], o[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = q0 + row0 + i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      if (c < D) out[base + (size_t)t * HD + c] = vg::from_f32<T>(o[i][j]);
    }
  }
}

template <typename T, int DJ>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* out, float* lse, int B, int T_len, int H, int D, float scale,
                   vg::Dropout drop, cudaStream_t stream) {
  const int Tp = (T_len + kBK - 1) / kBK * kBK;
  const size_t smem = ((size_t)(kBQ + kBK) * (D + 1) + (size_t)kBQ * Tp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  attention_kernel<T, DJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), lse, T_len, H, D, Tp, scale, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* bias,
                     void* out, float* lse, int B, int T_len, int H, int D, float scale,
                     vg::Dropout drop, cudaStream_t stream) {
  if (D <= 32) return launch<T, 1>(q, k, v, bias, out, lse, B, T_len, H, D, scale, drop, stream);
  if (D <= 64) return launch<T, 2>(q, k, v, bias, out, lse, B, T_len, H, D, scale, drop, stream);
  if (D <= 128) return launch<T, 4>(q, k, v, bias, out, lse, B, T_len, H, D, scale, drop, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 with D = 32 or 128 on the tensor cores: 16x16x16 bf16 mma (WMMA)
// with fp32 accumulation, 32 query rows a block so that two blocks share an
// SM. The walk is one sequence of stages, the K tiles then the V tiles,
// double-buffered with cp.async so tile s+1 loads while tile s computes.
// Each K stage gives a 32 x 64 score tile, one fragment a warp, stored raw as
// fp32. After the last K tile, phase 2 applies scale and bias and normalises
// each row in registers (at most 16 values a lane at T <= 512), then writes
// p as bf16 over the first half of the row's own fp32 storage, where the V
// stages read it as the row-major A operand of p.v.
// Shared memory at D = 64, T = 512: q tile 4.5 KB, two K/V tiles 18 KB,
// scores 32 x 516 x 4 = 65 KB, the fp32 output tile 8.5 KB (96 KB).

namespace tc {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
constexpr int kRows = 32;  // query rows per block: 4 per warp

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

template <int D>
struct Smem {
  static constexpr int kLd = D + 8, kLdO = D + 4;
  static constexpr int kQ = align128(kRows * kLd * 2);
  static constexpr int kTile = align128(kBK * kLd * 2);
  __host__ __device__ static int scores(int Tp) { return align128(kRows * (Tp + 4) * 4); }
  __host__ __device__ static int bytes(int Tp) { return kQ + 2 * kTile + scores(Tp) + kRows * kLdO * 4; }
};

// Rows t0 .. t0+rows-1 of one head into shared memory (zeros past T).
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t base, int t0,
                                          int rows, int T_len, int HD) {
  constexpr int kLd = D + 8;
  for (int i = threadIdx.x; i < rows * D / 8; i += kThreads) {
    const int r = i / (D / 8), c8 = i % (D / 8), t = t0 + r;
    bf16* d = dst + r * kLd + c8 * 8;
    if (t < T_len)
      vg::cp_async16(d, src + base + (size_t)t * HD + c8 * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// DROP: compiled with the dropout of the probabilities (training) or
// without it (inference keeps the registers and the code of the plain
// kernel).
template <int D, bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ out, float* __restrict__ lse, int T_len, int H, int Tp,
                 float scale, vg::Dropout drop) {
  using L = Smem<D>;
  constexpr int kLd = L::kLd, kLdO = L::kLdO;
  constexpr int DF = D / 16;                 // output fragments per row block
  constexpr int kOut = (2 * DF + 7) / 8;     // output fragments per warp
  const int ldS = Tp + 4;                    // fp32 scores; p is bf16 with ld 2*ldS
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* KVs = reinterpret_cast<bf16*>(smem_tc + L::kQ);  // [2][kBK][kLd]
  float* Ss = reinterpret_cast<float*>(smem_tc + L::kQ + 2 * L::kTile);
  float* Os = reinterpret_cast<float*>(smem_tc + L::kQ + 2 * L::kTile + L::scores(Tp));
  const bf16* Ps = reinterpret_cast<const bf16*>(Ss);

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = (size_t)b * T_len * HD + (size_t)h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = Tp / kBK, total = 2 * n_tiles;
  drop.load();
  drop.seed += (uint32_t)(b * H + h);
  const uint32_t drop_ld = (uint32_t)vg::round_up128(T_len);
  auto prefetch = [&](int s) {
    bf16* dst = KVs + (s & 1) * (L::kTile / 2);
    if (s < n_tiles)
      load_rows<D>(dst, k, base, s * kBK, kBK, T_len, HD);
    else
      load_rows<D>(dst, v, base, (s - n_tiles) * kBK, kBK, T_len, HD);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[kOut];
#pragma unroll
  for (int u = 0; u < kOut; ++u) wmma::fill_fragment(o[u], 0.f);

  load_rows<D>(Qs, q, base, q0, kRows, T_len, HD);
  prefetch(0);
  vg::cp_async_commit();
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) prefetch(s + 1);
    vg::cp_async_commit();
    vg::cp_async_wait<1>();
    __syncthreads();
    const bf16* tile = KVs + (s & 1) * (L::kTile / 2);
    if (s < n_tiles) {
      // Phase 1: raw scores of key tile s; warp owns one 16 x 16 fragment.
      const int rb = warp / 4, cb = warp % 4;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, Qs + rb * 16 * kLd + kk, kLd);
        wmma::load_matrix_sync(bk, tile + cb * 16 * kLd + kk, kLd);
        wmma::mma_sync(sc, a, bk, sc);
      }
      wmma::store_matrix_sync(Ss + rb * 16 * ldS + s * kBK + cb * 16, sc, ldS,
                              wmma::mem_row_major);
      if (s == n_tiles - 1) {
        __syncthreads();
        // Phase 2: p = softmax(s * scale + bias), rounded to bf16, in place.
        const int nj = Tp / 32;
        for (int i = 0; i < 4; ++i) {
          float* row = Ss + (warp * 4 + i) * ldS;
          float vals[16];
          float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < nj) {
              const int c = lane + 32 * j;
              const float bv = c < T_len ? bias[(size_t)b * T_len + c] : kMaskBias;
              vals[j] = row[c] * scale + bv;
              m = fmaxf(m, vals[j]);
            }
          }
          m = vg::warp_max(m);
          float l = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < nj) {
              vals[j] = expf(vals[j] - m);
              l += vals[j];
            }
          }
          l = vg::warp_sum(l);
          if (lse != nullptr && lane == 0 && q0 + warp * 4 + i < T_len)
            lse[(size_t)(b * H + h) * T_len + q0 + warp * 4 + i] = m + logf(l);
          __syncwarp();
          bf16* prow = reinterpret_cast<bf16*>(row);
          const uint32_t drop_row = (uint32_t)(q0 + warp * 4 + i) * drop_ld;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < nj) {
              float p = vals[j] / l;
              if (DROP) p = drop.keep(drop_row + lane + 32 * j) ? p * drop.scale : 0.f;
              prow[lane + 32 * j] = __float2bfloat16_rn(p);
            }
          }
        }
      }
    } else {
      // Phase 3: out += p[:, tile] . v tile.
      const int k0 = (s - n_tiles) * kBK;
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
        const int f = warp + 8 * u, rb = f / DF, cb = f % DF;
        if (f < 2 * DF) {
#pragma unroll
          for (int kk = 0; kk < kBK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
            wmma::load_matrix_sync(a, Ps + rb * 16 * (2 * ldS) + k0 + kk, 2 * ldS);
            wmma::load_matrix_sync(bv, tile + kk * kLd + cb * 16, kLd);
            wmma::mma_sync(o[u], a, bv, o[u]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kOut; ++u) {
    const int f = warp + 8 * u, rb = f / DF, cb = f % DF;
    if (f < 2 * DF)
      wmma::store_matrix_sync(Os + rb * 16 * kLdO + cb * 16, o[u], kLdO, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    if (t < T_len) out[base + (size_t)t * HD + c] = __float2bfloat16_rn(Os[r * kLdO + c]);
  }
}

template <int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   float* lse, int B, int T_len, int H, float scale, vg::Dropout drop,
                   cudaStream_t stream) {
  const int Tp = (T_len + kBK - 1) / kBK * kBK;
  const int smem = Smem<D>::bytes(Tp);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + kRows - 1) / kRows, H, B);
  attention_kernel<D, DROP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), lse, T_len, H, Tp, scale, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   float* lse, int B, int T_len, int H, float scale, vg::Dropout drop,
                   cudaStream_t stream) {
  return drop.on ? launch<D, true>(q, k, v, bias, out, lse, B, T_len, H, scale, drop, stream)
                 : launch<D, false>(q, k, v, bias, out, lse, B, T_len, H, scale, drop, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16, D = 64, on wgmma (the flagship's body).
//
// What limited the WMMA body at this shape: 32 query rows a block, four
// 16x16x16 mma a warp between two block barriers per key tile, and the scores
// and probabilities making a round trip through 65 KB of shared memory as
// fp32 (3.5% of the tensor peak). Bound: 12.9 GFLOP at B=16, H=12, T=512 is
// 13 us at 989 TFLOP/s; 50 MB of q, k, v, out is 15 us at 3.35 TB/s.
//
// Design: one warpgroup (128 threads) a block owns 64 query rows of one
// head. Q and, in a two-stage cp.async ring, 64-key K and V tiles live in
// shared memory in the 128-byte-swizzled layout (wgmma.cuh). Per key tile:
// S = Q K^T by four wgmma m64n64k16 straight into registers; scale, bias and
// an online softmax (running row max m and sum l, both in the exp2 domain) in
// registers; dropout by the stateless hash of the element's (row, col); the
// probabilities rounded to bf16 in registers, where the accumulator's layout
// is the A operand's; O += P V by four more wgmma with V read MN-major from
// the same row-major tile. O stays in registers until the end, is scaled by
// keep_scale / l, and leaves through the Q tile's shared memory as whole
// 128-byte rows. One block barrier a key tile; no score, probability or
// output sum ever touches shared memory. The probabilities are rounded
// before the division by l (the twin rounds after): within the check's two
// bf16 ulps. lse = (m + log2 l) ln 2 is written when asked for.
//
// Resources (ptxas -v, kept in the build's flash_attention.cu.log; no
// spills): 43 KB of dynamic shared memory (Q 8 KB, 2 x (K + V) 32 KB, bias
// 2 KB, 1 KB to align) and 114 registers a thread (128 with dropout), so four
// blocks share an SM and one block's softmax overlaps another's products; the
// grid at the flagship is 8 x 12 x 16 = 1536 blocks, 2.9 waves of 4 x 132.
// Measured there (H100, 700 W): 0.052 ms, 250 TFLOP/s, 0.077 ms with dropout
// (twelve integer operations an element for the hash). Two or four
// warpgroups a block sharing the K and V tiles were no faster: the loads are
// not the limit, the serial chain products - softmax - products inside a
// warpgroup is.

namespace hopper {

using bf16 = __nv_bfloat16;
using namespace vg::gmma;
constexpr int kWgThreads = 128;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
constexpr int kSmemBytes = 1024 + kTileBytes * (1 + 2 * kStages) + 512 * 4;

template <bool DROP>
__global__ void __launch_bounds__(kWgThreads, 4)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ out, float* __restrict__ lse, int T_len, int H, float scale,
                 vg::Dropout drop) {
  extern __shared__ unsigned char smem_hopper[];
  unsigned char* Qs = align1024(smem_hopper);
  unsigned char* KVs = Qs + kTileBytes;  // [stage][K tile, V tile]
  float* bias2 = reinterpret_cast<float*>(KVs + 2 * kStages * kTileBytes);  // bias * log2(e)

  const int q0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * 64;
  const size_t head = (size_t)b * T_len * HD + (size_t)h * 64;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const int n_tiles = (T_len + kTileRows - 1) / kTileRows;
  const int lane = threadIdx.x & 31, quad = lane & 3;
  // this thread's rows: row0, row0 + 8
  const int row0 = q0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  drop.load();
  drop.seed += (uint32_t)(b * H + h);
  const uint32_t drop_ld = (uint32_t)vg::round_up128(T_len);

  auto prefetch = [&](int it) {
    unsigned char* stage = KVs + (it % kStages) * 2 * kTileBytes;
    load_swizzled<kWgThreads>(stage, kh, it * kTileRows, T_len, HD);
    load_swizzled<kWgThreads>(stage + kTileBytes, vh, it * kTileRows, T_len, HD);
  };
  load_swizzled<kWgThreads>(Qs, q + head, q0, T_len, HD);
  prefetch(0);
  vg::cp_async_commit();
  for (int i = threadIdx.x; i < n_tiles * kTileRows; i += kWgThreads)
    bias2[i] = (i < T_len ? bias[(size_t)b * T_len + i] : kMaskBias) * kLog2e;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};  // -inf
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  const float c = scale * kLog2e;
  const uint64_t desc_q = descriptor(Qs);

  for (int it = 0; it < n_tiles; ++it) {
    vg::cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();  // tile `it` has landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles) prefetch(it + 1);
    vg::cp_async_commit();
    const unsigned char* Ks = KVs + (it % kStages) * 2 * kTileBytes;

    float s[32];
    mma_fence();
    product_ss(s, desc_q, descriptor(Ks));
    mma_commit();
    mma_wait<0>();
    fence_regs(s);

    // x = s * scale + bias in the exp2 domain; running max
    const float* bt = bias2 + it * kTileRows + 2 * quad;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * j);
      s[4 * j + 0] = fmaf(s[4 * j + 0], c, bb.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], c, bb.y);
      s[4 * j + 2] = fmaf(s[4 * j + 2], c, bb.x);
      s[4 * j + 3] = fmaf(s[4 * j + 3], c, bb.y);
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j + 0], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = quad_max(mx[hh]);
      alpha[hh] = exp2_approx(m[hh] - mx[hh]);  // 0 on the first tile
      m[hh] = mx[hh];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      float p = exp2_approx(s[i] - m[hh]);
      sum[hh] += p;
      if (DROP) {
        const uint32_t col = (uint32_t)(it * kTileRows + 8 * (i >> 2) + 2 * quad + (i & 1));
        if (!drop.keep((uint32_t)(row0 + 8 * hh) * drop_ld + col)) p = 0.f;
      }
      s[i] = p;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + sum[hh];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

    uint32_t a[4][4];
    to_operand(a, s);
    mma_fence();
    product_rs_acc(o, a, descriptor(Ks + kTileBytes));
    mma_commit();
    mma_wait<0>();
    fence_regs(o);
  }

  float factor[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = quad_sum(l[hh]);
    factor[hh] = drop.scale / l[hh];
    const int row = row0 + 8 * hh;
    if (lse != nullptr && quad == 0 && row < T_len)
      lse[(size_t)(b * H + h) * T_len + row] = (m[hh] + log2f(l[hh])) * kLn2;
  }
  __syncthreads();  // every warp's products have read the Q tile
  store_tile(Qs, o, factor, out + head, q0, T_len, HD);
}

template <bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   float* lse, int B, int T_len, int H, float scale, vg::Dropout drop,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + kTileRows - 1) / kTileRows, H, B);
  attention_kernel<DROP><<<grid, kWgThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), lse, T_len, H, scale, drop);
  return cudaGetLastError();
}

}  // namespace hopper

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, const float* bias,
                          void* out, float* lse, int B, int T_len, int H, int D, float scale,
                          vg::Dropout drop, cudaStream_t st) {
  switch (D) {
    case 32: return tc::launch<32>(q, k, v, bias, out, lse, B, T_len, H, scale, drop, st);
    case 64:
      return drop.on
                 ? hopper::launch<true>(q, k, v, bias, out, lse, B, T_len, H, scale, drop, st)
                 : hopper::launch<false>(q, k, v, bias, out, lse, B, T_len, H, scale, drop, st);
    case 128: return tc::launch<128>(q, k, v, bias, out, lse, B, T_len, H, scale, drop, st);
    default:
      return dispatch<__nv_bfloat16>(q, k, v, bias, out, lse, B, T_len, H, D, scale, drop, st);
  }
}

}  // namespace

// q, k, v, out: [B, T, H*D] contiguous, dtype 0 = fp32, 1 = bf16;
// bias: [B, T] fp32 additive key bias. T <= 512, D <= 128. Dropout of the
// probabilities when dropout != 0: element (row, col) of head (b, h) is kept
// where splitmix32(row * round_up(T, 128) + col, seed + b * H + h) >=
// threshold, and kept values are scaled by keep_scale = 1 / (1 - rate),
// after the normalisation and before p is rounded to the storage dtype;
// seed: a device pointer to the int32 seed, read by the kernel (unused when
// dropout == 0).
// lse: [B, H, T] fp32, written with max + log(sum) of each row's biased
// scores, or null when no gradient will be taken.
extern "C" int vg_flash_attention(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, void* lse, int B, int T_len,
                                  int H, int D, float scale, int dtype, int dropout,
                                  const void* seed, unsigned threshold, float keep_scale,
                                  void* stream) {
  if (T_len < 1 || T_len > 512) return cudaErrorInvalidValue;
  const float* bs = static_cast<const float*>(bias);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const vg::Dropout drop{dropout, static_cast<const uint32_t*>(seed), threshold, keep_scale,
                         0u};
  if (dtype == 0) return dispatch<float>(q, k, v, bs, out, ls, B, T_len, H, D, scale, drop, st);
  if (dtype == 1) return dispatch_bf16(q, k, v, bs, out, ls, B, T_len, H, D, scale, drop, st);
  return cudaErrorInvalidValue;
}
