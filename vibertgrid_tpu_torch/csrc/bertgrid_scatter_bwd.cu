// Backward of the BERTgrid scatter: d_emb[b, s] = sum of d_out[b, cell] over
// the grid cells that segment s won (the highest-indexed valid box covering
// a cell wins it), accumulated in fp32 and cast once.
//
// Replaces: vibertgrid_tpu/ops/pallas_scatter.py::_bwd_kernel. The TPU kernel
// rebuilt each row tile's one-hot winner matrix and accumulated
// onehot^T d_out into one [S+1, D] block across its sequential grid; GPU
// blocks run in no order and share nothing, so the sum is turned around:
//
// Design: one block per (image, segment). The block loads the image's boxes
// // stride and mask into shared memory, then walks the segment's own box,
// clipped to the grid. Thread t tests cells t, t + blockDim, ...: a cell
// counts if no valid segment of higher index covers it. Warp 0 compacts the
// verdicts into a list of won cells in box order. Then each warp takes every
// eighth cell of the list, its lanes spanning 256 columns of D at 8 values a
// lane (one 16-byte load for bf16) with four cells' loads in flight, and the
// eight warps' fp32 partial sums are added in warp order through shared
// memory: the result is deterministic and needs no atomics. A masked
// segment, or one that wins no cell, gets zeros.
//
// Bound on this card: bytes. Every cell's row is read at most once (by its
// winner's block): at the flagship (B=16, 64x48 cells, D=768, bf16) up to
// 75.5 MB, 23 us at 3.35 TB/s; the output (3.1 MB) is small beside it. A box
// that wins most of a page is summed by one block alone, which is what
// bounds the kernel on such a page.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneCols = 8;                 // columns a lane owns in a pass
constexpr int kPassCols = 32 * kLaneCols;    // columns a warp covers in a pass

// Eight consecutive values of a row as floats; `vec` says the 16-byte path
// is aligned and in range, else columns past D read as 0.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int left, bool vec, float* v) {
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x, v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) v[e] = e < left ? __bfloat162float(p[e]) : 0.f;
  }
}
__device__ __forceinline__ void load8(const float* p, int left, bool vec, float* v) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) v[e] = e < left ? p[e] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_bwd_kernel(const T* __restrict__ d_out, const int* __restrict__ boxes,
                   const int* __restrict__ mask, T* __restrict__ d_emb, int S, int D,
                   int height, int width, int stride) {
  // [5][S] ints: x0, y0, x1, y1 in cells, valid; [kWarps][kPassCols] floats;
  // [cells] ints: the won cells' offsets; [cells] bytes: the verdicts.
  extern __shared__ int sm[];
  float* partial = reinterpret_cast<float*>(sm + 5 * S);
  int* list = sm + 5 * S + kWarps * kPassCols;
  unsigned char* won = reinterpret_cast<unsigned char*>(list + height * width);
  __shared__ int n_won;
  const int seg = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int* bx = boxes + ((size_t)b * S + s) * 4;
    sm[s] = vg::floor_div(bx[0], stride);
    sm[S + s] = vg::floor_div(bx[1], stride);
    sm[2 * S + s] = vg::floor_div(bx[2], stride);
    sm[3 * S + s] = vg::floor_div(bx[3], stride);
    sm[4 * S + s] = mask[(size_t)b * S + s] != 0;
  }
  __syncthreads();

  const int x0 = max(sm[seg], 0), y0 = max(sm[S + seg], 0);
  const int x1 = min(sm[2 * S + seg], width), y1 = min(sm[3 * S + seg], height);
  const int bw = max(x1 - x0, 0), bh = max(y1 - y0, 0);
  const int n_cells = sm[4 * S + seg] ? bw * bh : 0;
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) {
    const int y = y0 + i / bw, x = x0 + i % bw;
    bool mine = true;
    for (int s = seg + 1; s < S && mine; ++s)
      mine = !(sm[4 * S + s] && y >= sm[S + s] && y < sm[3 * S + s] && x >= sm[s] &&
               x < sm[2 * S + s]);
    won[i] = mine;
  }
  __syncthreads();
  if (warp == 0) {  // ordered compaction of the won cells
    int count = 0;
    for (int i0 = 0; i0 < n_cells; i0 += 32) {
      const int i = i0 + lane;
      const bool mine = i < n_cells && won[i];
      const unsigned ballot = __ballot_sync(0xffffffffu, mine);
      if (mine)
        list[count + __popc(ballot & ((1u << lane) - 1))] = (y0 + i / bw) * width + x0 + i % bw;
      count += __popc(ballot);
    }
    if (lane == 0) n_won = count;
  }
  __syncthreads();
  const int n = n_won;

  const T* grid = d_out + (size_t)b * height * width * D;
  T* dst = d_emb + ((size_t)b * S + seg) * D;
  const bool aligned = D % kLaneCols == 0;
  for (int d0 = 0; d0 < D; d0 += kPassCols) {
    const int d = d0 + lane * kLaneCols, left = D - d;
    const bool vec = aligned && left >= kLaneCols;
    float acc[kLaneCols] = {};
    if (left > 0) {
      int j = warp;
      for (; j + 3 * kWarps < n; j += 4 * kWarps) {  // four cells' loads in flight
        float v[4][kLaneCols];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          load8(grid + (size_t)list[j + u * kWarps] * D + d, left, vec, v[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < kLaneCols; ++e) acc[e] += v[u][e];
      }
      for (; j < n; j += kWarps) {
        float v[kLaneCols];
        load8(grid + (size_t)list[j] * D + d, left, vec, v);
#pragma unroll
        for (int e = 0; e < kLaneCols; ++e) acc[e] += v[e];
      }
    }
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) partial[warp * kPassCols + lane * kLaneCols + e] = acc[e];
    __syncthreads();
    for (int c = threadIdx.x; c < kPassCols && d0 + c < D; c += blockDim.x) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += partial[w * kPassCols + c];
      dst[d0 + c] = vg::from_f32<T>(sum);
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* d_out, const int* boxes, const int* mask, void* d_emb, int B,
                   int S, int D, int height, int width, int stride, cudaStream_t stream) {
  // a box clipped to the grid has at most height * width cells
  const size_t smem = (5 * (size_t)S + kWarps * kPassCols) * sizeof(int) +
                      (size_t)height * width * (sizeof(int) + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scatter_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  scatter_bwd_kernel<T><<<dim3(S, B), kThreads, smem, stream>>>(
      static_cast<const T*>(d_out), boxes, mask, static_cast<T*>(d_emb), S, D, height, width,
      stride);
  return cudaGetLastError();
}

}  // namespace

// d_out [B, height, width, D], boxes [B, S, 4] int32 in image pixels, mask
// [B, S] int32, d_emb [B, S, D]; dtype 0 = fp32, 1 = bf16.
extern "C" int vg_bertgrid_scatter_bwd(const void* d_out, const void* boxes, const void* mask,
                                       void* d_emb, int B, int S, int D, int height, int width,
                                       int stride, int dtype, void* stream) {
  const int* bx = static_cast<const int*>(boxes);
  const int* mk = static_cast<const int*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(d_out, bx, mk, d_emb, B, S, D, height, width, stride, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(d_out, bx, mk, d_emb, B, S, D, height, width, stride, st);
  return cudaErrorInvalidValue;
}
