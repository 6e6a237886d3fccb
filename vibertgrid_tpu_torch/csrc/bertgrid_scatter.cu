// BERTgrid scatter: paint each segment's embedding over its box on the
// stride-s grid, the highest-indexed valid covering box winning.
//
// Replaces: vibertgrid_tpu/ops/pallas_scatter.py::_kernel (forward of
// bertgrid_scatter_pallas). The TPU kernel built a one-hot winner matrix per
// row tile and turned the gather into a one-hot x [0; emb] MXU product.
// Here a warp finds each cell's winner and copies one embedding row, which
// computes the same result exactly (a copy, no arithmetic).
//
// Bound on this card: bytes. The output grid dominates: at the flagship
// (B=16, 64x48 cells, D=768, bf16) it is 75.5 MB written once, about 23 us
// at 3.35 TB/s; the embeddings (3.1 MB) are read from L2 many times.
//
// Design: one launch covers the whole batch, grid = (cell tiles, B). A block
// loads its image's boxes // stride and mask into shared memory (5 ints per
// segment). Each warp owns one cell at a time: lane l tests segments
// l, l+32, ... so the last hit per lane is that lane's largest index, and a
// warp max gives the winner (index + 1, 0 = none). The warp then writes the
// row with 16-byte vector stores where the row width allows it, so every
// store instruction of the warp covers 512 contiguous bytes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCellsPerBlock = 64;

template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const V* __restrict__ emb, const int* __restrict__ boxes,
               const int* __restrict__ mask, V* __restrict__ out, int S,
               int row_units, int height, int width, int stride) {
  extern __shared__ int sm[];  // [5][S]: x0, y0, x1, y1 in cells, valid
  const int b = blockIdx.y;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int* bx = boxes + ((size_t)b * S + s) * 4;
    sm[s] = vg::floor_div(bx[0], stride);
    sm[S + s] = vg::floor_div(bx[1], stride);
    sm[2 * S + s] = vg::floor_div(bx[2], stride);
    sm[3 * S + s] = vg::floor_div(bx[3], stride);
    sm[4 * S + s] = mask[(size_t)b * S + s] != 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cells = height * width;
  const int cell0 = blockIdx.x * kCellsPerBlock;
  const int cell_end = min(cell0 + kCellsPerBlock, cells);
  const V zero = V();
  for (int c = cell0 + warp; c < cell_end; c += kThreads / 32) {
    const int y = c / width, x = c % width;
    int win = 0;
    for (int s = lane; s < S; s += 32) {
      if (sm[4 * S + s] && y >= sm[S + s] && y < sm[3 * S + s] && x >= sm[s] &&
          x < sm[2 * S + s])
        win = s + 1;
    }
    win = vg::warp_max_int(win);
    V* dst = out + ((size_t)b * cells + c) * row_units;
    if (win == 0) {
      for (int u = lane; u < row_units; u += 32) dst[u] = zero;
    } else {
      const V* src = emb + ((size_t)b * S + (win - 1)) * row_units;
      for (int u = lane; u < row_units; u += 32) dst[u] = src[u];
    }
  }
}

template <typename V>
cudaError_t launch(const void* emb, const int* boxes, const int* mask, void* out,
                   int B, int S, int row_bytes, int height, int width, int stride,
                   cudaStream_t stream) {
  const int cells = height * width;
  dim3 grid((cells + kCellsPerBlock - 1) / kCellsPerBlock, B);
  size_t smem = 5 * (size_t)S * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scatter_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  scatter_kernel<V><<<grid, kThreads, smem, stream>>>(
      static_cast<const V*>(emb), boxes, mask, static_cast<V*>(out), S,
      row_bytes / (int)sizeof(V), height, width, stride);
  return cudaGetLastError();
}

}  // namespace

// emb [B, S, D] (row_bytes = D * element size), boxes [B, S, 4] int32 in
// image pixels, mask [B, S] int32, out [B, height, width, D]. The copy unit
// is 16 bytes when row_bytes and both pointers allow it.
extern "C" int vg_bertgrid_scatter(const void* emb, const void* boxes, const void* mask,
                                   void* out, int B, int S, int row_bytes, int height,
                                   int width, int stride, void* stream) {
  const int* bx = static_cast<const int*>(boxes);
  const int* mk = static_cast<const int*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = (uintptr_t)emb | (uintptr_t)out;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(emb, bx, mk, out, B, S, row_bytes, height, width, stride, st);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<uint32_t>(emb, bx, mk, out, B, S, row_bytes, height, width, stride, st);
  return launch<uint16_t>(emb, bx, mk, out, B, S, row_bytes, height, width, stride, st);
}
