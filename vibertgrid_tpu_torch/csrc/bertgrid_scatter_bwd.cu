// Backward of the BERTgrid scatter: d_emb[b, s] = sum of d_out[b, cell] over
// the grid cells that segment s won (the highest-indexed valid box covering
// a cell wins it), accumulated in fp32 and cast once.
//
// Replaces: vibertgrid_tpu/ops/pallas_scatter.py::_bwd_kernel. The TPU kernel
// rebuilt each row tile's one-hot winner matrix and accumulated
// onehot^T d_out into one [S+1, D] block across its sequential grid. GPU
// blocks run in no order and share nothing, and a block per segment leaves
// one SM to sum a box that wins most of a page, so the work is split by the
// data instead, in two launches:
//
// 1. Cells (one block of 1024 threads per image). Each valid box's clipped
//    cells are enumerated through a prefix sum of the boxes' areas, so every
//    thread paints about the same number of (box, cell) pairs, with
//    atomicMax(winner, s + 1) in shared memory (integer, so the map is the
//    same whatever the order). A stable counting sort then lists the cells by
//    winner: warp w counts the keys of its own contiguous run of cells (key
//    s for a cell won by s, S for a cell nobody won; __match_any_sync groups
//    equal keys), a scan over warps and keys gives each (warp, key) its
//    place, and a second walk writes the cells. offsets [B, S + 2] and cells
//    [B, H*W] come out: segment s's cells are cells[offsets[s] ..
//    offsets[s + 1]), ascending, and the cells nobody won fill the tail from
//    offsets[S] to offsets[S + 1] = H*W (ops/grid_scatter.py::winner_cells is
//    the plain version, and the two agree bit for bit). The launch also
//    writes zeros to the rows of segments that won nothing and resets the
//    arrival counters of launch 2.
// 2. Sums (one block per piece of kPiece = 32 consecutive won cells of an
//    image's list, its warps each taking 256 columns, so a page-wide segment
//    is spread over H*W / 32 blocks and no block reads more than one piece).
//    The pieces are numbered across the batch, so the blocks past the last
//    one sit at the grid's end and leave at once. The launch is a
//    programmatic dependent of launch 1: its blocks are placed while launch 1
//    runs and wait for its results. A block loads its piece's cells beside
//    the image's offsets, then walks the piece in list order, every row read
//    once with 16-byte loads coalesced along D, eight rows in flight a lane,
//    and sums each run of one segment in fp32 from 0. A segment that lies
//    inside the piece is written out as it stands. One that crosses the
//    piece's edge (the piece's first or last run) leaves its partial in
//    scratch, [B, pieces, 2, D] fp32; after __threadfence the block adds one
//    to the segment's arrival counter, and the block that arrives last adds
//    the segment's partials in piece order (eight loads in flight) and
//    writes the row. The sum is the same whichever block finishes first, so
//    two runs give the same bits, with no float atomics
//    (ops/grid_scatter.py::scatter_backward_pieces adds in the same order and
//    agrees bit for bit).
//
// Bound on this card: bytes. Every won cell's row is read once and d_emb
// written once: at the flagship batch (B=16, 64x48 cells, D=768, bf16, about
// 350 won cells an image) 8.6 MB + 3.1 MB, 3.5 us at 3.35 TB/s; on a batch
// whose every page is won (a page-wide box) 75.5 MB + 3.1 MB, 23 us.
//
// Measured (H100 80GB HBM3, 700 W; PERF.md has the runs): 0.062 ms a call on
// the page-wide batch, where one block per segment took 0.63, and 0.022 ms on
// the flagship batch, where it took 0.054. On the flagship batch the time is
// latency: launch 1's chain of barriers and scans on one SM an image, the
// wait for its results, then four dependent batches of row loads a block.
// Variants that prefetched the rows into L2, kept 16 or 32 rows in flight
// (fewer blocks an SM) or 16 partials in the combine were no faster.

#include "common.cuh"

namespace {

constexpr int kCellThreads = 1024;
constexpr int kCellWarps = kCellThreads / 32;
constexpr int kPiece = 32;               // cells a block of launch 2 sums: one a lane
constexpr int kLaneCols = 8;             // columns a lane owns
constexpr int kWarpCols = 32 * kLaneCols;
constexpr int kMaxSumWarps = 8;          // a block of launch 2: up to 2048 columns a pass
constexpr int kCombineInFlight = 8;      // partials a lane loads before it adds them

// Largest i in [lo, hi) with a[i] <= v, for a[lo] <= v (a non-decreasing).
__device__ __forceinline__ int last_at_most(const int* a, int lo, int hi, int v) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid; else hi = mid;
  }
  return lo;
}

// Exclusive prefix sum of in[0 .. n) into out[0 .. n] (out[n] the total) by
// one warp, 32 values a step; in and out may be the same array shifted by one.
__device__ __forceinline__ void warp_scan(const int* in, int* out, int n) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int v = i0 + lane < n ? in[i0 + lane] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    __syncwarp();  // every lane has read in[] before any writes out[]
    if (i0 + lane < n) out[i0 + lane] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
    __syncwarp();
  }
  if (lane == 0) out[n] = carry;
  __syncwarp();
}

// ---------------------------------------------------------------- launch 1

template <typename T>
__global__ void __launch_bounds__(kCellThreads)
scatter_bwd_cells_kernel(const int* __restrict__ boxes, const int* __restrict__ mask,
                         int* __restrict__ cells, int* __restrict__ offsets,
                         T* __restrict__ d_emb, int* __restrict__ counters, int S, int D,
                         int height, int width, int stride) {
  // Shared: x0, y0, box width [3][S] (cells, clipped); area prefix [S + 1];
  // winner [H*W]; per-warp key counts [kCellWarps][S + 1]; offsets [S + 2].
  extern __shared__ int sm[];
  int* bx0 = sm;
  int* by0 = bx0 + S;
  int* bw = by0 + S;
  int* area = bw + S;
  int* win = area + S + 1;
  const int n = height * width, keys = S + 1;
  int* cnt = win + n;
  int* offs = cnt + kCellWarps * keys;
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // launch 2 may be scheduled now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  for (int s = tid; s < S; s += kCellThreads) {
    const int* bxp = boxes + ((size_t)b * S + s) * 4;
    const int x0 = max(vg::floor_div(bxp[0], stride), 0);
    const int y0 = max(vg::floor_div(bxp[1], stride), 0);
    const int x1 = min(vg::floor_div(bxp[2], stride), width);
    const int y1 = min(vg::floor_div(bxp[3], stride), height);
    const bool live = mask[(size_t)b * S + s] != 0 && x1 > x0 && y1 > y0;
    bx0[s] = x0;
    by0[s] = y0;
    bw[s] = x1 - x0;
    area[s] = live ? (x1 - x0) * (y1 - y0) : 0;
    counters[(size_t)b * S + s] = 0;
  }
  for (int i = tid; i < n; i += kCellThreads) win[i] = 0;
  for (int i = tid; i < kCellWarps * keys; i += kCellThreads) cnt[i] = 0;
  __syncthreads();
  if (warp == 0) warp_scan(area, area, S);
  __syncthreads();

  // Paint: pair k of the boxes' cells, enumerated box after box.
  const int pairs = area[S];
  for (int k = tid; k < pairs; k += kCellThreads) {
    const int s = last_at_most(area, 0, S, k), i = k - area[s];
    atomicMax(&win[(by0[s] + i / bw[s]) * width + bx0[s] + i % bw[s]], s + 1);
  }
  __syncthreads();

  // Count the keys of this warp's run of cells, 32 at a time.
  const int run = (n + kCellWarps * 32 - 1) / (kCellWarps * 32) * 32;
  const int lo = warp * run, hi = min(n, lo + run);
  int* my_cnt = cnt + warp * keys;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int c = c0 + lane;
    const int key = c < hi ? (win[c] > 0 ? win[c] - 1 : S) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) my_cnt[key] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Each (warp, key) count becomes the number of that key's cells in the
  // warps before (a scan across lane = warp); offs[key + 1] holds the key's
  // total for the scan over keys.
  static_assert(kCellWarps <= 32, "one lane a warp");
  for (int key = warp; key < keys; key += kCellWarps) {
    const int c = lane < kCellWarps ? cnt[lane * keys + key] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane < kCellWarps) cnt[lane * keys + key] = incl - c;
    if (lane == 31) offs[key + 1] = incl;
  }
  __syncthreads();
  if (warp == 0) warp_scan(offs + 1, offs, keys);
  __syncthreads();
  for (int i = tid; i < keys + 1; i += kCellThreads) offsets[(size_t)b * (keys + 1) + i] = offs[i];

  // Place: the same walk, each cell after the earlier cells of its key.
  int* my_cells = cells + (size_t)b * n;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int c = c0 + lane;
    const int key = c < hi ? (win[c] > 0 ? win[c] - 1 : S) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0) {
      const int rank = __popc(peers & ((1u << lane) - 1));
      my_cells[offs[key] + my_cnt[key] + rank] = c;
    }
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) my_cnt[key] += __popc(peers);
    __syncwarp();
  }

  // Zeros for the segments that won nothing (masked, covered, off the grid).
  for (int s = warp; s < S; s += kCellWarps) {
    if (offs[s + 1] != offs[s]) continue;
    T* row = d_emb + ((size_t)b * S + s) * D;
    for (int d = lane; d < D; d += 32) row[d] = vg::from_f32<T>(0.f);
  }
}

// ---------------------------------------------------------------- launch 2

// Eight consecutive values of a row as loaded: `vec` says the 16-byte path
// is aligned and in range, else columns past D read as 0.
struct Row8Bf16 {
  uint4 raw;
};
struct Row8F32 {
  float4 lo, hi;
};
template <typename T> struct Row8Of;
template <> struct Row8Of<__nv_bfloat16> { using type = Row8Bf16; };
template <> struct Row8Of<float> { using type = Row8F32; };

__device__ __forceinline__ Row8Bf16 load8(const __nv_bfloat16* p, int left, bool vec) {
  Row8Bf16 r;
  if (vec) {
    r.raw = *reinterpret_cast<const uint4*>(p);
  } else {
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&r.raw);
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) h[e] = e < left ? p[e] : __float2bfloat16_rn(0.f);
  }
  return r;
}
__device__ __forceinline__ Row8F32 load8(const float* p, int left, bool vec) {
  Row8F32 r;
  if (vec) {
    r.lo = reinterpret_cast<const float4*>(p)[0];
    r.hi = reinterpret_cast<const float4*>(p)[1];
  } else {
    float* f = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) f[e] = e < left ? p[e] : 0.f;
  }
  return r;
}
__device__ __forceinline__ void add8(float (&acc)[kLaneCols], const Row8Bf16& r) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    acc[2 * e] += f.x;
    acc[2 * e + 1] += f.y;
  }
}
__device__ __forceinline__ void add8(float (&acc)[kLaneCols], const Row8F32& r) {
  acc[0] += r.lo.x, acc[1] += r.lo.y, acc[2] += r.lo.z, acc[3] += r.lo.w;
  acc[4] += r.hi.x, acc[5] += r.hi.y, acc[6] += r.hi.z, acc[7] += r.hi.w;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[kLaneCols], int left, bool vec) {
  if (vec) {
    if constexpr (sizeof(T) == 2) {
      uint4 raw;
      uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
      reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e)
      if (e < left) p[e] = vg::from_f32<T>(v[e]);
  }
}

// A partial written by another block: read through L2, not this SM's L1.
__device__ __forceinline__ void load_partial(float (&v)[kLaneCols], const float* p, int left,
                                             bool vec) {
  if (vec) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
    const float4 c = __ldcg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = c.x, v[5] = c.y, v[6] = c.z,
    v[7] = c.w;
  } else {
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) v[e] = e < left ? __ldcg(p + e) : 0.f;
  }
}

// Piece `piece` of image b: the walk, then the crossing runs. Every thread of
// the block calls it (block barriers inside); offs holds image b's offsets
// and my_cell the cell at list position piece * kPiece + lane.
template <typename T>
__device__ __forceinline__ void sum_piece(const T* __restrict__ d_out, const int* offs,
                                          int my_cell, T* __restrict__ d_emb,
                                          float* __restrict__ partials, int* __restrict__ counters,
                                          int* finish, int b, int piece, int S, int D, int n,
                                          int pieces) {
  constexpr int kInFlight = 8;  // rows a lane loads before it adds them
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int start = piece * kPiece, count = min(kPiece, offs[S] - start), end = start + count;
  const T* grid = d_out + (size_t)b * n * D;
  int my_seg = 0;
  if (lane < count) my_seg = last_at_most(offs, 0, S, start + lane);
  else my_cell = 0;
  const int first = __shfl_sync(0xffffffffu, my_seg, 0);
  const int last = __shfl_sync(0xffffffffu, my_seg, count - 1);
  const auto crosses = [&](int s) { return offs[s] < start || offs[s + 1] > end; };
  // A crossing run's partial: slot 0 for the piece's first run, 1 for its last.
  float* piece_part = partials + ((size_t)b * pieces + piece) * 2 * D;

  const bool aligned = D % kLaneCols == 0;
  for (int c0 = warp * kWarpCols; c0 < D; c0 += warps * kWarpCols) {
    const int col = c0 + lane * kLaneCols, left = D - col;
    const bool vec = aligned && left >= kLaneCols;
    const auto flush = [&](int s, const float (&acc)[kLaneCols]) {
      if (left <= 0) return;
      if (!crosses(s))
        store8(d_emb + ((size_t)b * S + s) * D + col, acc, left, vec);
      else
        store8(piece_part + (s == first ? 0 : D) + col, acc, left, vec);
    };
    float acc[kLaneCols] = {};
    int cur = first;
    for (int i0 = 0; i0 < count; i0 += kInFlight) {
      typename Row8Of<T>::type rows[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int cell = __shfl_sync(0xffffffffu, my_cell, (i0 + u) & 31);
        if (i0 + u < count && left > 0) rows[u] = load8(grid + (size_t)cell * D + col, left, vec);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (i0 + u >= count) break;  // the same for the whole warp
        const int s = __shfl_sync(0xffffffffu, my_seg, (i0 + u) & 31);
        if (s != cur) {
          flush(cur, acc);
#pragma unroll
          for (int e = 0; e < kLaneCols; ++e) acc[e] = 0.f;
          cur = s;
        }
        if (left > 0) add8(acc, rows[u]);
      }
    }
    flush(cur, acc);
  }

  // The crossing runs: the last block to leave its partial adds them all up.
  if (!crosses(first) && !crosses(last)) return;  // the whole block
  __threadfence();
  __syncthreads();  // every partial of this piece is out; `finish` is free
  if (threadIdx.x < 2) {
    const int s = threadIdx.x == 0 ? first : last;
    bool mine = crosses(s) && (threadIdx.x == 0 || last != first);
    if (mine) {
      const int pieces_of_s = (offs[s + 1] - 1) / kPiece - offs[s] / kPiece + 1;
      mine = atomicAdd(&counters[(size_t)b * S + s], 1) == pieces_of_s - 1;
    }
    finish[threadIdx.x] = mine;
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k) {
    if (!finish[k]) continue;
    __threadfence();
    const int s = k == 0 ? first : last;
    const int j0 = offs[s] / kPiece, j1 = (offs[s + 1] - 1) / kPiece;
    // the segment's first piece holds it in slot 0 where the segment starts it
    const int slot0 = offs[s] == j0 * kPiece ? 0 : 1;
    for (int c0 = warp * kWarpCols; c0 < D; c0 += warps * kWarpCols) {
      const int col = c0 + lane * kLaneCols, left = D - col;
      if (left <= 0) continue;
      const bool vec = aligned && left >= kLaneCols;
      float acc[kLaneCols] = {};
      for (int j_0 = j0; j_0 <= j1; j_0 += kCombineInFlight) {
        float v[kCombineInFlight][kLaneCols];
#pragma unroll
        for (int u = 0; u < kCombineInFlight; ++u) {
          const int j = j_0 + u, slot = j == j0 ? slot0 : 0;
          if (j <= j1)
            load_partial(v[u], partials + (((size_t)b * pieces + j) * 2 + slot) * D + col, left,
                         vec);
        }
#pragma unroll
        for (int u = 0; u < kCombineInFlight; ++u)
          if (j_0 + u <= j1)
#pragma unroll
            for (int e = 0; e < kLaneCols; ++e) acc[e] += v[u][e];
      }
      store8(d_emb + ((size_t)b * S + s) * D + col, acc, left, vec);
    }
  }
}

// One block per piece. The batch's pieces are numbered image after image
// (image b's are first[b] .. first[b + 1]), so the blocks with work come
// first in the grid and those past the batch's last piece, at its end, leave
// at once; no block is spent on an image's empty tail in the middle.
template <typename T>
__global__ void __launch_bounds__(kMaxSumWarps * 32)
scatter_bwd_sum_kernel(const T* __restrict__ d_out, const int* __restrict__ cells,
                       const int* __restrict__ offsets, T* __restrict__ d_emb,
                       float* __restrict__ partials, int* __restrict__ counters, int B, int S,
                       int D, int n, int pieces) {
  extern __shared__ int sm2[];
  int* offs = sm2;            // [S + 1]: the image's segment starts, won cells last
  int* first = offs + S + 1;  // [B + 1]: the images' first pieces in the batch's count
  __shared__ int finish[2];   // this block adds up the first / last run's segment
  // launch 1 may still run until here (programmatic dependent launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int i = threadIdx.x; i < B; i += blockDim.x)
    first[i + 1] = (offsets[(size_t)i * (S + 2) + S] + kPiece - 1) / kPiece;
  __syncthreads();
  if (threadIdx.x < 32) warp_scan(first + 1, first, B);
  __syncthreads();
  const int item = blockIdx.x;
  if (item >= first[B]) return;  // the whole block
  const int b = last_at_most(first, 0, B, item), piece = item - first[b];
  // the piece's cells (the list has n entries; those past the won cells are
  // not used) beside the image's offsets
  const int pos = piece * kPiece + (threadIdx.x & 31);
  const int my_cell = pos < n ? cells[(size_t)b * n + pos] : 0;
  for (int i = threadIdx.x; i <= S; i += blockDim.x) offs[i] = offsets[(size_t)b * (S + 2) + i];
  __syncthreads();
  sum_piece(d_out, offs, my_cell, d_emb, partials, counters, finish, b, piece, S, D, n, pieces);
}

template <typename T>
cudaError_t launch(const void* d_out, const int* boxes, const int* mask, void* d_emb,
                   int* cells, int* offsets, float* partials, int* counters, int B, int S, int D,
                   int height, int width, int stride, cudaStream_t stream) {
  const int n = height * width, pieces = (n + kPiece - 1) / kPiece;
  const size_t cell_smem =
      ((size_t)4 * S + 1 + n + (size_t)kCellWarps * (S + 1) + S + 2) * sizeof(int);
  cudaError_t err;
  if (cell_smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(scatter_bwd_cells_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)cell_smem)) != cudaSuccess)
    return err;
  scatter_bwd_cells_kernel<T><<<B, kCellThreads, cell_smem, stream>>>(
      boxes, mask, cells, offsets, static_cast<T*>(d_emb), counters, S, D, height, width, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int threads = 32 * min(kMaxSumWarps, (D + kWarpCols - 1) / kWarpCols);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * pieces);  // every piece the batch could have
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)(S + 1 + B + 1) * sizeof(int);
  cfg.stream = stream;
  // it may start while launch 1 finishes; it waits for launch 1's results
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, scatter_bwd_sum_kernel<T>, static_cast<const T*>(d_out),
                                static_cast<const int*>(cells), static_cast<const int*>(offsets),
                                static_cast<T*>(d_emb), partials, counters, B, S, D, n,
                                pieces)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace

// d_out [B, height, width, D], boxes [B, S, 4] int32 in image pixels, mask
// [B, S] int32, d_emb [B, S, D]; dtype 0 = fp32, 1 = bf16. Scratch, all
// written before it is read: cells [B, height * width] and offsets [B, S + 2]
// int32 (launch 1's list, see above), partials [B, ceil(height * width /
// piece), 2, D] fp32 and counters [B, S] int32. piece must be the kernel's
// own piece size, 32 (the caller sizes the partials by it).
extern "C" int vg_bertgrid_scatter_bwd(const void* d_out, const void* boxes, const void* mask,
                                       void* d_emb, void* cells, void* offsets, void* partials,
                                       void* counters, int B, int S, int D, int height, int width,
                                       int stride, int piece, int dtype, void* stream) {
  if (piece != kPiece || B < 1 || S < 1 || D < 1 || height < 1 || width < 1 || stride < 1)
    return cudaErrorInvalidValue;
  const int* bx = static_cast<const int*>(boxes);
  const int* mk = static_cast<const int*>(mask);
  int* cl = static_cast<int*>(cells);
  int* of = static_cast<int*>(offsets);
  float* pt = static_cast<float*>(partials);
  int* ct = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(d_out, bx, mk, d_emb, cl, of, pt, ct, B, S, D, height, width, stride, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(d_out, bx, mk, d_emb, cl, of, pt, ct, B, S, D, height, width,
                                 stride, st);
  return cudaErrorInvalidValue;
}
