// The train step's clip norm and its dual update, each one launch over a
// list of tensors (train/state.py::clip_scale, train/optim.py::DualOptimizer).
// They replace no TPU kernel: the JAX package leaves the update to XLA, which
// fuses it, where the port's library passes went over each tensor up to 16
// times. Both are bound by bytes: the update reads the parameter, gradient
// and state and writes the parameter and state once (20 bytes an AdamW
// element, 16 an SGD one, with bf16 state), the norm reads each gradient
// once; each block streams one chunk with 16-byte accesses.
//
// Both read a descriptor list that ops/fused_update.py builds on the host: one
// row of kRow int64 a contiguous run that a tensor's operands share (their
// addresses there, the run's length, flags and first chunk; a contiguous
// tensor is one run), then one int64 a chunk of kChunk elements, the row it
// belongs to. kChunk is a multiple of 4, so every chunk keeps its run's
// alignment; a row flagged kAligned is read and written with vector
// accesses, and a chunk's last n % 4 elements one at a time.
//
// vg_grad_sq_norm: the sum of the squares of every gradient of the list, each
// square and every sum in fp64. Each of up to kNormBlocks blocks sums its
// chunks, a second launch of one block adds the partial sums in their order:
// the same list gives the same bits on every run.
//
// vg_dual_update: SGD with momentum (the CNN group) and AdamW (the encoder's
// group) in one pass, each element read once and written once. The state is
// read as it is stored (bf16, or fp32) and written back cast once; the
// arithmetic is fp32, the operations of the library passes it replaces in
// their order, each rounded as there: one rounding an operation, and one for
// the pairs the library computes as a fused multiply-add (its `alpha=` and
// `addcmul` forms). Every operation is spelt out as an intrinsic with its
// rounding (__fmul_rn, __fadd_rn, __fmaf_rn, ...), which nvcc never
// contracts or reorders, whatever its flags. The update's scalars are row
// min(*count, last) of the optimizer's table, read on the device, so a
// replayed CUDA graph takes each step's own row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 16384;  // CHUNK in ops/fused_update.py
constexpr int kNormBlocks = 1024;  // NORM_BLOCKS there

enum { kParam, kGrad, kState0, kState1, kNumel, kFlags, kFirstChunk, kRow = 8 };  // ROW there
enum { kAdamW = 1, kStateBf16 = 2, kAligned = 4 };
// columns of the optimizer's table (train/optim.py)
enum { kNegLrCnn, kWdCnn, kNegLrBert, kWdBert, kBc1, kBc2, kInvBc1, kInvBc2, kCols };

struct Chunk {
  const int64_t* row;
  int64_t start, n;  // the chunk's first element in its tensor, and its length
};

__device__ __forceinline__ Chunk chunk_of(const int64_t* desc, int n_rows, int chunk) {
  const int64_t* row = desc + desc[static_cast<int64_t>(n_rows) * kRow + chunk] * kRow;
  const int64_t start = (chunk - row[kFirstChunk]) * kChunk;
  const int64_t left = row[kNumel] - start;
  return {row, start, left < kChunk ? left : kChunk};
}

template <typename T> __device__ __forceinline__ T* pointer(const int64_t* row, int col) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(row[col]));
}

// ---- the norm ----

__device__ __forceinline__ double add_square(double acc, float x) {
  const double d = x;
  return __dadd_rn(acc, __dmul_rn(d, d));  // the square of an fp32 value is exact in fp64
}

// The block's sum, in a fixed order (all threads get it).
__device__ double block_sum(double v) {
  __shared__ double warps[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = v;
  __syncthreads();
  double total = 0.0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total = __dadd_rn(total, warps[w]);
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
grad_sq_norm_kernel(const int64_t* desc, int n_rows, int n_chunks, double* partials) {
  double acc = 0.0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = chunk_of(desc, n_rows, c);
    const float* g = pointer<const float>(ch.row, kGrad) + ch.start;
    int64_t head = 0;
    if (ch.row[kFlags] & kAligned) {
      head = ch.n / 4 * 4;
      const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll 4
      for (int64_t i = threadIdx.x; i < head / 4; i += kThreads) {
        const float4 v = g4[i];
        acc = add_square(add_square(add_square(add_square(acc, v.x), v.y), v.z), v.w);
      }
    }
    for (int64_t i = head + threadIdx.x; i < ch.n; i += kThreads) acc = add_square(acc, g[i]);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const double* partials, int n, double* out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc = __dadd_rn(acc, partials[i]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

// ---- the update ----

struct Scalars {
  float scale;  // the clip's factor, 1 without one
  bool scaled;
  float neg_lr, wd, inv_bc1, inv_bc2;
  float momentum, beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
};

// SGD, the CNN group: _foreach_mul by the clip, g + wd·p (`alpha=`: fused),
// momentum·b then + g, p + (−lr)·b (fused). `b` the momentum buffer in fp32.
__device__ __forceinline__ float sgd(float p, float g, float& b, const Scalars& s) {
  if (s.scaled) g = __fmul_rn(g, s.scale);
  const float gd = __fmaf_rn(s.wd, p, g);
  b = __fadd_rn(__fmul_rn(b, s.momentum), gd);
  return __fmaf_rn(s.neg_lr, b, p);
}

// AdamW, the encoder's group: β1·m then + (1−β1)·g (fused), β2·v then
// + (1−β2)·(g·g) (fused, the square rounded first), (v·inv_bc2), sqrt, + eps,
// (m·inv_bc1) / denom, + wd·p (fused), p + (−lr)·u (fused).
__device__ __forceinline__ float adamw(float p, float g, float& m, float& v, const Scalars& s) {
  if (s.scaled) g = __fmul_rn(g, s.scale);
  m = __fmaf_rn(s.one_minus_beta1, g, __fmul_rn(m, s.beta1));
  v = __fmaf_rn(s.one_minus_beta2, __fmul_rn(g, g), __fmul_rn(v, s.beta2));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps);
  float u = __fdiv_rn(__fmul_rn(m, s.inv_bc1), denom);
  u = __fmaf_rn(s.wd, p, u);
  return __fmaf_rn(s.neg_lr, u, p);
}

__device__ __forceinline__ void load4(const float* src, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float (&v)[4]) {
  union { uint2 u; __nv_bfloat16 h[4]; } t;
  t.u = *reinterpret_cast<const uint2*>(src);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = vg::to_f32(t.h[k]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float (&v)[4]) {
  union { uint2 u; __nv_bfloat16 h[4]; } t;
#pragma unroll
  for (int k = 0; k < 4; ++k) t.h[k] = vg::from_f32<__nv_bfloat16>(v[k]);
  *reinterpret_cast<uint2*>(dst) = t.u;
}

template <bool kAdam, typename S, bool kVector>
__device__ __forceinline__ void update_chunk(const Chunk& ch, const Scalars& s) {
  // four distinct tensors: loads of the next elements may pass the stores
  float* __restrict__ p = pointer<float>(ch.row, kParam) + ch.start;
  const float* __restrict__ g = pointer<const float>(ch.row, kGrad) + ch.start;
  S* __restrict__ m = pointer<S>(ch.row, kState0) + ch.start;
  S* __restrict__ v = kAdam ? pointer<S>(ch.row, kState1) + ch.start : nullptr;
  int64_t head = 0;
  if (kVector) {
    head = ch.n / 4 * 4;
#pragma unroll 2
    for (int64_t i = 4 * static_cast<int64_t>(threadIdx.x); i < head; i += 4 * kThreads) {
      float pv[4], gv[4], mv[4], vv[4];
      load4(p + i, pv);
      load4(g + i, gv);
      load4(m + i, mv);
      if (kAdam) load4(v + i, vv);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        pv[k] = kAdam ? adamw(pv[k], gv[k], mv[k], vv[k], s) : sgd(pv[k], gv[k], mv[k], s);
      store4(p + i, pv);
      store4(m + i, mv);
      if (kAdam) store4(v + i, vv);
    }
  }
  for (int64_t i = head + threadIdx.x; i < ch.n; i += kThreads) {
    float mk = vg::to_f32(m[i]);
    if (kAdam) {
      float vk = vg::to_f32(v[i]);
      p[i] = adamw(p[i], g[i], mk, vk, s);
      v[i] = vg::from_f32<S>(vk);
    } else {
      p[i] = sgd(p[i], g[i], mk, s);
    }
    m[i] = vg::from_f32<S>(mk);
  }
}

template <bool kAdam, typename S>
__device__ __forceinline__ void update_chunk(const Chunk& ch, const Scalars& s) {
  if (ch.row[kFlags] & kAligned)
    update_chunk<kAdam, S, true>(ch, s);
  else
    update_chunk<kAdam, S, false>(ch, s);
}

__global__ void __launch_bounds__(kThreads)
dual_update_kernel(const int64_t* desc, int n_rows, const float* table, const int64_t* count,
                   int last, const float* scale, float momentum, float beta1,
                   float one_minus_beta1, float beta2, float one_minus_beta2, float eps) {
  const Chunk ch = chunk_of(desc, n_rows, blockIdx.x);
  const int64_t flags = ch.row[kFlags];
  const bool adam = flags & kAdamW;
  const int64_t k = *count;
  const float* row = table + (k < last ? k : last) * kCols;
  Scalars s;
  s.scaled = scale != nullptr;
  s.scale = s.scaled ? *scale : 1.0f;
  s.neg_lr = row[adam ? kNegLrBert : kNegLrCnn];
  s.wd = row[adam ? kWdBert : kWdCnn];
  s.inv_bc1 = row[kInvBc1];
  s.inv_bc2 = row[kInvBc2];
  s.momentum = momentum;
  s.beta1 = beta1;
  s.one_minus_beta1 = one_minus_beta1;
  s.beta2 = beta2;
  s.one_minus_beta2 = one_minus_beta2;
  s.eps = eps;
  const bool bf16 = flags & kStateBf16;
  if (adam) {
    if (bf16) update_chunk<true, __nv_bfloat16>(ch, s);
    else update_chunk<true, float>(ch, s);
  } else {
    if (bf16) update_chunk<false, __nv_bfloat16>(ch, s);
    else update_chunk<false, float>(ch, s);
  }
}

}  // namespace

// The sum of squares of the list's gradients into the fp64 scalar `out`;
// `partials` holds kNormBlocks doubles of scratch.
extern "C" int vg_grad_sq_norm(const void* desc, int n_rows, int n_chunks, void* partials,
                               void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = n_chunks < 1 ? 1 : (n_chunks < kNormBlocks ? n_chunks : kNormBlocks);
  double* part = static_cast<double*>(partials);
  grad_sq_norm_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const int64_t*>(desc), n_rows,
                                                   n_chunks, part);
  sum_partials_kernel<<<1, kThreads, 0, st>>>(part, blocks, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One SGD / AdamW update of every tensor of the list. `table`: the
// optimizer's [last + 1, kCols] fp32 table; `count`: its int64 update
// counter; `scale`: the clip's fp32 factor, or null.
extern "C" int vg_dual_update(const void* desc, int n_rows, int n_chunks, const void* table,
                              const void* count, int last, const void* scale, float momentum,
                              float beta1, float one_minus_beta1, float beta2,
                              float one_minus_beta2, float eps, void* stream) {
  if (n_chunks < 1) return 0;
  dual_update_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), n_rows, static_cast<const float*>(table),
      static_cast<const int64_t*>(count), last, static_cast<const float*>(scale), momentum, beta1,
      one_minus_beta1, beta2, one_minus_beta2, eps);
  return static_cast<int>(cudaGetLastError());
}
