// Hopper building blocks of the attention kernels (sm_90a only): 64-row bf16
// tiles in shared memory in the 128-byte-swizzled layout that wgmma reads,
// filled by cp.async; shared-memory matrix descriptors; and the warpgroup
// product m64n64k16 (bf16 x bf16 -> fp32) with A from shared memory or from
// registers and B from shared memory, K-major or MN-major.
//
// A tile is [rows][64] bf16: one row is 128 bytes, exactly one swizzle atom
// wide, and the 16-byte chunk c of row r lives at chunk c ^ (r % 8). Tile
// bases are 1024-byte aligned (eight rows). One such tile serves a product
// either way round:
//   K-major  (rows are M or N, the 64 columns are the reduction): advance
//            the descriptor by 32 bytes for each k16 step;
//   MN-major (rows are the reduction, the 64 columns are N; the transpose
//            bit of the instruction): advance by 16 rows = 2048 bytes.
// In both the stride between 8-row groups (SBO) is 1024 bytes and the
// leading offset is not used (one atom in that direction).
//
// Accumulator layout of m64n64 (fp32 d[32]) for thread t of the warpgroup,
// w = t / 32, l = t % 32: d[4 j + 2 h + c] is row 16 w + l / 4 + 8 h, column
// 8 j + 2 (l % 4) + c. The A operand in registers (m64k16, four 32-bit
// registers of two bf16) has the same shape, so accumulator columns
// 16 kb .. 16 kb + 15 become the A registers of k16 step kb:
//   a0 = (d[8kb], d[8kb+1]), a1 = (d[8kb+2], d[8kb+3]),
//   a2 = (d[8kb+4], d[8kb+5]), a3 = (d[8kb+6], d[8kb+7]).
#pragma once

#include "common.cuh"

namespace vg {
namespace gmma {

constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * 128;  // [64][64] bf16
constexpr uint64_t kStepK = 32 >> 4;         // descriptor step of a k16 slice, K-major
constexpr uint64_t kStepMN = 2048 >> 4;      // descriptor step of a k16 slice, MN-major

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a swizzled tile, c a multiple of 8 for a
// 16-byte chunk.
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// 16-byte cp.async that writes zeros when !valid (src-size 0).
__device__ __forceinline__ void cp_async16_zfill(uint32_t smem, const void* gmem, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem), "r"(n));
}

// Rows t0 .. t0+63 of one head ([.., H*64] packed, `head` points at row 0 of
// the head's 64 columns) into a swizzled tile; rows past T_len become zeros.
// NT threads cooperate.
template <int NT>
__device__ __forceinline__ void load_swizzled(unsigned char* tile, const __nv_bfloat16* head,
                                          int t0, int T_len, int HD) {
  const uint32_t base = smem_u32(tile);
#pragma unroll
  for (int i = threadIdx.x; i < kTileRows * 8; i += NT) {
    const int r = i >> 3, c = i & 7, t = t0 + r;
    const bool valid = t < T_len;
    const __nv_bfloat16* src = head + (size_t)(valid ? t : 0) * HD + c * 8;
    cp_async16_zfill(base + r * 128 + ((c ^ (r & 7)) << 4), src, valid);
  }
}

// Makes shared-memory writes of this thread (cp.async that has completed,
// plain stores) visible to the asynchronous proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a swizzled tile (or of a k16 slice of it, by adding kStepK
// or kStepMN multiples): start address, LBO 1 (unused), SBO 1024 bytes,
// 128-byte swizzle.
__device__ __forceinline__ uint64_t descriptor(const void* tile) {
  uint64_t d = (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void mma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator between the asynchronous products and the plain code
// around them: the compiler may not move reads or writes of d across it.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VG_ACC32(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])
#define VG_ACC32_REGS                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory. A is
// K-major; B is K-major (TRANS_B = 0) or MN-major (TRANS_B = 1). The
// accumulator is overwritten when `accumulate` is 0.
template <int TRANS_B>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VG_ACC32_REGS
      ", %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : VG_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// The same with A in registers (four registers of two bf16, layout above).
template <int TRANS_B>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VG_ACC32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : VG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TRANS_B));
}

#undef VG_ACC32
#undef VG_ACC32_REGS

// d = A B over the tiles' 64-deep reduction: four k16 steps, A and B both
// K-major tiles in shared memory (scores: rows x rows over the head width).
__device__ __forceinline__ void product_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_ss<0>(d, desc_a + kk * kStepK, desc_b + kk * kStepK, kk > 0);
}

// d += A B with A [64 x 64] in registers (a[kb] is k16 step kb) and B an
// MN-major tile: the tile's rows are the reduction.
__device__ __forceinline__ void product_rs_acc(float (&d)[32], const uint32_t (&a)[4][4],
                                               uint64_t desc_b) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) mma_rs<1>(d, a[kb], desc_b + kb * kStepMN, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An accumulator tile as the A operand of the next product, rounded to bf16.
__device__ __forceinline__ void to_operand(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kb][i] = pack_bf16(d[8 * kb + 2 * i], d[8 * kb + 2 * i + 1]);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Sum / max over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A finished [64 x 64] accumulator (times `factor`) to `dst` rows t0.. of a
// packed [T, H*64] bf16 tensor, through the swizzled tile `stage`: each warp
// writes its own 16 rows as bf16 and copies them out as whole 128-byte rows.
// The caller makes sure nothing else still reads `stage`.
__device__ __forceinline__ void store_tile(unsigned char* stage, const float (&d)[32],
                                           const float (&factor)[2], __nv_bfloat16* head,
                                           int t0, int T_len, int HD) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * w + (lane >> 2) + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(stage + swizzled(r, 8 * j + 2 * (lane & 3))) =
          pack_bf16(d[4 * j + 2 * h] * factor[h], d[4 * j + 2 * h + 1] * factor[h]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i, r = 16 * w + (idx >> 3), c = idx & 7;
    if (t0 + r < T_len)
      *reinterpret_cast<uint4*>(head + (size_t)(t0 + r) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * 128 + ((c ^ (r & 7)) << 4));
  }
}

// The 1024-byte aligned start of a dynamic shared-memory buffer that was
// allocated with 1024 spare bytes.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

}  // namespace gmma
}  // namespace vg
