// Hopper building blocks of the attention and FFN kernels (sm_90a only):
// bf16 tiles in shared memory in the 128-byte-swizzled layout that wgmma
// reads, filled by cp.async or by the tensor memory accelerator (TMA, with
// mbarriers); shared-memory matrix descriptors; and the warpgroup products
// m64n64k16 (A from shared memory or from registers, B from shared memory,
// K-major or MN-major) and m64n128k16 and m64n256k16 (both from shared
// memory, K-major), bf16 x bf16 -> fp32.
//
// A tile is [rows][64] bf16: one row is 128 bytes, exactly one swizzle atom
// wide, and the 16-byte chunk c of row r lives at chunk c ^ (r % 8). Tile
// bases are 1024-byte aligned (eight rows). TMA with CU_TENSOR_MAP_SWIZZLE_128B
// and a 64-column box writes this same layout. One such tile serves a product
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
// m64n128 (fp32 d[64]) and m64n256 (d[128]) extend the same layout to
// j = 0 .. 15 and 0 .. 31.
#pragma once

#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled

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
// or kStepMN multiples): start address, LBO 1 (unused), SBO eight rows,
// 128-byte swizzle; or, with ROW_BYTES 64, a tile of 32-column rows (64
// bytes, 512-byte aligned) in the 64-byte swizzle, where the 16-byte chunk c
// of row r lives at chunk c ^ ((r / 2) % 4), as TMA's SWIZZLE_64B writes it.
template <int ROW_BYTES = 128>
__device__ __forceinline__ uint64_t descriptor(const void* tile) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "128- or 64-byte swizzle");
  uint64_t d = (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(8 * ROW_BYTES >> 4) << 32;
  d |= (uint64_t)(ROW_BYTES == 128 ? 1 : 2) << 62;
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

#define VG_ACC8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VG_ACC128(d)                                                                      \
  VG_ACC8(d, 0), VG_ACC8(d, 8), VG_ACC8(d, 16), VG_ACC8(d, 24), VG_ACC8(d, 32),           \
      VG_ACC8(d, 40), VG_ACC8(d, 48), VG_ACC8(d, 56), VG_ACC8(d, 64), VG_ACC8(d, 72),     \
      VG_ACC8(d, 80), VG_ACC8(d, 88), VG_ACC8(d, 96), VG_ACC8(d, 104), VG_ACC8(d, 112),   \
      VG_ACC8(d, 120)
#define VG_ACC128_REGS                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "     \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "      \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "      \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "      \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "      \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "      \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "          \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "        \
  "%124, %125, %126, %127}"

#define VG_ACC64_REGS                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "     \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "      \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "      \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define VG_ACC64(d)                                                                       \
  VG_ACC8(d, 0), VG_ACC8(d, 8), VG_ACC8(d, 16), VG_ACC8(d, 24), VG_ACC8(d, 32),           \
      VG_ACC8(d, 40), VG_ACC8(d, 48), VG_ACC8(d, 56)

// d[64 x N] (+)= A[64 x 16] B[16 x N] for N = 128 (d[64]) and N = 256
// (d[128]), A and B K-major in shared memory (B's N rows are the output
// columns). Overwrites d when `accumulate` is 0.
__device__ __forceinline__ void mma_ss_wide(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VG_ACC64_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : VG_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void mma_ss_wide(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " VG_ACC128_REGS
      ", %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : VG_ACC128(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef VG_ACC8
#undef VG_ACC64
#undef VG_ACC64_REGS
#undef VG_ACC128
#undef VG_ACC128_REGS
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

// ---------------------------------------------------------------------------
// Tiles by TMA. A stage of a ring is filled by one thread's TMA loads, which
// report their bytes to the stage's `full` mbarrier; the consumers release it
// on its `empty` mbarrier. A wait names the parity of the phase it waits for:
// phase k of a barrier completes when it has been armed and used k + 1 times.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// After the initialisations, before any other thread or the TMA unit uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrives and adds `bytes` to what the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// A wait that has not ended after 2^26 tries (seconds, where a stage takes
// microseconds) traps, so that a fault in a pipeline ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of `map` at (column c0, row c1) into `dst`, reported to `bar`.
// Rows and columns outside the tensor arrive as zeros and count as bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Host: the map of a row-major bf16 [rows, cols] tensor (cols * 2 bytes a
// row, a multiple of 16) read in boxes of box_rows x box_cols, box_cols 64
// (128-byte swizzle) or 32 (64-byte swizzle). cuTensorMapEncodeTiled is the
// driver's; it is looked up through the runtime, so the library needs no
// link against libcuda.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                              uint32_t box_rows, uint32_t box_cols = 64) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A warp's 16 rows of an m64nN accumulator (N = 128 or 256) leave as bf16
// through the warp's own padded staging rows in shared memory (stage_bytes<N>()
// of them), so that each row is written as 16-byte stores of neighbouring
// lanes. stage_rows writes the pairs pack(j, h, d[4j + 2h], d[4j + 2h + 1])
// (columns 8j + 2(lane % 4) of row lane / 4 + 8h), and pack2's of the same
// pairs to stage2 where one is given; after a __syncwarp,
// copy_rows writes the staged rows to dst rows row0 .. row0 + 15 (ld elements
// apart), columns col0 .. col0 + N - 1, skipping rows at or past n_rows and
// columns at or past n_cols (a multiple of 8). A kernel that writes two
// outputs of one accumulator stages both in one pass, so that each value dies
// at its first use and the copies find the registers free.
template <int N>
__host__ __device__ constexpr int stage_pitch() {
  return N * 2 + 16;  // N / 2 + 4 words: the quads' 4-byte writes hit 32 banks
}
template <int N>
__host__ __device__ constexpr int stage_bytes() {
  return 16 * stage_pitch<N>();
}

struct PackBf16 {
  __device__ __forceinline__ uint32_t operator()(int, int, float lo, float hi) const {
    return pack_bf16(lo, hi);
  }
};

template <int N, typename Pack, typename Pack2 = PackBf16>
__device__ __forceinline__ void stage_rows(unsigned char* stage, const float (&d)[N / 2], Pack pack,
                                           unsigned char* stage2 = nullptr,
                                           Pack2 pack2 = Pack2()) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (j % 8 == 0) asm volatile("" ::: "memory");  // loads of eight column groups at a time
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = ((lane >> 2) + 8 * h) * stage_pitch<N>() + (8 * j + 2 * (lane & 3)) * 2;
      const float lo = d[4 * j + 2 * h], hi = d[4 * j + 2 * h + 1];
      *reinterpret_cast<uint32_t*>(stage + at) = pack(j, h, lo, hi);
      if (stage2 != nullptr) *reinterpret_cast<uint32_t*>(stage2 + at) = pack2(j, h, lo, hi);
    }
  }
}

template <int N>
__device__ __forceinline__ void copy_rows(const unsigned char* stage, __nv_bfloat16* dst,
                                          int row0, int n_rows, int ld, int col0, int n_cols) {
  constexpr int kChunks = N / 8, kRowsAPass = 32 / kChunks;  // 16-byte chunks a row
  const int lane = threadIdx.x & 31, c = lane % kChunks;
  const bool col_ok = col0 + 8 * c < n_cols;
#pragma unroll 4
  for (int i = 0; i < 16 / kRowsAPass; ++i) {
    const int r = i * kRowsAPass + lane / kChunks;
    if (row0 + r < n_rows && col_ok)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * ld + col0 + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * stage_pitch<N>() + 16 * c);
  }
}

}  // namespace gmma
}  // namespace vg
