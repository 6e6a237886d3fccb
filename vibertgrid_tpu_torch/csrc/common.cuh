// Helpers shared by the port's hand-written kernels: element-type
// conversions (every kernel computes in fp32 and stores in the caller's
// dtype, fp32 or bf16) and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vg {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an fp32 value through the storage type T and back: the rounding
// the TPU kernels apply with `.astype(dtype)` before a second product.
template <typename T> __device__ __forceinline__ float round_through(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte asynchronous copy global -> shared (cp.async, bypassing L1), and
// its group fences: commit closes a group, wait<N> blocks until at most N
// groups are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Splitmix32-style finalizer of (seed, counter), the stateless draw behind
// every dropout mask (ops/dropout.py::splitmix32 is the same function on
// tensors). Each step is a bijection on uint32.
__device__ __forceinline__ uint32_t splitmix32(uint32_t x, uint32_t seed) {
  x ^= seed * 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Dropout of one fused kernel call: keep where the hash of the element's
// flat index reaches `threshold` = uint32(rate * 2^32). `on` is 0 at rate 0.
// The seed lives in device memory (a slot of the train step's seed tensor),
// so a replayed CUDA graph reads the step's own seed: every kernel calls
// load() before its first keep().
struct Dropout {
  int on;
  const uint32_t* seed_ptr;  // read only when on
  uint32_t threshold;
  float scale;  // attention: 1 / (1 - rate), a factor; FFN: 1 - rate, a divisor
  uint32_t seed;  // *seed_ptr once load() has run
  __device__ __forceinline__ void load() { seed = on ? *seed_ptr : 0u; }
  __device__ __forceinline__ bool keep(uint32_t index) const {
    return splitmix32(index, seed) >= threshold;
  }
};

// Row stride of the attention dropout draw: the TPU kernel pads T to a
// multiple of 128 and hashes row * padded_T + col, so the port hashes the
// same index without padding anything.
__host__ __device__ constexpr int round_up128(int t) { return (t + 127) / 128 * 128; }

// Python's floor division for a positive divisor (boxes may in principle be
// negative; `//` in the reference rounds toward minus infinity).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

}  // namespace vg
