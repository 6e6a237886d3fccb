// The wgmma down-projection with the residual LayerNorm, as fused_ffn.cu
// defines and launches it, for the other sources that run the same body:
//
//   out = LN(x + drop(h W2^T + b2))   over rows of h [N, F] and x, out [N, 768]
//
// with W2 [768, F] in nn.Linear layout, all bf16, and b2, gamma, beta [768]
// fp32. F is a multiple of 32. The fused FFN's second launch passes its
// [N, F] gelu scratch as h; the fused attention epilogue (fused_proj_ln.cu)
// passes the attention context as h and its out-projection as W2 (F = 768).
// Dropout keeps element (row, col) where splitmix32(row * 768 + col, seed)
// reaches the threshold and multiplies kept values by 1 / drop.scale
// (drop.scale = 1 - rate). yhat and rsig (the saved-residual outputs) may be
// null, and then both must be.
#pragma once

#include "common.cuh"

namespace vg {

constexpr int kDownLnWidth = 768;

struct DownLn {
  const void* h;   // [N, F] bf16, rows 16-byte aligned (TMA)
  const void* w2;  // [768, F] bf16
  const void* x;   // [N, 768] bf16, the residual
  const float *b2, *gamma, *beta;
  void* out;       // [N, 768] bf16
  void* yhat;      // [N, 768] bf16 normalised rows, or null
  float* rsig;     // [N] 1 / sqrt(var + eps), or null
  int N, F;
  float eps;
  Dropout drop;
  cudaStream_t stream;
};

// One launch on `a.stream`. Returns the error of a tensor-map encode, of the
// shared-memory attribute or of the launch; cudaErrorInvalidValue for a
// shape the kernel does not take.
cudaError_t ffn_down_ln(const DownLn& a);

}  // namespace vg
