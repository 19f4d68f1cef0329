// DIN's attention pool for Hopper (sm_90a), forward only, with a plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel of
//   deeplearningrecommendationsystem_tpu/ops/pallas/din_attention.py:
//   * din_attention_pool_pallas (_kernel)  -> din_pool_kernel
// Its plain PyTorch version is din_attention_pool_plain in
// deeplearningrecommendationsystem_tpu_torch/ops/din_attention.py.
//
// What it computes, per row of history h [L, D] and target t [D], with the
// decomposed first layer wh = W1_h + W1_(h-t), wt = W1_t - W1_(h-t) [D, A1]:
//   z1_l = h_l wh + t wt + b1,  s_l = relu(relu(z1_l) w2 + b2) w3,  w = softmax_l(s),
//   pooled = sum_l w_l h_l                                                   [D]
// The last layer's bias is dropped: it shifts every score of a row alike and
// cancels in the softmax, as in the Pallas kernel.
//
// Bound: operations. A row takes 2 D A1 + L (2 D A1 + 2 A1 A2) products, about
// 345k at the DIN preset (D 64, A 128, 64, L 10), and reads 2.8 KB. In float32
// accuracy on the tensor cores (3xTF32, tf32_mma.cuh: three TF32 products each)
// that is 0.056 ms for a 26,912-row window tile at 495 TFLOP/s, against 0.025 ms
// for its bytes; on CUDA cores it would be 0.14 ms. mma.sync reaches about 63%
// of that tensor-core peak on an H100 (tools/probe_mma_rate.py). The TPU
// kernel's point, kept here: the [B, L, A1] and [B, L, A2] activations never
// reach device memory.
//
// The kernel, its design and its launch are din_pool.cuh's (shared with the
// float32 DIN head's attention stage, din_head.cu).
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include <cuda_runtime.h>

#include "din_pool.cuh"

namespace {

using dinpool::PoolLayout;
using dinpool::PoolWeights;
using dinpool::fit_layout;
using dinpool::launch;

}  // namespace

extern "C" {

const char* din_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int din_attention_max_history() { return din::kMaxHistory; }

// hist [B, L, D], tgt [B, D], wh, wt [D, A1], b1 [A1], w2 [A1, A2], b2 [A2],
// w3 [A2] f32 -> out [B, D] f32.
int din_attention_fwd(const void* hist, const void* tgt, const void* wh, const void* wt,
                      const void* b1, const void* w2, const void* b2, const void* w3, void* out,
                      long long B, int L, int D, int A1, int A2, void* stream) {
  if (!din::widths_ok(B, L, D, A1, A2, 4, 4)) return cudaErrorInvalidValue;
  PoolLayout s;
  if (!fit_layout(L, D, A1, A2, &s)) return cudaErrorInvalidValue;
  const PoolWeights a{static_cast<const float*>(wh), static_cast<const float*>(wt),
                      static_cast<const float*>(b1), static_cast<const float*>(w2),
                      static_cast<const float*>(b2), static_cast<const float*>(w3)};
  const auto* h = static_cast<const float*>(hist);
  const auto* t = static_cast<const float*>(tgt);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return s.on_chip ? launch<true>(h, t, a, o, B, s, st) : launch<false>(h, t, a, o, B, s, st);
}

}  // extern "C"
