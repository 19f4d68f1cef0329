// DIN's attention pool for Hopper (sm_90a), forward only, with a plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel of
//   deeplearningrecommendationsystem_tpu/ops/pallas/din_attention.py:
//   * din_attention_pool_pallas (_kernel)  -> din::din_fwd_kernel<false, float>
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
// Bound: operations. A row takes L (2 D A1 + 2 A1 A2 + 2 A2) + 2 D A1 float32
// operations, about 347k at the DIN preset (D 64, A 128, 64, L 10), and reads
// 2.8 KB. The TPU kernel's point, kept here: the [B, L, A1] and [B, L, A2]
// activations never reach device memory. The tile layout, the block products and
// the forward are din_common.cuh's.
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include "din_common.cuh"

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
  din::Layout s;
  if (!din::fit_layout(L, D, A1, A2, 4, 4, false, false, &s)) return cudaErrorInvalidValue;
  const size_t smem = din::smem_bytes(s);
  int blocks = 0;
  const cudaError_t err =
      din::persistent_blocks(din::din_fwd_kernel<false, float>, smem, (B + s.R - 1) / s.R, &blocks);
  if (err != cudaSuccess) return err;
  const din::AttentionWeights<float> a{static_cast<const float*>(wh), static_cast<const float*>(wt),
                                static_cast<const float*>(b1), static_cast<const float*>(w2),
                                static_cast<const float*>(b2), static_cast<const float*>(w3),
                                nullptr};
  const din::FcWeights<float> f{};
  din::din_fwd_kernel<false, float><<<blocks, din::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), static_cast<const float*>(tgt), a, f,
      static_cast<float*>(out), B, s);
  return cudaGetLastError();
}

}  // extern "C"
