// The fused DIN head for Hopper (sm_90a), forward and backward, with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels of
//   deeplearningrecommendationsystem_tpu/ops/pallas/din_head.py (din_head_fused):
//   * _fwd_kernel (pallas_call :267)  -> float32: dinpool::din_pool_kernel<., true>
//                                        (din_pool.cuh) + din_head_fc_kernel;
//                                        bf16: din::din_fwd_kernel<T>
//   * _bwd_kernel (pallas_call :300)  -> the split: the pooled rows (float32:
//                                        din_pool_kernel<., true>; bf16:
//                                        din_fwd_kernel<T>; none when the
//                                        forward's are given), the fc head
//                                        (float32: din_head_bwd_fc_head_kernel,
//                                        or din_head_bwd_fc_stream_kernel<float>
//                                        where its tile does not fit; bf16:
//                                        din_head_bwd_fc_stream_kernel<T>),
//                                        din_head_bwd_att_kernel<T>; float32 where
//                                        the split does not fit:
//                                        din_head_bwd_kernel<float>; then
//                                        din_head_bwd_fc_kernel +
//                                        din_head_bwd_reduce_kernel
// Their plain PyTorch versions are din_head_fwd_plain and din_head_bwd_plain in
// deeplearningrecommendationsystem_tpu_torch/ops/din_head.py.
//
// What they compute, per row of history h [L, D] and target t [D], with the 14
// weights of din_head_weights (wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2,
// u3, c3): the attention of din_attention.cu with b3 kept, then
//   f1 = relu(pooled u1p + t u1t + c1),  f2 = relu(f1 u2 + c2),  logit = f2 u3 + c3.
// Given the logit cotangent g, the backward recomputes that forward and returns
// d hist [B, L, D], d target [B, D] and the 14 weight gradients, summed over all
// rows (and positions):
//   dzf2 = (f2 > 0) g u3,  dzf1 = (f1 > 0) dzf2 u2^T,  [dpooled | dt] = dzf1 [u1p | u1t]^T,
//   ds_l = w_l (dpooled . h_l - sum_k w_k dpooled . h_k),  dz2 = (z2 > 0) ds w3,
//   dz1 = (z1 > 0) dz2 w2^T,  d h_l = w_l dpooled + dz1_l wh^T,  dt += (sum_l dz1_l) wt^T,
// and the weight gradients as the products of each layer's input and dz.
//
// Bound: operations. The forward is about 478k float32 operations a row at the
// DIN preset (D 64, A 128, 64, F 256, 128, L 10), the backward about three
// times that, against 2.8 KB read a row. The TPU kernels' point, kept here: the
// per-position activations never reach device memory, and the backward
// recomputes them instead of saving them. The backward keeps a tile's
// activations in shared memory and turns them into their gradients in place.
// The weight gradients are 90,916 floats at the preset, so they cannot be one
// partial per tile: a persistent grid of one block per SM walks the tiles,
// each block adding into its own slot in device memory (the same thread owns
// the same elements on every tile, no atomics). The fc head's two large ones
// (du1, du2: 65,536 floats) would cost a read and a write of 512 KB of slot for
// every 16 rows, so the backward writes the fc head's rows instead (3 KB a row)
// and din_head_bwd_fc_kernel sums them over a contiguous run of rows per
// block, each product held in registers and written once.
// din_head_bwd_reduce_kernel then sums the slots in block order, so runs repeat
// bit for bit.
//
// Dtypes. float32, or bfloat16 for hist, target and the 14 weights alike (the
// entries' `bf16` flag), as the JAX kernel takes both: the bf16 path reads bf16
// from device memory (the 225 MB float32 history of the DIN train batch becomes
// 112 MB), computes in float32 with each product's operands rounded to bf16
// where the JAX kernel casts them (din_common.cuh, op<T>), writes bf16 logits,
// and emits float32 gradients, which the caller casts to each input's dtype.
// The fc head's rows for din_head_bwd_fc_kernel stay float32 and are rounded
// as they are staged there.
//
// Which cores multiply:
// * bf16: every product on the tensor cores (mma.sync m16n8k16, float32
//   accumulation: din_common.cuh's block_mm_mma and block_mm_tn_acc_mma, and
//   fc_weight_grad_mma here), but the backward's recompute of the forward's
//   values that are rounded to bf16 downstream, which stays on CUDA cores: its
//   relu masks decide every gradient, and a mask at a kink follows the order
//   of summation. The CUDA-core fmaf chain sums in k order, as the float32
//   reference (cuBLAS) does, so its z, and each operand rounded to bf16
//   downstream of it, mostly match the reference's bit for bit; sums in the
//   tensor cores' order round intermediates differently, and the bf16
//   roundings that follow carry each difference to a kink
//   (tools/probe_din_bf16_order.py). The split recomputes the attention unit
//   (din_head_bwd_att_kernel<bf16>) and f1 on CUDA cores; f2, which only its
//   mask and du3 read, on the tensor cores with each input that could take
//   another sign in k order summed again in k order (stream_kink). The pooled
//   rows come from the forward, whose attention unit runs on the tensor cores
//   up to fc (kTensorPoolF1, kTensorPoolF2) and on CUDA cores past it.
// * float32, the forward: on the tensor cores in float32 accuracy (3xTF32
//   mma.sync m16n8k8). The attention unit, softmax and pool are the DIN window
//   pool's kernel with the last bias kept (din_pool.cuh: wh and w2 split once
//   a block into shared memory, relu(z1) handed to the second layer in
//   registers), which writes the pooled rows [B, D] (the only intermediate in
//   device memory); din_head_fc_kernel then takes 64 rows a block through
//   [pooled | t] u1 and f1 u2 on the tensor cores (u1 and u2 read once a block
//   and split as they are read; din_common.cuh's block_mm_tf32) and f2 u3 on
//   CUDA cores. Widths whose tiles do not fit these two kernels' shared memory
//   (D past about 350 at L 64) take din_fwd_kernel<float> on CUDA cores.
// * float32, the backward: the fc head apart from the attention unit, so that
//   the fc head's products reuse their B fragments over 64 rows. The pool's
//   kernel (b3 kept) writes the pooled rows again; din_head_bwd_fc_head_kernel
//   takes 64 rows a tile through f1, f2 (3xTF32, u1 and u2 split as read; a
//   relu input within the sum's error bound of 0 summed again in float32 before
//   its mask is taken), dzf2, dzf1 = dzf2 u2^T and [dpooled | dt] = dzf1 u1^T
//   (3xTF32 with B read transposed, Tf32MatT), writes [dpooled | dt] and the
//   rows, and sums du3, dc3, dc2, dc1; din_head_bwd_att_kernel then walks tiles
//   of 16 rows through the attention unit's recompute and backward, float32 FMA
//   on CUDA cores. A recompute of the whole head inside one per-tile kernel on
//   the tensor cores was slower on an H100: that tile fills shared memory, so B
//   came from L2 at every task, and the fc head's products reused each B
//   fragment for the tile's 16 rows only (PERF.md). Where the fc head's tile
//   does not fit (fc (2048, 2048)), din_head_bwd_fc_stream_kernel<float>
//   streams its operands instead. Widths whose tiles do not fit the split take
//   din_head_bwd_kernel<float> (the whole head on CUDA cores).
// Everything between the products is the same float32 code for both dtypes.
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include "din_common.cuh"
#include "din_pool.cuh"

namespace {

using din::as4;
using din::kThreads;
using din::load1;
using din::op;
using Bf16 = __nv_bfloat16;

constexpr int kWeights = 14;
constexpr int kGrads = 13;  // u1p and u1t share one block, u1 [2D, F1]

// Offsets (floats) of the weight gradients in a slot, each padded to 4 floats:
// wh, wt, b1, w2, b2, w3, b3, u1 = [u1p; u1t], c1, u2, c2, u3, c3.
struct GradSlots {
  int wh, wt, b1, w2, b2, w3, b3, u1, c1, u2, c2, u3, c3, total;
};

GradSlots grad_slots(int D, int A1, int A2, int F1, int F2) {
  const int sizes[kGrads] = {D * A1, D * A1, A1, A1 * A2, A2, A2, 1, 2 * D * F1, F1, F1 * F2, F2, F2, 1};
  int off[kGrads];
  int o = 0;
  for (int i = 0; i < kGrads; ++i) {
    off[i] = o;
    o += din::round4(sizes[i]);
  }
  return GradSlots{off[0], off[1], off[2], off[3], off[4],  off[5], off[6],
                   off[7], off[8], off[9], off[10], off[11], off[12], o};
}

template <class T>
void split_weights(const void* const* w, din::AttentionWeights<T>* a, din::FcWeights<T>* f) {
  const T* p[kWeights];
  for (int i = 0; i < kWeights; ++i) p[i] = static_cast<const T*>(w[i]);
  *a = din::AttentionWeights<T>{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
  *f = din::FcWeights<T>{p[7], p[8], p[9], p[10], p[11], p[12], p[13]};
}

// Rows r0 .. r0 + R - 1 (those below B) of a tile region [R][ld] (width floats
// each) into dst [B][width].
__device__ __forceinline__ void store_rows(const float* src, int ld, int width, long long r0,
                                           long long B, int R, float* __restrict__ dst) {
  const int w4 = width >> 2;
  for (int i = threadIdx.x; i < R * w4; i += blockDim.x) {
    const int r = i / w4, c = (i - r * w4) * 4;
    if (r0 + r < B) {
      as4(dst + static_cast<size_t>(r0 + r) * width + c) = *reinterpret_cast<const float4*>(src + r * ld + c);
    }
  }
}

// ------------------------------------------- float32: the forward's fc head

constexpr int kFcThreads = 256;
constexpr int kFcMT = 4;  // m16 tiles of a block's rows at most (64 rows)

// A block of din_head_fc_kernel: R rows (a multiple of 16); X [R][ldx] =
// [pooled | t], F1 [R][ld1], the logit partials P [R][parts] (one a 16-column
// task of the second product). Row strides are 8 mod 32 floats (fragment loads
// without bank conflicts).
struct FcLayout {
  int D, F1, F2, R, ldx, ld1, parts, oX, oF1, oP, total;
};

FcLayout make_fc_layout(int D, int F1, int F2, int R) {
  FcLayout s;
  s.D = D, s.F1 = F1, s.F2 = F2, s.R = R;
  s.ldx = dinpool::stride8(2 * D), s.ld1 = dinpool::stride8(F1);
  s.parts = (F2 + din::kTf32Cols - 1) / din::kTf32Cols;
  s.oX = 0;
  s.oF1 = s.oX + R * s.ldx;
  s.oP = s.oF1 + R * s.ld1;
  s.total = s.oP + din::round4(R * s.parts);
  return s;
}

// The most rows (a multiple of 16, at most 16 kFcMT) whose block fits.
bool fit_fc_layout(int D, int F1, int F2, FcLayout* out) {
  for (int R = 16 * kFcMT; R >= 16; R -= 16) {
    const FcLayout s = make_fc_layout(D, F1, F2, R);
    if (sizeof(float) * static_cast<size_t>(s.total) <= din::kSmemLimit) {
      *out = s;
      return true;
    }
  }
  return false;
}

// The float32 forward's fc head on the tensor cores, after din_pool_kernel
// wrote the pooled rows: logit = relu(relu([pooled | t] u1 + c1) u2 + c2) u3 + c3
// for R rows a block. Both products in 3xTF32 (block_mm_tf32 over all the
// block's m16 tiles at once, so a block reads u1 and u2 once, split as they are
// read); the last, f2 u3, in float32 on CUDA cores, as partial sums over each
// task's 16 columns (f2 never stored), summed in a fixed order.
__global__ void __launch_bounds__(kFcThreads, 2)
din_head_fc_kernel(const float* __restrict__ pooled, const float* __restrict__ tgt,
                   din::FcWeights<float> f, din::Tf32Mat u1, din::Tf32Mat u2,
                   float* __restrict__ out, long long B, FcLayout s) {
  extern __shared__ __align__(16) float sm[];
  float* X = sm + s.oX;
  float* F1 = sm + s.oF1;
  float* P = sm + s.oP;
  const long long r0 = static_cast<long long>(blockIdx.x) * s.R;
  const int d4 = s.D >> 2;
  for (int e = threadIdx.x; e < s.R * 2 * d4; e += kFcThreads) {
    const int r = e / (2 * d4), c = (e - r * 2 * d4) * 4;
    const float* src = c < s.D ? pooled + (r0 + r) * s.D + c : tgt + (r0 + r) * s.D + c - s.D;
    as4(X + r * s.ldx + c) = r0 + r < B ? din::ldg4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  din::block_mm_tf32<kFcMT>(X, s.ldx, u1, s.R, 2 * s.D, s.F1, [&](int r, int c, float4 v) {
    const float4 b = din::load4(f.c1 + c);
    as4(F1 + r * s.ld1 + c) = make_float4(din::relu(v.x + b.x), din::relu(v.y + b.y),
                                          din::relu(v.z + b.z), din::relu(v.w + b.w));
  });
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int task = threadIdx.x >> 5; task < s.parts; task += kFcThreads / 32) {
    const int n0 = task * din::kTf32Cols, c = n0 + 4 * t;
    float acc[kFcMT][2][4];
    din::warp_mm_tf32<kFcMT>(F1, s.ld1, s.R, s.F1, u2, 0, n0, acc);
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f), w = b;
    if (c < s.F2) b = din::load4(f.c2 + c), w = din::load4(f.u3 + c);
#pragma unroll
    for (int i = 0; i < kFcMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = din::row4(acc[i], h);
        float y = din::relu(v.x + b.x) * w.x;
        y = fmaf(din::relu(v.y + b.y), w.y, y);
        y = fmaf(din::relu(v.z + b.z), w.z, y);
        y = fmaf(din::relu(v.w + b.w), w.w, y);
        y += __shfl_xor_sync(din::kFull, y, 1);
        y += __shfl_xor_sync(din::kFull, y, 2);
        const int r = 16 * i + g + 8 * h;
        if (t == 0 && r < s.R) P[r * s.parts + task] = y;
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < s.R; r += kFcThreads) {
    float acc = 0.f;
    for (int j = 0; j < s.parts; ++j) acc += P[r * s.parts + j];
    if (r0 + r < B) out[r0 + r] = acc + load1(f.c3);
  }
}

// ------------------------------------------- float32: the backward's fc head

constexpr int kFcBwdMT = 2;  // m16 tiles of a warp's task in the fc head's backward (32 rows)
constexpr int kFcBwdRows = 64;  // rows of its tile at most
// A relu input z = x W[:, c] + b whose 3xTF32 sum lies below kKink (sum_k |x_k|)
// max_k |W[k][c]| from 0 is summed again in float32 on CUDA cores before its
// mask is taken (refine_dot). The 3xTF32 sum is off by at most about (30 + K /
// 128) 2^-23 sum_k |x_k W[k][c]|: 2^-22 of a product for each operand's low
// part rounded to TF32 and for the dropped lo lo, one rounding of the
// accumulator for each of a chunk's 24 mma.sync (kTf32Chunk k-steps, three
// products each), and one float32 add a chunk; below 2^-14 for any K the
// kernels take (K <= 2D + F1).
constexpr float kKink = 6.103515625e-05f;  // 2^-14

// A tile of din_head_bwd_fc_head_kernel: R rows (a multiple of 16); Xa [R][lda]
// holds [pooled | t], later f2 and then dzf2 in place; F1 [R][ld1] f1, then dzf1
// in place; G [R] the logit cotangent, RA [R] the rows' sum |x| of the product
// at hand; CM1 [F1], CM2 [F2] the columns' max |W| of u1 and u2; the block's
// sums over its tiles S1 [F1] (dc1), S2 [F2] (dc2), U3 [F2] (du3) and S3 (dc3).
// Row strides are 8 mod 32 floats (fragment loads without bank conflicts).
struct FcBwdLayout {
  int D, F1, F2, R, lda, ld1, oA, oF1, oG, oRA, oCM1, oCM2, oS1, oS2, oU3, oS3, total;
};

FcBwdLayout make_fc_bwd_layout(int D, int F1, int F2, int R) {
  FcBwdLayout s;
  s.D = D, s.F1 = F1, s.F2 = F2, s.R = R;
  s.lda = dinpool::stride8(max(2 * D, F2)), s.ld1 = dinpool::stride8(F1);
  int o = 0;
  auto take = [&o](int n) {
    const int start = o;
    o += din::round4(n);
    return start;
  };
  s.oA = take(R * s.lda);
  s.oF1 = take(R * s.ld1);
  s.oG = take(R);
  s.oRA = take(R);
  s.oCM1 = take(F1);
  s.oCM2 = take(F2);
  s.oS1 = take(F1);
  s.oS2 = take(F2);
  s.oU3 = take(F2);
  s.oS3 = take(1);
  s.total = o;
  return s;
}

// The most rows (a multiple of 16, at most kFcBwdRows) whose tile fits.
bool fit_fc_bwd_layout(int D, int F1, int F2, FcBwdLayout* out) {
  for (int R = kFcBwdRows; R >= 16; R -= 16) {
    const FcBwdLayout s = make_fc_bwd_layout(D, F1, F2, R);
    if (sizeof(float) * static_cast<size_t>(s.total) <= din::kSmemLimit) {
      *out = s;
      return true;
    }
  }
  return false;
}

// x [K] (shared memory) @ W[:, c] in float32 on CUDA cores, in k order from 0.
__device__ __forceinline__ float refine_dot(const float* x, const din::Tf32Mat& W, int c) {
  float z = 0.f;
  for (int k = 0; k < W.K; ++k) {
    const float* w = k < W.Ktop ? W.top + static_cast<size_t>(k) * W.N
                                : W.bottom + static_cast<size_t>(k - W.Ktop) * W.N;
    z = fmaf(x[k], __ldg(w + c), z);
  }
  return z;
}

// relu(x W + b) of four columns c .. c + 3 of a row from their 3xTF32 sums v,
// each within the error bound of 0 (bound max_k |W[k][c]|: bound = kKink sum |x|)
// summed again by refine_dot.
__device__ __forceinline__ float4 relu_refined(float4 v, const float* x, const din::Tf32Mat& W,
                                               const float* b, const float* cm, float bound, int c) {
  const float4 bb = din::ldg4(b + c), m = *reinterpret_cast<const float4*>(cm + c);
  float z[4] = {v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (fabsf(z[q]) < bound * din::at(m, q)) z[q] = refine_dot(x, W, c + q) + din::at(bb, q);
  }
  return make_float4(din::relu(z[0]), din::relu(z[1]), din::relu(z[2]), din::relu(z[3]));
}

// RA [r] = sum_k |X [r][k]| for the R rows (one warp a row, fixed order).
__device__ __forceinline__ void row_abs(const float* X, int ldx, int R, int K, float* RA) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += blockDim.x >> 5) {
    float acc = 0.f;
    for (int k = lane; k < K; k += 32) acc += fabsf(X[r * ldx + k]);
    acc = din::warp_sum(acc);
    if (lane == 0) RA[r] = acc;
  }
}

// The float32 backward's fc head on the tensor cores, from the pooled rows that
// din_pool_kernel<., true> wrote, for tiles of R rows: f1 = relu([pooled | t] u1
// + c1), f2 = relu(f1 u2 + c2) (3xTF32, block_mm_tf32, each relu input near 0
// summed again in float32), dzf2 = (f2 > 0) g u3, dzf1 = (f1 > 0) dzf2 u2^T and
// [dpooled | dt] = dzf1 [u1p | u1t]^T (3xTF32 with B = W^T, Tf32MatT) into dpt
// [B, 2D] for din_head_bwd_att_kernel; the rows din_head_bwd_fc_kernel reads
// ([pooled | t], f1, dzf1, dzf2) into rows; du3, dc3, dc2 and dc1 summed over the
// block's tiles in a fixed order and written once into its slot of part. A
// persistent grid (one block a slot) walks the tiles.
__global__ void __launch_bounds__(kThreads, 1)
din_head_bwd_fc_head_kernel(const float* __restrict__ pooled, const float* __restrict__ tgt,
                            const float* __restrict__ g, din::FcWeights<float> f, din::Tf32Mat u1,
                            din::Tf32Mat u2, din::Tf32MatT u2t, din::Tf32MatT u1t,
                            float* __restrict__ dpt, float* __restrict__ rows,
                            float* __restrict__ part, long long B, FcBwdLayout s, GradSlots o) {
  extern __shared__ __align__(16) float sm[];
  float* Xa = sm + s.oA;
  float* F1 = sm + s.oF1;
  float* G = sm + s.oG;
  float* RA = sm + s.oRA;
  float* CM1 = sm + s.oCM1;
  float* CM2 = sm + s.oCM2;
  float* S1 = sm + s.oS1;
  float* S2 = sm + s.oS2;
  float* U3 = sm + s.oU3;
  float* S3 = sm + s.oS3;
  const int D2 = 2 * s.D, R = s.R;
  float* xg = rows;
  float* f1g = xg + static_cast<size_t>(B) * D2;
  float* z1g = f1g + static_cast<size_t>(B) * s.F1;
  float* z2g = z1g + static_cast<size_t>(B) * s.F1;
  for (int c = threadIdx.x; c < s.F1; c += blockDim.x) {
    float m = 0.f;
    for (int k = 0; k < D2; ++k) {
      m = fmaxf(m, fabsf(__ldg(k < s.D ? f.u1p + static_cast<size_t>(k) * s.F1 + c
                                       : f.u1t + static_cast<size_t>(k - s.D) * s.F1 + c)));
    }
    CM1[c] = m, S1[c] = 0.f;
  }
  for (int c = threadIdx.x; c < s.F2; c += blockDim.x) {
    float m = 0.f;
    for (int k = 0; k < s.F1; ++k) m = fmaxf(m, fabsf(__ldg(f.u2 + static_cast<size_t>(k) * s.F2 + c)));
    CM2[c] = m, S2[c] = 0.f, U3[c] = 0.f;
  }
  if (threadIdx.x == 0) S3[0] = 0.f;
  const long long tiles = (B + R - 1) / R;
  const int d4 = s.D >> 2;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * R;
    __syncthreads();  // set up; the previous tile's readers are done
    for (int e = threadIdx.x; e < R * 2 * d4; e += blockDim.x) {
      const int r = e / (2 * d4), c = (e - r * 2 * d4) * 4;
      const bool in = r0 + r < B;
      const float* src = c < s.D ? pooled + (r0 + r) * s.D + c : tgt + (r0 + r) * s.D + c - s.D;
      const float4 v = in ? din::ldg4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      as4(Xa + r * s.lda + c) = v;
      if (in) as4(xg + (r0 + r) * D2 + c) = v;
    }
    for (int r = threadIdx.x; r < R; r += blockDim.x) G[r] = r0 + r < B ? g[r0 + r] : 0.f;
    __syncthreads();
    row_abs(Xa, s.lda, R, D2, RA);
    __syncthreads();
    din::block_mm_tf32<kFcBwdMT>(Xa, s.lda, u1, R, D2, s.F1, [&](int r, int c, float4 v) {
      as4(F1 + r * s.ld1 + c) = relu_refined(v, Xa + r * s.lda, u1, f.c1, CM1, kKink * RA[r], c);
    });
    __syncthreads();
    store_rows(F1, s.ld1, s.F1, r0, B, R, f1g);
    row_abs(F1, s.ld1, R, s.F1, RA);
    __syncthreads();
    din::block_mm_tf32<kFcBwdMT>(F1, s.ld1, u2, R, s.F1, s.F2, [&](int r, int c, float4 v) {
      as4(Xa + r * s.lda + c) = relu_refined(v, F1 + r * s.ld1, u2, f.c2, CM2, kKink * RA[r], c);
    });
    __syncthreads();
    // du3, dc3; then dzf2 in place of f2, and dc2
    din::block_colsum_acc<float>(Xa, s.lda, G, R, s.F2, U3);
    if (threadIdx.x == 0) {
      float acc = 0.f;
      for (int r = 0; r < R; ++r) acc += G[r];
      S3[0] += acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * s.F2; i += blockDim.x) {
      const int r = i / s.F2, c = i - r * s.F2;
      float& z = Xa[r * s.lda + c];
      z = z > 0.f ? G[r] * load1(f.u3 + c) : 0.f;
    }
    __syncthreads();
    store_rows(Xa, s.lda, s.F2, r0, B, R, z2g);
    din::block_colsum_acc<float>(Xa, s.lda, nullptr, R, s.F2, S2);
    // dzf1 = (f1 > 0) dzf2 u2^T, in place of f1
    din::block_mm_tf32<kFcBwdMT>(Xa, s.lda, u2t, R, s.F2, s.F1, [&](int r, int c, float4 v) {
      float4& z = as4(F1 + r * s.ld1 + c);
      const float4 p = z;
      z = make_float4(p.x > 0.f ? v.x : 0.f, p.y > 0.f ? v.y : 0.f, p.z > 0.f ? v.z : 0.f,
                      p.w > 0.f ? v.w : 0.f);
    });
    __syncthreads();
    // dc1; [dpooled | dt] = dzf1 [u1p | u1t]^T
    store_rows(F1, s.ld1, s.F1, r0, B, R, z1g);
    din::block_colsum_acc<float>(F1, s.ld1, nullptr, R, s.F1, S1);
    din::block_mm_tf32<kFcBwdMT>(F1, s.ld1, u1t, R, s.F1, D2, [&](int r, int c, float4 v) {
      if (r0 + r < B) as4(dpt + (r0 + r) * D2 + c) = v;
    });
  }
  __syncthreads();
  float* slot = part + static_cast<size_t>(blockIdx.x) * o.total;
  for (int c = threadIdx.x; c < s.F1; c += blockDim.x) slot[o.c1 + c] = S1[c];
  for (int c = threadIdx.x; c < s.F2; c += blockDim.x) slot[o.c2 + c] = S2[c], slot[o.u3 + c] = U3[c];
  if (threadIdx.x < 4) slot[o.c3 + threadIdx.x] = threadIdx.x == 0 ? S3[0] : 0.f;
}

// ------------------------------------- the split backward's fc head, streamed
//
// din_head_bwd_fc_stream_kernel<T>: the fc head's backward of
// din_head_bwd_fc_head_kernel, for bf16 at every fc width and for float32 where
// that kernel's tile (two full-width regions of its rows) does not fit (fc
// (2048, 2048)). Each product's A streams from the rows it writes into device
// memory (the rows of din_head_bwd_fc_kernel: [pooled | t], f1, dzf2, dzf1),
// kStreamK columns of a tile's rows at a time through shared memory, and each
// product's output is taken kStreamPanel columns at a time; so the tile keeps
// up to 64 rows whatever the widths, and each B fragment, read from L2, serves
// all of them. Warp w of a panel takes its 16 columns n_lo + 16 w for every
// row of the tile (kStreamMT m16 tiles). In float32 each product is 3xTF32 in
// warp_mm_tf32's order (kTf32Chunk k8 steps summed from zero, then added in
// float32); in bf16 mma.sync m16n8k16 in block_mm_mma's order (each k16 step
// added in float32), the operands rounded to bf16 as they are packed.
//
// The relu masks of f2, and in float32 of f1 (bf16 takes f1 on CUDA cores, see
// the kernel): beside each relu input's sum the warp sums the products of the
// operands' magnitudes on the tensor cores (sum_k |x_k| |W[k][c]|: bf16
// exactly, float32 from the TF32 hi parts), and an input that lies within
// stream_kink times that of 0 is summed again on CUDA cores in one fma chain
// over k (refine_dot's) before its mask is taken.
// The warp takes such an input together (warp_refine_dot: each lane loads a
// 32nd of the operands, every lane runs the chain on them in k order), so one
// costs K / 32 loads a lane.

constexpr int kStreamK = 128;     // columns of A staged at a time (a multiple of 8 kTf32Chunk)
constexpr int kStreamPanel = 256;  // output columns a pass: 16 columns a warp
constexpr int kStreamMT = 4;      // m16 tiles of a warp's task: the tile's rows, at most 64

// How far from 0, as a share of sum_k |x_k W[k][c]|, a relu input's tensor-core
// sum must lie for its mask to be taken from it. float32 (3xTF32): its error
// bound, (30 + K / 128) 2^-23 (see kKink), with a factor 2 to spare. bf16: the
// masks are those of the k-order sum on CUDA cores (the order of the plain
// version's float32 sums), so the bound covers the gap between the two sums. The products
// are exact in float32; a k16 step's sum inside the mma is off by at most 17
// units of 2^-23 of its largest term (terms aligned to the largest and
// truncated) and each of the K / 16 steps' float32 adds by 2^-24 of the
// running sum, while the k-order chain rounds K times, each by at most 2^-24
// of its running sum: (34 + 17 K / 16) 2^-24 in all, within (K + 32) 2^-23.
template <class T>
__device__ __forceinline__ float stream_kink(int K) {
  return std::is_same_v<T, Bf16> ? static_cast<float>(K + 32) * 1.1920928955078125e-07f
                                 : static_cast<float>(60 + K / 64) * 1.1920928955078125e-07f;
}

// B operands of bf16 products on the tensor cores (mma.sync m16n8k16) with
// block_mm_mma's slot mapping: frag(n, k, b) gives lane (g, t) rows k .. k + 3
// (k = k0 + 4t) of columns n and n + 1 (n = n0 + 2g), the first for n8 tile 0
// and the second for n8 tile 1, packed two bf16 a register; zeros past K and N
// (multiples of 4, so a quad lies inside or past them). W [K][N] (row-major):
// two 32-bit loads a row, merged by __byte_perm.
struct Bf16Mat {
  const Bf16* __restrict__ w;
  int K, N;
  __device__ __forceinline__ void frag(int n, int k, uint32_t (&b)[2][2]) const {
    b[0][0] = b[0][1] = b[1][0] = b[1][1] = 0u;
    if (n >= N || k >= K) return;
    const unsigned* q = reinterpret_cast<const unsigned*>(w + static_cast<size_t>(k) * N + n);
    const unsigned w0 = __ldg(q), w1 = __ldg(q + N / 2), w2 = __ldg(q + N), w3 = __ldg(q + N / 2 * 3);
    b[0][0] = __byte_perm(w0, w1, 0x5410), b[0][1] = __byte_perm(w2, w3, 0x5410);
    b[1][0] = __byte_perm(w0, w1, 0x7632), b[1][1] = __byte_perm(w2, w3, 0x7632);
  }
};

// W [N][K] (row-major; rows Ntop .. N - 1 from bottom when it is given) as the
// B operand of A @ W^T: one 8-byte load a column.
struct Bf16MatT {
  const Bf16* __restrict__ top;
  const Bf16* __restrict__ bottom;
  int Ntop, N, K;
  __device__ __forceinline__ void frag(int n, int k, uint32_t (&b)[2][2]) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      b[j][0] = b[j][1] = 0u;
      const int nj = n + j;
      if (nj < N && k < K) {
        const Bf16* w = nj < Ntop ? top + static_cast<size_t>(nj) * K
                                  : bottom + static_cast<size_t>(nj - Ntop) * K;
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(w + k));
        b[j][0] = q.x, b[j][1] = q.y;
      }
    }
  }
};

template <class T>
struct FcMats;  // the fc head's four B operands: u1, u2, u2^T, u1^T
template <>
struct FcMats<float> {
  din::Tf32Mat u1, u2;
  din::Tf32MatT u2t, u1t;
};
template <>
struct FcMats<Bf16> {  // f1 on CUDA cores: no u1
  Bf16Mat u2;
  Bf16MatT u2t, u1t;
};

FcMats<float> fc_mats(const din::FcWeights<float>& f, int D, int F1, int F2) {
  return {{f.u1p, f.u1t, D, 2 * D, F1}, {f.u2, nullptr, F1, F1, F2}, {f.u2, nullptr, F1, F1, F2},
          {f.u1p, f.u1t, D, 2 * D, F1}};
}

FcMats<Bf16> fc_mats(const din::FcWeights<Bf16>& f, int D, int F1, int F2) {
  return {{f.u2, F1, F2}, {f.u2, nullptr, F1, F1, F2}, {f.u1p, f.u1t, D, 2 * D, F1}};
}

// x [K] (device memory) @ W[:, c] in k order, by the whole warp (every lane
// gets the sum): a pass loads 32 consecutive k, a lane each (the next pass's
// loads issued before this pass's chain), and every lane runs the chain on the
// values of lanes 0 .. 31 in turn (bf16: x rounded to bf16).
__device__ __forceinline__ float2 refine_operands(const float* x, const din::Tf32Mat& W, int k, int c) {
  if (k >= W.K) return make_float2(0.f, 0.f);
  const float* w = k < W.Ktop ? W.top + static_cast<size_t>(k) * W.N : W.bottom + static_cast<size_t>(k - W.Ktop) * W.N;
  return make_float2(x[k], __ldg(w + c));
}

__device__ __forceinline__ float2 refine_operands(const float* x, const Bf16Mat& W, int k, int c) {
  return k < W.K ? make_float2(op<Bf16>(x[k]), load1(W.w + static_cast<size_t>(k) * W.N + c))
                 : make_float2(0.f, 0.f);
}

template <class Mat>
__device__ __forceinline__ float warp_refine_dot(const float* x, const Mat& W, int c) {
  const int lane = threadIdx.x & 31;
  float z = 0.f;
  float2 next = refine_operands(x, W, lane, c);
  for (int k0 = 0; k0 < W.K; k0 += 32) {
    const float2 v = next;
    next = refine_operands(x, W, k0 + 32 + lane, c);
    if (k0 + 32 <= W.K) {  // a whole pass: the shuffles issued ahead of the chain
#pragma unroll
      for (int i = 0; i < 32; ++i) z = fmaf(__shfl_sync(din::kFull, v.x, i), __shfl_sync(din::kFull, v.y, i), z);
    } else {
      for (int i = 0; i < W.K - k0; ++i) {
        z = fmaf(__shfl_sync(din::kFull, v.x, i), __shfl_sync(din::kFull, v.y, i), z);
      }
    }
  }
  return z;
}

// relu(x W + b) of four columns c .. c + 3 of a row from their tensor-core sums v
// and magnitude sums av, each within bound av of 0 summed again in k order
// (warp_refine_dot). Every lane of the warp calls it; a lane with valid false
// (columns past N, rows past B) takes part in the others' sums and gets zeros.
template <class T, class Mat>
__device__ __forceinline__ float4 relu_refined_warp(float4 v, float4 av, const float* x, const Mat& W,
                                                    const T* b, float kink, int c, bool valid) {
  const int lane = threadIdx.x & 31;
  float4 bb = make_float4(0.f, 0.f, 0.f, 0.f);
  float z[4] = {0.f, 0.f, 0.f, 0.f};
  unsigned need = 0;
  if (valid) {
    bb = din::load4(b + c);
    z[0] = v.x + bb.x, z[1] = v.y + bb.y, z[2] = v.z + bb.z, z[3] = v.w + bb.w;
#pragma unroll
    for (int q = 0; q < 4; ++q) need |= fabsf(z[q]) < kink * din::at(av, q) ? 1u << q : 0u;
  }
  for (unsigned pending = __ballot_sync(din::kFull, need != 0); pending;
       pending = __ballot_sync(din::kFull, need != 0)) {
    const int src = __ffs(pending) - 1;
    const int q = __ffs(__shfl_sync(din::kFull, need, src)) - 1;
    const auto xs = reinterpret_cast<const float*>(
        __shfl_sync(din::kFull, reinterpret_cast<unsigned long long>(x), src));
    const float r = warp_refine_dot(xs, W, __shfl_sync(din::kFull, c, src) + q);
    if (lane == src) {
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        if (qq == q) z[qq] = r + din::at(bb, qq);
      }
      need &= ~(1u << q);
    }
  }
  return make_float4(din::relu(z[0]), din::relu(z[1]), din::relu(z[2]), din::relu(z[3]));
}

// A tile of din_head_bwd_fc_stream_kernel: R rows (a multiple of 16, at most
// 16 kStreamMT); C [R][ldc] a staged chunk of A's columns, P [R][ldp] an output
// panel; bf16 only, X [R][ldx] = [pooled | t] (f1's operands on CUDA cores); G
// [R] the logit cotangent; the block's sums over its tiles S1 [F1] (dc1), S2
// [F2] (dc2), U3 [F2] (du3) and S3 (dc3). ldc is 8 mod 32 floats for float32
// (8-byte fragment loads without bank conflicts) and 16 mod 32 for bf16
// (16-byte ones).
struct FcStreamLayout {
  int D, F1, F2, R, ldc, ldp, ldx, oC, oP, oX, oG, oS1, oS2, oU3, oS3, total;
};

FcStreamLayout make_fc_stream_layout(int D, int F1, int F2, int R, bool bf16) {
  FcStreamLayout s;
  s.D = D, s.F1 = F1, s.F2 = F2, s.R = R;
  s.ldc = kStreamK + (bf16 ? 16 : 8), s.ldp = kStreamPanel + 8, s.ldx = 2 * D + din::kPad;
  int o = 0;
  auto take = [&o](int n) {
    const int start = o;
    o += din::round4(n);
    return start;
  };
  s.oC = take(R * s.ldc);
  s.oP = take(R * s.ldp);
  s.oX = take(bf16 ? R * s.ldx : 0);
  s.oG = take(R);
  s.oS1 = take(F1);
  s.oS2 = take(F2);
  s.oU3 = take(F2);
  s.oS3 = take(1);
  s.total = o;
  return s;
}

// The tile for B rows on `blocks` persistent blocks: of 64, 32 and 16 rows,
// those that fit, the one with the fewest rounds of tiles times (rows + 16) (a
// tile's time grows with its rows, plus its reads of the weights; on ties the
// most rows). blocks = 0: the smallest that fits (for din_head_fits).
bool fit_fc_stream_layout(int D, int F1, int F2, bool bf16, long long B, int blocks,
                          FcStreamLayout* out) {
  long long best = -1;
  for (int R = 16 * kStreamMT; R >= 16; R /= 2) {
    const FcStreamLayout s = make_fc_stream_layout(D, F1, F2, R, bf16);
    if (sizeof(float) * static_cast<size_t>(s.total) > din::kSmemLimit) continue;
    const long long rounds = blocks > 0 ? ((B + R - 1) / R + blocks - 1) / blocks : 1;
    const long long cost = blocks > 0 ? rounds * (R + 16) : R;
    if (best < 0 || cost < best) best = cost, *out = s;
  }
  return best >= 0;
}

// acc[i] += A [M][kp] (a staged chunk, row stride lda, zeros past its columns)
// @ W's rows k_lo .. k_lo + kp - 1 for the m16 tiles 16 i (below M) and the 16
// columns n0 .. n0 + 15, in 3xTF32: warp_mm_tf32's loop, kTf32Chunk k8 steps
// summed from zero in the accumulators and then added into acc in float32.
// With kAbs, aacc[i] += |A| |W| from the TF32 hi parts, one pass.
template <bool kAbs, int kMT, class Mat>
__device__ __forceinline__ void warp_chunk_mm(const float* A, int lda, int M, int k_lo, int kp,
                                              const Mat& W, int n0, float (&acc)[kMT][2][4],
                                              float (&aacc)[kMT][2][4], float) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int kc = 0; kc < kp; kc += 8 * din::kTf32Chunk) {
    float part[kMT][2][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
    }
    const int kend = min(kp, kc + 8 * din::kTf32Chunk);
    uint32_t nh[2][2], nl[2][2];
    W.frag(n0 + 2 * g, k_lo + kc + 2 * t, nh[0], nl[0]);
    W.frag(n0 + 2 * g + 1, k_lo + kc + 2 * t, nh[1], nl[1]);
    for (int k0 = kc; k0 < kend; k0 += 8) {  // each step's B loaded during the step before
      const int k = k0 + 2 * t;
      uint32_t bh[2][2], bl[2][2], ba[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        bh[j][0] = nh[j][0], bh[j][1] = nh[j][1], bl[j][0] = nl[j][0], bl[j][1] = nl[j][1];
        ba[j][0] = bh[j][0] & 0x7fffffffu, ba[j][1] = bh[j][1] & 0x7fffffffu;
      }
      if (k0 + 8 < kend) {
        W.frag(n0 + 2 * g, k_lo + k + 8, nh[0], nl[0]);
        W.frag(n0 + 2 * g + 1, k_lo + k + 8, nh[1], nl[1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (16 * i >= M) break;  // the whole warp
        const float2 u = *reinterpret_cast<const float2*>(A + (16 * i + g) * lda + k);
        const float2 v = *reinterpret_cast<const float2*>(A + (16 * i + g + 8) * lda + k);
        uint32_t ah[4], al[4];
        tf32mma::split_tf32_bits(u.x, ah[0], al[0]);
        tf32mma::split_tf32_bits(v.x, ah[1], al[1]);
        tf32mma::split_tf32_bits(u.y, ah[2], al[2]);
        tf32mma::split_tf32_bits(v.y, ah[3], al[3]);
        tf32mma::mma_3xtf32(part[i], ah, al, bh, bl);
        if constexpr (kAbs) {
          const uint32_t aa[4] = {ah[0] & 0x7fffffffu, ah[1] & 0x7fffffffu, ah[2] & 0x7fffffffu,
                                  ah[3] & 0x7fffffffu};
          tf32mma::mma_tf32(aacc[i][0], aa, ba[0]);
          tf32mma::mma_tf32(aacc[i][1], aa, ba[1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
      }
    }
  }
}

// The same for bf16 on mma.sync m16n8k16, in block_mm_mma's order and slot
// mapping (lane t's k slots take k0 + 4t .. k0 + 4t + 3: one 16-byte load of A's
// row), A's values rounded to bf16 as they are packed; with kAbs, aacc[i] +=
// |A| |W| (the packed registers' sign bits cleared).
template <bool kAbs, int kMT, class Mat>
__device__ __forceinline__ void warp_chunk_mm(const float* A, int lda, int M, int k_lo, int kp,
                                              const Mat& W, int n0, float (&acc)[kMT][2][4],
                                              float (&aacc)[kMT][2][4], Bf16) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t next[2][2];
  W.frag(n0 + 2 * g, k_lo + 4 * t, next);
  for (int k0 = 0; k0 < kp; k0 += 16) {  // each step's B loaded during the step before
    uint32_t b[2][2] = {{next[0][0], next[0][1]}, {next[1][0], next[1][1]}};
    if (k0 + 16 < kp) W.frag(n0 + 2 * g, k_lo + k0 + 16 + 4 * t, next);
    const int k = k0 + 4 * t;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (16 * i >= M) break;  // the whole warp
      const float4 u = *reinterpret_cast<const float4*>(A + (16 * i + g) * lda + k);
      const float4 v = *reinterpret_cast<const float4*>(A + (16 * i + g + 8) * lda + k);
      const uint32_t a[4] = {din::pack_bf16(u.x, u.y), din::pack_bf16(v.x, v.y),
                             din::pack_bf16(u.z, u.w), din::pack_bf16(v.z, v.w)};
      din::mma_bf16(acc[i][0], a, b[0]);
      din::mma_bf16(acc[i][1], a, b[1]);
      if constexpr (kAbs) {
        constexpr uint32_t kMag = 0x7fff7fffu;
        const uint32_t aa[4] = {a[0] & kMag, a[1] & kMag, a[2] & kMag, a[3] & kMag};
        const uint32_t b0[2] = {b[0][0] & kMag, b[0][1] & kMag}, b1[2] = {b[1][0] & kMag, b[1][1] & kMag};
        din::mma_bf16(aacc[i][0], aa, b0);
        din::mma_bf16(aacc[i][1], aa, b1);
      }
    }
  }
}

// C = A @ W for the tile's R rows, a panel of kStreamPanel columns at a time:
// A's rows r0 .. r0 + R - 1 of [B][K] float32 in device memory (rows past B
// staged as zeros), kStreamK columns at a time into the chunk region. Every
// lane of a warp with columns in the panel calls epi(r, c, float4 v, float4 av,
// bool valid) for each of its rows and four columns c .. c + 3 (valid: c < N;
// av the magnitude sums with kAbs, else zeros); then, after a barrier, every
// thread runs post(n_lo, n_hi) for the panel's columns, and a barrier follows.
// Begins with a barrier.
template <class T, bool kAbs, class Mat, class Epi, class Post>
__device__ __forceinline__ void stream_mm(const float* A, int K, long long r0, long long B,
                                          const Mat& W, int N, float* chunk,
                                          const FcStreamLayout& s, Epi epi, Post post) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int R = s.R;
  for (int n_lo = 0; n_lo < N; n_lo += kStreamPanel) {
    const int n0 = n_lo + 16 * warp;
    float acc[kStreamMT][2][4], aacc[kStreamMT][2][4];
#pragma unroll
    for (int i = 0; i < kStreamMT; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = aacc[i][j][q] = 0.f;
      }
    }
    for (int k_lo = 0; k_lo < K; k_lo += kStreamK) {
      const int kn = min(kStreamK, K - k_lo);
      const int kp = std::is_same_v<T, Bf16> ? (kn + 15) & ~15 : (kn + 7) & ~7;
      const int q4 = kp >> 2;
      __syncthreads();  // the previous chunk's readers are done
      for (int i = threadIdx.x; i < R * q4; i += blockDim.x) {
        const int r = i / q4, c = (i - r * q4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < B && c < kn) v = *reinterpret_cast<const float4*>(A + (r0 + r) * K + k_lo + c);
        as4(chunk + r * s.ldc + c) = v;
      }
      __syncthreads();
      if (n0 < N) warp_chunk_mm<kAbs, kStreamMT>(chunk, s.ldc, R, k_lo, kp, W, n0, acc, aacc, T());
    }
    if (n0 < N) {  // the whole warp
      const int col = n0 + 4 * t;
#pragma unroll
      for (int i = 0; i < kStreamMT; ++i) {
        if (16 * i >= R) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          epi(16 * i + g + 8 * h, col, din::row4(acc[i], h), din::row4(aacc[i], h), col < N);
        }
      }
    }
    __syncthreads();
    post(n_lo, min(N, n_lo + kStreamPanel));
    __syncthreads();
  }
}

// Rows r0 .. r0 + R - 1 (those below B) of the panel P [R][ldp] (columns n_lo
// .. n_hi - 1) into dst [B][ld] at those columns.
__device__ __forceinline__ void store_panel(const float* P, int ldp, int n_lo, int n_hi, long long r0,
                                            long long B, int R, float* dst, int ld) {
  const int w4 = (n_hi - n_lo) >> 2;
  for (int i = threadIdx.x; i < R * w4; i += blockDim.x) {
    const int r = i / w4, c = (i - r * w4) * 4;
    if (r0 + r < B) as4(dst + (r0 + r) * ld + n_lo + c) = *reinterpret_cast<const float4*>(P + r * ldp + c);
  }
}

// The fc head's backward for bf16, and for float32 at fc widths whose
// din_head_bwd_fc_head_kernel tile does not fit: what that kernel computes,
// from the pooled rows (din_fwd_kernel<bf16>'s, or din_pool_kernel<., true>'s)
// and with the same outputs, the fc rows in device memory (see this section's
// first note). The bf16 weight and bias gradients round their operands as the
// JAX kernel does (block_colsum_acc<bf16>). The rows are read
// back with plain loads, after the barrier that follows their stores.
template <class T>
__global__ void __launch_bounds__(kThreads, 1)
din_head_bwd_fc_stream_kernel(const float* __restrict__ pooled, const T* __restrict__ tgt,
                              const float* __restrict__ g, din::FcWeights<T> f, FcMats<T> w,
                              float* __restrict__ dpt, float* rows, float* __restrict__ part,
                              long long B, FcStreamLayout s, GradSlots o) {
  extern __shared__ __align__(16) float sm[];
  float* C = sm + s.oC;
  float* P = sm + s.oP;
  float* G = sm + s.oG;
  float* S1 = sm + s.oS1;
  float* S2 = sm + s.oS2;
  float* U3 = sm + s.oU3;
  float* S3 = sm + s.oS3;
  const int D = s.D, D2 = 2 * D, F1 = s.F1, F2 = s.F2, R = s.R;
  float* xg = rows;
  float* f1g = xg + static_cast<size_t>(B) * D2;
  float* z1g = f1g + static_cast<size_t>(B) * F1;
  float* z2g = z1g + static_cast<size_t>(B) * F1;
  for (int c = threadIdx.x; c < F1; c += blockDim.x) S1[c] = 0.f;
  for (int c = threadIdx.x; c < F2; c += blockDim.x) S2[c] = 0.f, U3[c] = 0.f;
  if (threadIdx.x == 0) S3[0] = 0.f;
  const float kink2 = stream_kink<T>(F1);
  const long long tiles = (B + R - 1) / R;
  const int d4 = D >> 2;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * R;
    __syncthreads();  // set up; the previous tile's readers are done
    for (int e = threadIdx.x; e < R * 2 * d4; e += blockDim.x) {
      const int r = e / (2 * d4), c = (e - r * 2 * d4) * 4;
      if (r0 + r < B) {
        as4(xg + (r0 + r) * D2 + c) = c < D ? din::ldg4(pooled + (r0 + r) * D + c)
                                            : din::load4(tgt + (r0 + r) * D + c - D);
      }
    }
    for (int r = threadIdx.x; r < R; r += blockDim.x) G[r] = r0 + r < B ? g[r0 + r] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {  // dc3
      float acc = 0.f;
      for (int r = 0; r < R; ++r) acc += G[r];
      S3[0] += acc;
    }
    // f1 = relu([pooled | t] u1 + c1) into f1g
    if constexpr (std::is_same_v<T, Bf16>) {
      // on CUDA cores in k order: f1 enters f2's product rounded to bf16, so its
      // value, not only its sign, follows the order of its sum
      float* X = sm + s.oX;
      for (int e = threadIdx.x; e < R * 2 * d4; e += blockDim.x) {
        const int r = e / (2 * d4), c = (e - r * 2 * d4) * 4;
        as4(X + r * s.ldx + c) = r0 + r < B ? *reinterpret_cast<const float4*>(xg + (r0 + r) * D2 + c)
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
      din::block_mm<2, false, false>(X, s.ldx, f.u1p, F1, R, D, F1, [&](int r, int c, float4 v) {
        if (r0 + r < B) as4(f1g + (r0 + r) * F1 + c) = v;
      });
      __syncthreads();
      din::block_mm<2, false, false>(X + D, s.ldx, f.u1t, F1, R, D, F1, [&](int r, int c, float4 v) {
        if (r0 + r < B) {
          float4& o = as4(f1g + (r0 + r) * F1 + c);
          const float4 p = o, b = din::load4(f.c1 + c);
          o = make_float4(din::relu(p.x + v.x + b.x), din::relu(p.y + v.y + b.y),
                          din::relu(p.z + v.z + b.z), din::relu(p.w + v.w + b.w));
        }
      });
    } else {
      const float kink1 = stream_kink<T>(D2);
      stream_mm<T, true>(xg, D2, r0, B, w.u1, F1, C, s, [&](int r, int c, float4 v, float4 av, bool valid) {
        const bool in = valid && r0 + r < B;
        const float4 z = relu_refined_warp(v, av, xg + (r0 + r) * D2, w.u1, f.c1, kink1, c, in);
        if (in) as4(f1g + (r0 + r) * F1 + c) = z;
      }, [](int, int) {});
    }
    // f2 = relu(f1 u2 + c2) into the panel; du3; dzf2 in place, dc2, into z2g
    stream_mm<T, true>(f1g, F1, r0, B, w.u2, F2, C, s, [&](int r, int c, float4 v, float4 av, bool valid) {
      const float4 z = relu_refined_warp(v, av, f1g + (r0 + r) * F1, w.u2, f.c2, kink2, c,
                                         valid && r0 + r < B);
      if (valid) as4(P + r * s.ldp + c % kStreamPanel) = z;
    }, [&](int n_lo, int n_hi) {
      for (int c = n_lo + threadIdx.x; c < n_hi; c += blockDim.x) {
        const float u3 = load1(f.u3 + c);
        float du3 = 0.f, dc2 = 0.f;
        for (int r = 0; r < R; ++r) {
          float& z = P[r * s.ldp + c - n_lo];
          du3 = fmaf(op<T>(z), op<T>(G[r]), du3);
          z = z > 0.f ? op<T>(G[r]) * u3 : 0.f;
          dc2 += z;
        }
        U3[c] += du3, S2[c] += dc2;
      }
      __syncthreads();
      store_panel(P, s.ldp, n_lo, n_hi, r0, B, R, z2g, F2);
    });
    // dzf1 = (f1 > 0) dzf2 u2^T into the panel; dc1; into z1g
    stream_mm<T, false>(z2g, F2, r0, B, w.u2t, F1, C, s, [&](int r, int c, float4 v, float4, bool valid) {
      if (!valid) return;
      float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < B) p = *reinterpret_cast<const float4*>(f1g + (r0 + r) * F1 + c);
      as4(P + r * s.ldp + c % kStreamPanel) = make_float4(p.x > 0.f ? v.x : 0.f, p.y > 0.f ? v.y : 0.f,
                                                          p.z > 0.f ? v.z : 0.f, p.w > 0.f ? v.w : 0.f);
    }, [&](int n_lo, int n_hi) {
      for (int c = n_lo + threadIdx.x; c < n_hi; c += blockDim.x) {
        float dc1 = 0.f;
        for (int r = 0; r < R; ++r) dc1 += P[r * s.ldp + c - n_lo];
        S1[c] += dc1;
      }
      store_panel(P, s.ldp, n_lo, n_hi, r0, B, R, z1g, F1);
    });
    // [dpooled | dt] = dzf1 [u1p | u1t]^T into dpt
    stream_mm<T, false>(z1g, F1, r0, B, w.u1t, D2, C, s, [&](int r, int c, float4 v, float4, bool valid) {
      if (valid && r0 + r < B) as4(dpt + (r0 + r) * D2 + c) = v;
    }, [](int, int) {});
  }
  __syncthreads();
  float* slot = part + static_cast<size_t>(blockIdx.x) * o.total;
  for (int c = threadIdx.x; c < F1; c += blockDim.x) slot[o.c1 + c] = S1[c];
  for (int c = threadIdx.x; c < F2; c += blockDim.x) slot[o.c2 + c] = S2[c], slot[o.u3 + c] = U3[c];
  if (threadIdx.x < 4) slot[o.c3 + threadIdx.x] = threadIdx.x == 0 ? S3[0] : 0.f;
}

// ---------------------------------------------------------------- the backward

// The whole head's backward a tile of rows at a time, recompute included, for
// float32 at widths whose tiles do not fit the split (only float32 is
// instantiated: bf16 takes the split at every width kernel_route sends it).
template <class T>
__global__ void __launch_bounds__(kThreads, 1)
din_head_bwd_kernel(const T* __restrict__ hist, const T* __restrict__ tgt,
                    din::AttentionWeights<T> a, din::FcWeights<T> f, const float* __restrict__ g,
                    float* __restrict__ dhist, float* __restrict__ dtgt, float* __restrict__ part,
                    float* __restrict__ rows, long long B, din::Layout s, GradSlots o) {
  extern __shared__ __align__(16) float sm[];
  float* slot = part + static_cast<size_t>(blockIdx.x) * o.total;
  for (int j = threadIdx.x; j < o.total; j += blockDim.x) slot[j] = 0.f;
  float* xg = rows;  // the fc head's rows for din_head_bwd_fc_kernel
  float* f1g = xg + static_cast<size_t>(B) * 2 * s.D;
  float* z1g = f1g + static_cast<size_t>(B) * s.F1;
  float* z2g = z1g + static_cast<size_t>(B) * s.F1;
  float* H = sm + s.oH;
  float* X = sm + s.oX;
  float* R1 = sm + s.oR1;
  float* R2 = sm + s.oR2;
  float* Tt = sm + s.oT;
  float* F1 = sm + s.oQ;
  float* F2 = sm + s.oF2;
  float* W = sm + s.oW;
  float* S = sm + s.oS;
  float* P = sm + s.oP;
  float* G = sm + s.oG;
  const int D = s.D, L = s.L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tiles = (B + s.R - 1) / s.R;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * s.R;
    __syncthreads();  // the slot is zeroed; the previous tile's readers are done
    din::stage_tile(hist, tgt, g, r0, B, s, sm);
    __syncthreads();
    din::attention_forward<T, false>(a, s, sm);  // CUDA cores (see the note at the top)
    din::fc_forward<T, false>(f, s, sm);
    store_rows(X, s.ldx, 2 * D, r0, B, s.R, xg);
    store_rows(F1, s.ldf1, s.F1, r0, B, s.R, f1g);

    // ---- the fc head: du3, dc3, then dzf2 in place of f2
    din::block_colsum_acc<T>(F2, s.ldf2, G, s.R, s.F2, slot + o.u3);
    din::block_colsum_acc<T>(G, 1, nullptr, s.R, 1, slot + o.c3);
    __syncthreads();
    for (int i = threadIdx.x; i < s.R * s.F2; i += blockDim.x) {
      const int r = i / s.F2, c = i - r * s.F2;
      float& z = F2[r * s.ldf2 + c];
      z = z > 0.f ? op<T>(G[r]) * load1(f.u3 + c) : 0.f;
    }
    __syncthreads();
    store_rows(F2, s.ldf2, s.F2, r0, B, s.R, z2g);
    din::block_colsum_acc<T>(F2, s.ldf2, nullptr, s.R, s.F2, slot + o.c2);
    __syncthreads();
    // dzf1 = (f1 > 0) dzf2 u2^T, in place of f1
    din::block_mm<2, true>(F2, s.ldf2, f.u2, s.F2, s.R, s.F2, s.F1, [&](int r, int c, float4 v) {
      float4& z = as4(F1 + r * s.ldf1 + c);
      const float4 p = z;
      z = make_float4(p.x > 0.f ? v.x : 0.f, p.y > 0.f ? v.y : 0.f, p.z > 0.f ? v.z : 0.f,
                      p.w > 0.f ? v.w : 0.f);
    });
    __syncthreads();
    // dc1; [dpooled | dt] = dzf1 [u1p | u1t]^T
    store_rows(F1, s.ldf1, s.F1, r0, B, s.R, z1g);
    din::block_colsum_acc<T>(F1, s.ldf1, nullptr, s.R, s.F1, slot + o.c1);
    din::block_mm<1, true>(F1, s.ldf1, f.u1p, s.F1, s.R, s.F1, D,
                           [&](int r, int c, float4 v) { as4(P + r * s.ldx + c) = v; });
    din::block_mm<1, true>(F1, s.ldf1, f.u1t, s.F1, s.R, s.F1, D,
                           [&](int r, int c, float4 v) { as4(P + r * s.ldx + D + c) = v; });
    __syncthreads();

    // ---- the softmax: ds_l = w_l (dw_l - sum_k w_k dw_k), dw_l = dpooled . h_l
    for (int r = warp; r < s.R; r += kThreads / 32) {
      for (int l = 0; l < L; ++l) {
        const int m = r * L + l;
        float acc = 0.f;
        for (int d = lane; d < D; d += 32) acc = fmaf(P[r * s.ldx + d], H[m * s.ldh + d], acc);
        acc = din::warp_sum(acc);
        if (lane == 0) S[m] = acc;
      }
      __syncwarp();
      float wd = 0.f;
      for (int l = lane; l < L; l += 32) wd = fmaf(W[r * L + l], S[r * L + l], wd);
      wd = din::warp_sum(wd);
      for (int l = lane; l < L; l += 32) S[r * L + l] = W[r * L + l] * (S[r * L + l] - wd);
    }
    __syncthreads();

    // ---- the activation unit: dw3, db3, then dz2 in place of r2
    din::block_colsum_acc<T>(R2, s.ld2, S, s.M, s.A2, slot + o.w3);
    din::block_colsum_acc<T>(S, 1, nullptr, s.M, 1, slot + o.b3);
    __syncthreads();
    for (int i = threadIdx.x; i < s.M * s.A2; i += blockDim.x) {
      const int m = i / s.A2, c = i - m * s.A2;
      float& z = R2[m * s.ld2 + c];
      z = z > 0.f ? op<T>(S[m]) * load1(a.w3 + c) : 0.f;
    }
    __syncthreads();
    din::block_mm_tn_acc<T>(R1, s.ld1, R2, s.ld2, s.M, s.A1, s.A2, slot + o.w2);
    din::block_colsum_acc<T>(R2, s.ld2, nullptr, s.M, s.A2, slot + o.b2);
    __syncthreads();
    // dz1 = (z1 > 0) dz2 w2^T, in place of r1
    din::block_mm<10, true>(R2, s.ld2, a.w2, s.A2, s.M, s.A2, s.A1, [&](int m, int c, float4 v) {
      float4& z = as4(R1 + m * s.ld1 + c);
      const float4 p = z;
      z = make_float4(p.x > 0.f ? v.x : 0.f, p.y > 0.f ? v.y : 0.f, p.z > 0.f ? v.z : 0.f,
                      p.w > 0.f ? v.w : 0.f);
    });
    __syncthreads();
    // dwh = h^T dz1, db1; the sum of dz1 over the positions into T
    din::block_mm_tn_acc<T>(H, s.ldh, R1, s.ld1, s.M, D, s.A1, slot + o.wh);
    din::block_colsum_acc<T>(R1, s.ld1, nullptr, s.M, s.A1, slot + o.b1);
    for (int i = threadIdx.x; i < s.R * s.A1; i += blockDim.x) {
      const int r = i / s.A1, c = i - r * s.A1;
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc += R1[(r * L + l) * s.ld1 + c];
      Tt[r * s.ldt + c] = acc;
    }
    __syncthreads();
    // dwt = t^T (sum_l dz1_l); d hist = w dpooled + dz1 wh^T; d target = dt + (sum_l dz1_l) wt^T
    din::block_mm_tn_acc<T>(X + D, s.ldx, Tt, s.ldt, s.R, D, s.A1, slot + o.wt);
    din::block_mm<5, true>(R1, s.ld1, a.wh, s.A1, s.M, s.A1, D, [&](int m, int c, float4 v) {
      const int r = m / L;
      if (r0 + r < B) {
        const float w = W[m];
        const float4 p = as4(P + r * s.ldx + c);
        as4(dhist + (static_cast<size_t>(r0) * L + m) * D + c) =
            make_float4(fmaf(w, p.x, v.x), fmaf(w, p.y, v.y), fmaf(w, p.z, v.z), fmaf(w, p.w, v.w));
      }
    });
    din::block_mm<1, true>(Tt, s.ldt, a.wt, s.A1, s.R, s.A1, D, [&](int r, int c, float4 v) {
      if (r0 + r < B) {
        const float4 p = as4(P + r * s.ldx + D + c);
        as4(dtgt + static_cast<size_t>(r0 + r) * D + c) =
            make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
      }
    });
  }
}

// The backward's attention unit, after the fc head's kernel wrote [dpooled |
// dt] into dpt [B, 2D]: din_head_bwd_kernel's tile walk without the fc head
// (the layout of din::fit_layout with fc widths of 4, its fc regions unused; P
// holds dpooled). The recompute of the attention unit runs on CUDA cores in
// both dtypes (see the note at the top); the backward's products on CUDA cores
// in float32 and on the tensor cores in bf16 (block_mm's default). Its
// slot's fc entries are the fc head kernel's and din_head_bwd_fc_kernel's: it
// zeroes and sums the attention unit's alone.
template <class T>
__global__ void __launch_bounds__(kThreads, 1)
din_head_bwd_att_kernel(const T* __restrict__ hist, const T* __restrict__ tgt,
                        din::AttentionWeights<T> a, const float* __restrict__ dpt,
                        float* __restrict__ dhist, float* __restrict__ dtgt,
                        float* __restrict__ part, long long B, din::Layout s, GradSlots o) {
  extern __shared__ __align__(16) float sm[];
  float* slot = part + static_cast<size_t>(blockIdx.x) * o.total;
  for (int j = threadIdx.x; j < o.u1; j += blockDim.x) slot[j] = 0.f;
  float* H = sm + s.oH;
  float* X = sm + s.oX;
  float* R1 = sm + s.oR1;
  float* R2 = sm + s.oR2;
  float* Tt = sm + s.oT;
  float* W = sm + s.oW;
  float* S = sm + s.oS;
  float* P = sm + s.oP;
  const int D = s.D, L = s.L, d4 = D >> 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tiles = (B + s.R - 1) / s.R;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * s.R;
    __syncthreads();  // the slot is zeroed; the previous tile's readers are done
    din::stage_tile(hist, tgt, nullptr, r0, B, s, sm);
    for (int e = threadIdx.x; e < s.R * d4; e += blockDim.x) {
      const int r = e / d4, c = (e - r * d4) * 4;
      as4(P + r * s.ldx + c) =
          r0 + r < B ? din::ldg4(dpt + (r0 + r) * 2 * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    din::attention_forward<T, false>(a, s, sm);  // CUDA cores (see the note at the top)

    // ---- the softmax: ds_l = w_l (dw_l - sum_k w_k dw_k), dw_l = dpooled . h_l
    for (int r = warp; r < s.R; r += kThreads / 32) {
      for (int l = 0; l < L; ++l) {
        const int m = r * L + l;
        float acc = 0.f;
        for (int d = lane; d < D; d += 32) acc = fmaf(P[r * s.ldx + d], H[m * s.ldh + d], acc);
        acc = din::warp_sum(acc);
        if (lane == 0) S[m] = acc;
      }
      __syncwarp();
      float wd = 0.f;
      for (int l = lane; l < L; l += 32) wd = fmaf(W[r * L + l], S[r * L + l], wd);
      wd = din::warp_sum(wd);
      for (int l = lane; l < L; l += 32) S[r * L + l] = W[r * L + l] * (S[r * L + l] - wd);
    }
    __syncthreads();

    // ---- the activation unit: dw3, db3, then dz2 in place of r2
    din::block_colsum_acc<T>(R2, s.ld2, S, s.M, s.A2, slot + o.w3);
    din::block_colsum_acc<T>(S, 1, nullptr, s.M, 1, slot + o.b3);
    __syncthreads();
    for (int i = threadIdx.x; i < s.M * s.A2; i += blockDim.x) {
      const int m = i / s.A2, c = i - m * s.A2;
      float& z = R2[m * s.ld2 + c];
      z = z > 0.f ? op<T>(S[m]) * load1(a.w3 + c) : 0.f;
    }
    __syncthreads();
    din::block_mm_tn_acc<T>(R1, s.ld1, R2, s.ld2, s.M, s.A1, s.A2, slot + o.w2);
    din::block_colsum_acc<T>(R2, s.ld2, nullptr, s.M, s.A2, slot + o.b2);
    __syncthreads();
    // dz1 = (z1 > 0) dz2 w2^T, in place of r1
    din::block_mm<10, true>(R2, s.ld2, a.w2, s.A2, s.M, s.A2, s.A1, [&](int m, int c, float4 v) {
      float4& z = as4(R1 + m * s.ld1 + c);
      const float4 p = z;
      z = make_float4(p.x > 0.f ? v.x : 0.f, p.y > 0.f ? v.y : 0.f, p.z > 0.f ? v.z : 0.f,
                      p.w > 0.f ? v.w : 0.f);
    });
    __syncthreads();
    // dwh = h^T dz1, db1; the sum of dz1 over the positions into T
    din::block_mm_tn_acc<T>(H, s.ldh, R1, s.ld1, s.M, D, s.A1, slot + o.wh);
    din::block_colsum_acc<T>(R1, s.ld1, nullptr, s.M, s.A1, slot + o.b1);
    for (int i = threadIdx.x; i < s.R * s.A1; i += blockDim.x) {
      const int r = i / s.A1, c = i - r * s.A1;
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc += R1[(r * L + l) * s.ld1 + c];
      Tt[r * s.ldt + c] = acc;
    }
    __syncthreads();
    // dwt = t^T (sum_l dz1_l); d hist = w dpooled + dz1 wh^T; d target = dt + (sum_l dz1_l) wt^T
    din::block_mm_tn_acc<T>(X + D, s.ldx, Tt, s.ldt, s.R, D, s.A1, slot + o.wt);
    din::block_mm<5, true>(R1, s.ld1, a.wh, s.A1, s.M, s.A1, D, [&](int m, int c, float4 v) {
      const int r = m / L;
      if (r0 + r < B) {
        const float w = W[m];
        const float4 p = as4(P + r * s.ldx + c);
        as4(dhist + (static_cast<size_t>(r0) * L + m) * D + c) =
            make_float4(fmaf(w, p.x, v.x), fmaf(w, p.y, v.y), fmaf(w, p.z, v.z), fmaf(w, p.w, v.w));
      }
    });
    din::block_mm<1, true>(Tt, s.ldt, a.wt, s.A1, s.R, s.A1, D, [&](int r, int c, float4 v) {
      if (r0 + r < B) {
        const float4 p = din::ldg4(dpt + (r0 + r) * 2 * D + D + c);
        as4(dtgt + static_cast<size_t>(r0 + r) * D + c) =
            make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
      }
    });
  }
}

constexpr int kFcChunk = 16;  // rows staged at a time by din_head_bwd_fc_kernel, at most
// staged floats a row of kFcChunk rows may hold, pads included
constexpr int kFcWidest = static_cast<int>(din::kSmemLimit / (sizeof(float) * kFcChunk));

// How din_head_bwd_fc_kernel stages its two products, X^T Z with (K, N) (2D, F1)
// and (F1, F2): float32 rows of whole X and Z rows at a time (kFcChunk, or fewer
// where they do not fit); bf16 kFcChunk rows (one k-step of the mma) of a window
// of kw columns of X and nw of Z (all of them where they fit: K + N + 8 <=
// kFcWidest; else multiples of 16).
struct FcStage {
  int rows, kw[2], nw[2];
  size_t bytes;
};

FcStage fc_stage(int D, int F1, int F2, bool bf16) {
  FcStage st;
  const int K[2] = {2 * D, F1}, N[2] = {F1, F2};
  auto up16 = [](int n) { return (n + 15) & ~15; };
  int widest = 0;
  for (int p = 0; p < 2; ++p) {
    st.kw[p] = K[p], st.nw[p] = N[p];
    if (bf16 && K[p] + N[p] + 8 > kFcWidest) {
      st.kw[p] = min(up16(K[p]), ((kFcWidest - 16) / 2) & ~15);
      st.nw[p] = min(up16(N[p]), (kFcWidest - 8 - st.kw[p]) & ~15);
    }
    widest = max(widest, st.kw[p] + st.nw[p] + (bf16 ? 8 : 0));
  }
  st.rows = bf16 ? kFcChunk : min(kFcChunk, kFcWidest * kFcChunk / widest);
  st.bytes = sizeof(float) * static_cast<size_t>(st.rows) * widest;
  return st;
}

// G [K][N] = X [rows][K]^T Z [rows][N] over this block's rows b0 .. b1 - 1, X and Z
// in device memory (float32), staged `chunk` rows at a time (they feed nothing
// but this product); G is this block's slot. A thread owns 4 columns and up to
// 4 groups of 4 k-rows a pass, summing over the rows in order (the same order
// whatever the chunk), and writes its part of G once.
__device__ void fc_weight_grad_fma(const float* __restrict__ X, int K, const float* __restrict__ Z,
                                   int N, long long b0, long long b1, float* sm,
                                   float* __restrict__ G, int chunk) {
  const int n4 = N >> 2, k4 = K >> 2;
  const int per_pass = blockDim.x / n4;  // k-groups a pass takes, 4 a thread
  const int cg = threadIdx.x % n4, kg0 = threadIdx.x / n4, c0 = cg * 4;
  const bool active = kg0 < per_pass;
  float* xs = sm;                  // [chunk][K]
  float* zs = sm + chunk * K;      // [chunk][N]
  for (int base = 0; base < k4; base += 4 * per_pass) {
    float acc[4][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][i][q] = 0.f;
      }
    }
    for (long long m0 = b0; m0 < b1; m0 += chunk) {
      const int rows = static_cast<int>(min(static_cast<long long>(chunk), b1 - m0));
      __syncthreads();  // the previous chunk's readers are done
      for (int i = threadIdx.x; i < rows * k4; i += blockDim.x) {
        const int r = i / k4, c = (i - r * k4) * 4;
        as4(xs + r * K + c) = din::ldg4(X + static_cast<size_t>(m0 + r) * K + c);
      }
      for (int i = threadIdx.x; i < rows * n4; i += blockDim.x) {
        const int r = i / n4, c = (i - r * n4) * 4;
        as4(zs + r * N + c) = din::ldg4(Z + static_cast<size_t>(m0 + r) * N + c);
      }
      __syncthreads();
      if (!active) continue;
      for (int m = 0; m < rows; ++m) {
        const float4 z = *reinterpret_cast<const float4*>(zs + m * N + c0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kg = base + kg0 + j * per_pass;
          if (kg < k4) {
            const float4 x = *reinterpret_cast<const float4*>(xs + m * K + kg * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[j][i][q] = fmaf(din::at(x, i), din::at(z, q), acc[j][i][q]);
            }
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kg = base + kg0 + j * per_pass;
        if (kg < k4) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            as4(G + static_cast<size_t>(kg * 4 + i) * N + c0) =
                make_float4(acc[j][i][0], acc[j][i][1], acc[j][i][2], acc[j][i][3]);
          }
        }
      }
    }
  }
}

constexpr int kFcTasks = 8;  // tasks a warp holds in registers a pass (fc_weight_grad_mma)

// fc_weight_grad_fma's product for bf16, on the tensor cores. A chunk of kFcChunk rows is one
// step of the mma's reduction. G is taken a window at a time: its rows k_lo ..
// k_lo + kw - 1 by its columns n_lo .. n_lo + nw - 1 (all of G where X's and Z's
// rows fit in shared memory together), for which a chunk stages kw columns of X
// and nw of Z. In a window a warp takes tasks of one m16 tile of G's rows by
// kMmaNT n8 tiles, up to kFcTasks of them a pass (every chunk of the block's
// rows staged once a pass), in a fixed order, and writes its part of G once;
// each element of G sums over the chunks in row order whatever the windows, so
// they do not change the results. The staged rows are the values as op<bf16>
// rounds them, with a row stride of width + 4 floats so that a warp's reads of
// two rows 2t apart and 8 neighbouring columns fall in 32 different banks;
// staged rows past b1 are zeros.
__device__ void fc_weight_grad_mma(const float* __restrict__ X, int K, const float* __restrict__ Z,
                                   int N, long long b0, long long b1, float* sm,
                                   float* __restrict__ G, int kw, int nw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int ldx = kw + 4, ldz = nw + 4;
  float* xs = sm;                  // [kFcChunk][ldx]
  float* zs = sm + kFcChunk * ldx;  // [kFcChunk][ldz]
  for (int k_lo = 0; k_lo < K; k_lo += kw) {
    const int kn = min(kw, K - k_lo), k4 = kn >> 2;
    for (int n_lo = 0; n_lo < N; n_lo += nw) {
      const int nn = min(nw, N - n_lo), n4 = nn >> 2;
      const int groups = (nn + 8 * din::kMmaNT - 1) / (8 * din::kMmaNT);
      const int tasks = ((kn + 15) >> 4) * groups;
      for (int base = 0; base < tasks; base += warps * kFcTasks) {
        float acc[kFcTasks][din::kMmaNT][4];
#pragma unroll
        for (int q = 0; q < kFcTasks; ++q) {
#pragma unroll
          for (int j = 0; j < din::kMmaNT; ++j) acc[q][j][0] = acc[q][j][1] = acc[q][j][2] = acc[q][j][3] = 0.f;
        }
        for (long long m0 = b0; m0 < b1; m0 += kFcChunk) {
          const int rows = static_cast<int>(min(static_cast<long long>(kFcChunk), b1 - m0));
          __syncthreads();  // the previous chunk's readers are done
          for (int i = threadIdx.x; i < kFcChunk * k4; i += blockDim.x) {
            const int r = i / k4, c = (i - r * k4) * 4;
            as4(xs + r * ldx + c) =
                r < rows ? din::op4<Bf16>(din::ldg4(X + static_cast<size_t>(m0 + r) * K + k_lo + c))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          for (int i = threadIdx.x; i < kFcChunk * n4; i += blockDim.x) {
            const int r = i / n4, c = (i - r * n4) * 4;
            as4(zs + r * ldz + c) =
                r < rows ? din::op4<Bf16>(din::ldg4(Z + static_cast<size_t>(m0 + r) * N + n_lo + c))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          __syncthreads();
          const int m = 2 * t;
#pragma unroll
          for (int q = 0; q < kFcTasks; ++q) {
            const int task = base + q * warps + warp;
            if (task >= tasks) continue;  // warp-uniform
            const int ka = (task / groups) * 16 + g, kb = ka + 8, n0 = (task % groups) * 8 * din::kMmaNT;
            auto x = [&](int r, int k) { return k < kn ? xs[r * ldx + k] : 0.f; };
            const uint32_t a[4] = {din::pack_bf16(x(m, ka), x(m + 1, ka)),
                                   din::pack_bf16(x(m, kb), x(m + 1, kb)),
                                   din::pack_bf16(x(m + 8, ka), x(m + 9, ka)),
                                   din::pack_bf16(x(m + 8, kb), x(m + 9, kb))};
#pragma unroll
            for (int j = 0; j < din::kMmaNT; ++j) {
              const int n = n0 + 8 * j + g;
              auto z = [&](int r) { return n < nn ? zs[r * ldz + n] : 0.f; };
              const uint32_t b[2] = {din::pack_bf16(z(m), z(m + 1)), din::pack_bf16(z(m + 8), z(m + 9))};
              din::mma_bf16(acc[q][j], a, b);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kFcTasks; ++q) {
          const int task = base + q * warps + warp;
          if (task >= tasks) continue;
          const int ka = (task / groups) * 16 + g, kb = ka + 8, n0 = (task % groups) * 8 * din::kMmaNT;
#pragma unroll
          for (int j = 0; j < din::kMmaNT; ++j) {
            const int c = n0 + 8 * j + 2 * t;
            if (c >= nn) continue;
            float* o = G + static_cast<size_t>(k_lo) * N + n_lo + c;
            if (ka < kn) *reinterpret_cast<float2*>(o + static_cast<size_t>(ka) * N) = make_float2(acc[q][j][0], acc[q][j][1]);
            if (kb < kn) *reinterpret_cast<float2*>(o + static_cast<size_t>(kb) * N) = make_float2(acc[q][j][2], acc[q][j][3]);
          }
        }
      }
    }
  }
}

// The fc head's weight gradients from the rows the split's fc head (or
// din_head_bwd_kernel<float>) wrote: block b takes
// a contiguous run of rows and writes du1 = [pooled | t]^T dzf1 and du2 = f1^T
// dzf2 over them into its slot.
template <class T>
__global__ void __launch_bounds__(kThreads)
din_head_bwd_fc_kernel(const float* __restrict__ rows, float* __restrict__ part, long long B,
                       int D, int F1, int F2, GradSlots o, FcStage st) {
  extern __shared__ __align__(16) float sm[];
  const float* xg = rows;
  const float* f1g = xg + static_cast<size_t>(B) * 2 * D;
  const float* z1g = f1g + static_cast<size_t>(B) * F1;
  const float* z2g = z1g + static_cast<size_t>(B) * F1;
  const long long per = (B + gridDim.x - 1) / gridDim.x;
  const long long b0 = min(B, per * blockIdx.x), b1 = min(B, b0 + per);
  float* slot = part + static_cast<size_t>(blockIdx.x) * o.total;
  if constexpr (std::is_same_v<T, Bf16>) {
    fc_weight_grad_mma(xg, 2 * D, z1g, F1, b0, b1, sm, slot + o.u1, st.kw[0], st.nw[0]);
    fc_weight_grad_mma(f1g, F1, z2g, F2, b0, b1, sm, slot + o.u2, st.kw[1], st.nw[1]);
  } else {
    fc_weight_grad_fma(xg, 2 * D, z1g, F1, b0, b1, sm, slot + o.u1, st.rows);
    fc_weight_grad_fma(f1g, F1, z2g, F2, b0, b1, sm, slot + o.u2, st.rows);
  }
}

// grad [total] = the nparts slots of part [nparts, total], summed in block order.
__global__ void __launch_bounds__(256)
din_head_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ grad, int nparts,
                           int total) {
  for (int j = blockIdx.x * 256 + threadIdx.x; j < total; j += gridDim.x * 256) {
    float acc = 0.f;
    for (int b = 0; b < nparts; ++b) acc += part[static_cast<size_t>(b) * total + j];
    grad[j] = acc;
  }
}

bool layout_for(long long B, int L, int D, int A1, int A2, int F1, int F2, bool backward,
                din::Layout* s) {
  return din::widths_ok(B, L, D, A1, A2, F1, F2) &&
         din::fit_layout(L, D, A1, A2, F1, F2, backward, s);
}

// The widest fc layers (F1, F2) at which the bf16 forward that keeps its pooled
// rows multiplies its attention unit on the tensor cores. Those rows feed the
// backward's fc head, whose masks follow the k-order sums on CUDA cores; where
// a pooled value rounds to another bf16 than the k-order one, each of the row's
// fc inputs moves, and the rows the backward then holds off its plain version
// grow with the fc widths. With the tensor cores at every width, over seeds
// 0-39 on an H100 (tools/probe_din_bf16_bwd_seeds.py --tensor-pool 4096 4096),
// every seed met chip_smoke.py's bf16 backward check at fc (256, 128) (the
// train batch), (512, 128) and (1024, 128), and 5, 5 and 14 seeds missed it at
// (512, 512), (1024, 1024) and (2048, 2048) (20,000 rows); so the tensor cores
// keep the widths within the widest passing pair, and wider fc layers take the
// attention unit on CUDA cores in k order. A forward that keeps no pooled rows
// takes the tensor cores at every width.
constexpr int kTensorPoolF1 = 1024;
constexpr int kTensorPoolF2 = 128;

template <class T, bool kKOrder = false>
int launch_fwd(const void* hist, const void* tgt, const void* const* weights, void* out,
               void* pooled, long long B, const din::Layout& s, cudaStream_t stream) {
  const size_t smem = din::smem_bytes(s);
  int blocks = 0;
  const cudaError_t err =
      din::persistent_blocks(din::din_fwd_kernel<T, kKOrder>, smem, (B + s.R - 1) / s.R, &blocks);
  if (err != cudaSuccess) return err;
  din::AttentionWeights<T> a;
  din::FcWeights<T> f;
  split_weights(weights, &a, &f);
  din::din_fwd_kernel<T, kKOrder><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(hist), static_cast<const T*>(tgt), a, f, static_cast<T*>(out),
      static_cast<float*>(pooled), B, s);
  return cudaGetLastError();
}

int launch_bwd(const void* hist, const void* tgt, const void* const* weights, const void* g,
               void* dhist, void* dtgt, void* part, void* rows, long long B, const din::Layout& s,
               GradSlots o, int blocks, cudaStream_t stream) {
  const size_t smem = din::smem_bytes(s);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        din_head_bwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  din::AttentionWeights<float> a;
  din::FcWeights<float> f;
  split_weights(weights, &a, &f);
  din_head_bwd_kernel<float><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(hist), static_cast<const float*>(tgt), a, f, static_cast<const float*>(g),
      static_cast<float*>(dhist), static_cast<float*>(dtgt), static_cast<float*>(part),
      static_cast<float*>(rows), B, s, o);
  return cudaGetLastError();
}

template <class T>
int launch_bwd_fc(const void* rows, void* part, long long B, int D, int F1, int F2, GradSlots o,
                  int blocks, cudaStream_t stream) {
  const FcStage st = fc_stage(D, F1, F2, std::is_same_v<T, Bf16>);
  if (st.rows < 1 || st.bytes > din::kSmemLimit) return cudaErrorInvalidValue;
  if (st.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        din_head_bwd_fc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(st.bytes));
    if (err != cudaSuccess) return err;
  }
  din_head_bwd_fc_kernel<T><<<blocks, kThreads, st.bytes, stream>>>(
      static_cast<const float*>(rows), static_cast<float*>(part), B, D, F1, F2, o, st);
  return cudaGetLastError();
}

// The float32 forward's two tensor-core launches take these widths: the attention
// stage's layout (din_pool.cuh) and the fc head's block fit.
bool tf32_forward_fits(int L, int D, int A1, int A2, int F1, int F2, dinpool::PoolLayout* ps,
                       FcLayout* fs) {
  return dinpool::fit_layout(L, D, A1, A2, ps) && fit_fc_layout(D, F1, F2, fs);
}

// The backward's split (the fc head's kernel, then din_head_bwd_att_kernel<T>)
// takes these widths: the attention unit's tile (din::fit_layout without the
// fc head: fc widths 4), the streamed fc head's smallest tile (which float32
// takes only where din_head_bwd_fc_head_kernel's does not fit), and the stage
// that writes the pooled rows: for float32 the forward on the tensor cores
// (din_pool_kernel<., true> beside din_head_fc_kernel), for bf16 din_fwd_kernel.
bool split_backward_fits(int L, int D, int A1, int A2, int F1, int F2, bool bf16, din::Layout* as) {
  FcStreamLayout ss;
  if (!din::fit_layout(L, D, A1, A2, 4, 4, true, as) || !fit_fc_stream_layout(D, F1, F2, bf16, 1, 0, &ss)) {
    return false;
  }
  din::Layout fw;
  dinpool::PoolLayout pl;
  FcLayout fl;
  return bf16 ? din::fit_layout(L, D, A1, A2, F1, F2, false, &fw)
              : tf32_forward_fits(L, D, A1, A2, F1, F2, &pl, &fl);
}

template <class T>
int launch_bwd_fc_stream(const void* pooled, const void* tgt, const void* const* weights,
                         const void* g, void* dpt, void* rows, void* part, long long B, int D,
                         int A1, int A2, int F1, int F2, int blocks, cudaStream_t stream) {
  FcStreamLayout fs;
  if (!fit_fc_stream_layout(D, F1, F2, std::is_same_v<T, Bf16>, B, blocks, &fs)) return cudaErrorInvalidValue;
  din::AttentionWeights<T> a;
  din::FcWeights<T> f;
  split_weights(weights, &a, &f);
  const size_t smem = sizeof(float) * static_cast<size_t>(fs.total);
  const cudaError_t err = cudaFuncSetAttribute(din_head_bwd_fc_stream_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  din_head_bwd_fc_stream_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(pooled), static_cast<const T*>(tgt), static_cast<const float*>(g), f,
      fc_mats(f, D, F1, F2), static_cast<float*>(dpt), static_cast<float*>(rows),
      static_cast<float*>(part), B, fs, grad_slots(D, A1, A2, F1, F2));
  return cudaGetLastError();
}

template <class T>
int launch_bwd_att(const void* hist, const void* tgt, const void* const* weights, const void* dpt,
                   void* dhist, void* dtgt, void* part, long long B, int D, int A1, int A2, int F1,
                   int F2, const din::Layout& s, int blocks, cudaStream_t stream) {
  din::AttentionWeights<T> a;
  din::FcWeights<T> f;
  split_weights(weights, &a, &f);
  const size_t smem = din::smem_bytes(s);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        din_head_bwd_att_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  din_head_bwd_att_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(hist), static_cast<const T*>(tgt), a, static_cast<const float*>(dpt),
      static_cast<float*>(dhist), static_cast<float*>(dtgt), static_cast<float*>(part), B, s,
      grad_slots(D, A1, A2, F1, F2));
  return cudaGetLastError();
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem))
                          : cudaSuccess;
}

}  // namespace

extern "C" {

const char* din_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int din_head_max_history() { return din::kMaxHistory; }

// The slot layout of the weight gradients: the 13 offsets (wh, wt, b1, w2, b2,
// w3, b3, u1, c1, u2, c2, u3, c3) into offsets, and the slot's size as the result.
int din_head_grad_offsets(int D, int A1, int A2, int F1, int F2, int* offsets) {
  const GradSlots o = grad_slots(D, A1, A2, F1, F2);
  const int values[kGrads] = {o.wh, o.wt, o.b1, o.w2, o.b2, o.w3, o.b3,
                              o.u1, o.c1, o.u2, o.c2, o.u3, o.c3};
  for (int i = 0; i < kGrads; ++i) offsets[i] = values[i];
  return o.total;
}

// Which of the head's tile layouts fit a block's shared memory at these widths
// (0 for widths din::widths_ok refuses), as bits: 1 the forward's
// (din_fwd_kernel), 2 the float32 backward's (din_head_bwd_kernel), 4 the window pool's
// (din_pool.cuh), 8 the float32 forward on the tensor cores (din_head_fwd_pool
// and din_head_fwd_fc; else din_fwd_kernel<float>), 16 the float32 backward's
// split and 32 the bf16 backward's (split_backward_fits: the pooled rows,
// din_head_bwd_fc_head and din_head_bwd_att; without it float32 takes
// din_head_bwd and bf16 has no backward).
// ops/cuda/din_head.py::fits mirrors it.
int din_head_fits(int L, int D, int A1, int A2, int F1, int F2) {
  if (!din::widths_ok(1, L, D, A1, A2, F1, F2)) return 0;
  din::Layout s;
  dinpool::PoolLayout ps;
  FcLayout fs;
  return (din::fit_layout(L, D, A1, A2, F1, F2, false, &s) ? 1 : 0) |
         (din::fit_layout(L, D, A1, A2, F1, F2, true, &s) ? 2 : 0) |
         (dinpool::fit_layout(L, D, A1, A2, &ps) ? 4 : 0) |
         (tf32_forward_fits(L, D, A1, A2, F1, F2, &ps, &fs) ? 8 : 0) |
         (split_backward_fits(L, D, A1, A2, F1, F2, false, &s) ? 16 : 0) |
         (split_backward_fits(L, D, A1, A2, F1, F2, true, &s) ? 32 : 0);
}

// hist [B, L, D], tgt [B, D] and the 14 weights (in din_head_weights' order), all
// f32 (bf16 = 0) or all bf16 (bf16 = 1) -> logits out [B] in the same dtype, and,
// unless pooled is null, the pooled rows [B, D] f32 (din_fwd_kernel's, for the
// bf16 backward's split; past fc (kTensorPoolF1, kTensorPoolF2) its attention
// unit then sums on CUDA cores in k order, so those logits differ in bits from
// a call without pooled).
int din_head_fwd(const void* hist, const void* tgt, const void* const* weights, void* out,
                 void* pooled, long long B, int L, int D, int A1, int A2, int F1, int F2, int bf16,
                 void* stream) {
  din::Layout s;
  if (!layout_for(B, L, D, A1, A2, F1, F2, false, &s)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_fwd<float>(hist, tgt, weights, out, pooled, B, s, st);
  return pooled != nullptr && (F1 > kTensorPoolF1 || F2 > kTensorPoolF2)
             ? launch_fwd<Bf16, true>(hist, tgt, weights, out, pooled, B, s, st)
             : launch_fwd<Bf16>(hist, tgt, weights, out, pooled, B, s, st);
}

// The float32 forward's attention stage: din_pool_kernel with b3 kept (din_pool.cuh):
// hist [B, L, D], tgt [B, D] and the 14 weights, f32 -> pooled [B, D] f32. The
// float32 backward on the tensor cores launches it too, for its pooled rows.
int din_head_fwd_pool(const void* hist, const void* tgt, const void* const* weights, void* pooled,
                      long long B, int L, int D, int A1, int A2, int F1, int F2, void* stream) {
  dinpool::PoolLayout ps;
  FcLayout fs;
  if (!din::widths_ok(B, L, D, A1, A2, F1, F2) || !tf32_forward_fits(L, D, A1, A2, F1, F2, &ps, &fs)) {
    return cudaErrorInvalidValue;
  }
  const auto* w = reinterpret_cast<const float* const*>(weights);
  const dinpool::PoolWeights a{w[0], w[1], w[2], w[3], w[4], w[5]};
  const auto* h = static_cast<const float*>(hist);
  const auto* t = static_cast<const float*>(tgt);
  auto* o = static_cast<float*>(pooled);
  const auto st = static_cast<cudaStream_t>(stream);
  return ps.on_chip ? dinpool::launch<true, true>(h, t, a, o, B, ps, st, w[6])
                    : dinpool::launch<false, true>(h, t, a, o, B, ps, st, w[6]);
}

// The float32 forward's fc head: pooled [B, D] (din_head_fwd_pool's), tgt [B, D]
// and the 14 weights -> logits out [B], f32.
int din_head_fwd_fc(const void* pooled, const void* tgt, const void* const* weights, void* out,
                    long long B, int L, int D, int A1, int A2, int F1, int F2, void* stream) {
  dinpool::PoolLayout ps;
  FcLayout fs;
  if (!din::widths_ok(B, L, D, A1, A2, F1, F2) || !tf32_forward_fits(L, D, A1, A2, F1, F2, &ps, &fs)) {
    return cudaErrorInvalidValue;
  }
  din::AttentionWeights<float> a;
  din::FcWeights<float> f;
  split_weights(weights, &a, &f);
  const size_t smem = sizeof(float) * static_cast<size_t>(fs.total);
  const cudaError_t err = set_smem(reinterpret_cast<const void*>(din_head_fc_kernel), smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (B + fs.R - 1) / fs.R;
  din_head_fc_kernel<<<static_cast<unsigned>(blocks), kFcThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pooled), static_cast<const float*>(tgt), f,
      din::Tf32Mat{f.u1p, f.u1t, D, 2 * D, F1}, din::Tf32Mat{f.u2, nullptr, F1, F1, F2},
      static_cast<float*>(out), B, fs);
  return cudaGetLastError();
}

// The number of blocks (slots) the backward launches, for the launcher to size
// part [blocks, slot size]: for the split (din_head_fits' bit 16 for float32,
// 32 for bf16) the persistent grid of din_head_bwd_att_kernel, which the fc
// head's kernel then takes too; else, in float32, of din_head_bwd_kernel; -1
// where neither takes the widths.
int din_head_bwd_blocks(long long B, int L, int D, int A1, int A2, int F1, int F2, int bf16) {
  din::Layout s;
  int blocks = 0;
  cudaError_t err;
  if (!din::widths_ok(B, L, D, A1, A2, F1, F2)) return -1;
  if (split_backward_fits(L, D, A1, A2, F1, F2, bf16, &s)) {
    const long long tiles = (B + s.R - 1) / s.R;
    err = bf16 ? din::persistent_blocks(din_head_bwd_att_kernel<Bf16>, din::smem_bytes(s), tiles, &blocks)
               : din::persistent_blocks(din_head_bwd_att_kernel<float>, din::smem_bytes(s), tiles, &blocks);
  } else {
    if (bf16 || !layout_for(B, L, D, A1, A2, F1, F2, true, &s)) return -1;
    const long long tiles = (B + s.R - 1) / s.R;
    err = din::persistent_blocks(din_head_bwd_kernel<float>, din::smem_bytes(s), tiles, &blocks);
  }
  return err == cudaSuccess ? blocks : -1;
}

// The forward's inputs (f32, or bf16 with bf16 = 1) and the logit cotangent g [B]
// f32 -> dhist [B, L, D], dtgt [B, D], the per-block slots part [blocks, slot
// size] (all but the fc head's du1, du2) and the fc head's rows for
// din_head_bwd_fc: rows [B, 2D + 2 F1 + F2] as [pooled | t] [B, 2D], f1 [B, F1],
// dzf1 [B, F1], dzf2 [B, F2]; all outputs f32; `blocks` as din_head_bwd_blocks
// gave it. One launch of din_head_bwd_kernel<float>: the float32 path where
// din_head_fits has no split bit (bf16 = 1 is refused: bf16 has the split only).
int din_head_bwd(const void* hist, const void* tgt, const void* const* weights, const void* g,
                 void* dhist, void* dtgt, void* part, void* rows, long long B, int L, int D,
                 int A1, int A2, int F1, int F2, int blocks, int bf16, void* stream) {
  din::Layout s;
  if (bf16 || !layout_for(B, L, D, A1, A2, F1, F2, true, &s) || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  return launch_bwd(hist, tgt, weights, g, dhist, dtgt, part, rows, B, s, grad_slots(D, A1, A2, F1, F2),
                    blocks, static_cast<cudaStream_t>(stream));
}

// The split's fc head: pooled [B, D] (f32: din_head_fwd_pool's; bf16:
// din_head_fwd's), tgt [B, D] and the 14 weights (f32, or bf16 with bf16 = 1)
// and g [B] f32 -> dpt [B, 2D] = [dpooled | dt], the rows as din_head_bwd writes
// them, and the fc head's bias gradients and du3 into the slots of part;
// `blocks` as din_head_bwd_blocks gave it. float32: din_head_bwd_fc_head_kernel
// where its tile fits, else din_head_bwd_fc_stream_kernel<float>; bf16:
// din_head_bwd_fc_stream_kernel<bf16>.
int din_head_bwd_fc_head(const void* pooled, const void* tgt, const void* const* weights,
                         const void* g, void* dpt, void* rows, void* part, long long B, int L,
                         int D, int A1, int A2, int F1, int F2, int blocks, int bf16, void* stream) {
  din::Layout as;
  FcBwdLayout fs;
  if (!din::widths_ok(B, L, D, A1, A2, F1, F2) || !split_backward_fits(L, D, A1, A2, F1, F2, bf16, &as) ||
      blocks < 1) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_bwd_fc_stream<Bf16>(pooled, tgt, weights, g, dpt, rows, part, B, D, A1, A2, F1, F2,
                                      blocks, st);
  }
  if (!fit_fc_bwd_layout(D, F1, F2, &fs)) {
    return launch_bwd_fc_stream<float>(pooled, tgt, weights, g, dpt, rows, part, B, D, A1, A2, F1, F2,
                                       blocks, st);
  }
  din::AttentionWeights<float> a;
  din::FcWeights<float> f;
  split_weights(weights, &a, &f);
  const size_t smem = sizeof(float) * static_cast<size_t>(fs.total);
  const cudaError_t err = set_smem(reinterpret_cast<const void*>(din_head_bwd_fc_head_kernel), smem);
  if (err != cudaSuccess) return err;
  din_head_bwd_fc_head_kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const float*>(pooled), static_cast<const float*>(tgt), static_cast<const float*>(g), f,
      din::Tf32Mat{f.u1p, f.u1t, D, 2 * D, F1}, din::Tf32Mat{f.u2, nullptr, F1, F1, F2},
      din::Tf32MatT{f.u2, nullptr, F1, F1, F2}, din::Tf32MatT{f.u1p, f.u1t, D, 2 * D, F1},
      static_cast<float*>(dpt), static_cast<float*>(rows), static_cast<float*>(part), B, fs,
      grad_slots(D, A1, A2, F1, F2));
  return cudaGetLastError();
}

// The split's attention unit (din_head_bwd_att_kernel<T>): hist [B, L, D], tgt
// [B, D], the 14 weights (f32, or bf16 with bf16 = 1) and dpt (din_head_bwd_fc_head's)
// -> dhist, dtgt (f32) and the attention unit's weight gradients into the
// slots of part.
int din_head_bwd_att(const void* hist, const void* tgt, const void* const* weights, const void* dpt,
                     void* dhist, void* dtgt, void* part, long long B, int L, int D, int A1, int A2,
                     int F1, int F2, int blocks, int bf16, void* stream) {
  din::Layout s;
  if (!din::widths_ok(B, L, D, A1, A2, F1, F2) || !split_backward_fits(L, D, A1, A2, F1, F2, bf16, &s) ||
      blocks < 1) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_att<Bf16>(hist, tgt, weights, dpt, dhist, dtgt, part, B, D, A1, A2, F1, F2, s,
                                     blocks, st)
              : launch_bwd_att<float>(hist, tgt, weights, dpt, dhist, dtgt, part, B, D, A1, A2, F1, F2, s,
                                      blocks, st);
}

// The fc head's weight gradients into the slots of part, from the rows
// din_head_bwd or din_head_bwd_fc_head wrote (rounded to bf16 as they enter the
// products when bf16 = 1); `blocks` as din_head_bwd_blocks gave it.
int din_head_bwd_fc(const void* rows, void* part, long long B, int D, int A1, int A2, int F1,
                    int F2, int blocks, int bf16, void* stream) {
  if (!din::widths_ok(B, 1, D, A1, A2, F1, F2) || blocks < 1 || F1 > 4 * kThreads ||
      F2 > 4 * kThreads) {
    return cudaErrorInvalidValue;
  }
  const GradSlots o = grad_slots(D, A1, A2, F1, F2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_fc<Bf16>(rows, part, B, D, F1, F2, o, blocks, st)
              : launch_bwd_fc<float>(rows, part, B, D, F1, F2, o, blocks, st);
}

// grad [total] f32 from the nparts slots of din_head_bwd.
int din_head_bwd_reduce(const void* part, void* grad, int nparts, int total, void* stream) {
  if (nparts < 1 || total < 1) return cudaErrorInvalidValue;
  const int blocks = min((total + 255) / 256, 1024);
  din_head_bwd_reduce_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(grad), nparts, total);
  return cudaGetLastError();
}

}  // extern "C"
