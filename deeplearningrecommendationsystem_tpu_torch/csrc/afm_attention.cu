// AFM attention pooling for Hopper (sm_90a), forward and backward, with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels of
//   deeplearningrecommendationsystem_tpu/ops/pallas/afm_attention.py:
//   * afm_attention_pool_pallas (_make_kernel)                 -> afm_pool_fwd_kernel
//   * afm_attention_pool_fused's backward (_make_bwd_kernel)   -> afm_pool_bwd_kernel
//                                                                + afm_pool_bwd_reduce_kernel
// Their plain PyTorch versions are afm_attention_pool_plain and
// afm_attention_pool_bwd_plain in deeplearningrecommendationsystem_tpu_torch/ops/afm_attention.py.
//
// What they compute, per row of fields e [6, D] and with W [D, A], b [A], h [A]:
// for the 15 pairs p = (i, j), i < j, in the order (0,1), (0,2), ..., (4,5),
//   c_p = e_i * e_j,  z_p = c_p W + b,  s_p = relu(z_p) . h,  w = softmax_p(s),
//   pooled = sum_p w_p c_p                                               [D]
// and, given the pooled cotangent g [D], the backward: dwts_p = g . c_p,
// ds_p = w_p (dwts_p - sum_q w_q dwts_q), dz_p = (z_p > 0) ds_p h,
// dc_p = w_p g + W dz_p, de_i += dc_p e_j, de_j += dc_p e_i per row, and the sums
// over all rows dW = sum c_p^T dz_p, db = sum dz_p, dh = sum relu(z_p) ds_p.
//
// Bound: operations. A row's forward is 15 x 2 D A = 245,760 products at the AFM
// preset (D 128, A 64) and reads 3 KB. In float32 accuracy on the tensor cores
// (3xTF32, tf32_mma.cuh) the 87,900-row train batch takes 0.131 ms at 495
// TFLOP/s against 0.094 ms for its bytes (0.335 ms as float32 FMAs on CUDA
// cores); the backward does about three times the forward's work (the forward
// again, W dz for dc, and the dW outer products). The point of the TPU kernels,
// kept here: the [B, 15, D] pair products and the [B, 15, A] activations never
// reach device memory.
//
// The forward (afm_pool_fwd_kernel) is one GEMM, [B 15, D] x [D, A], whose A
// operand is made on the fly. Persistent blocks (one an SM) stage W once,
// pre-split into TF32 hi and lo parts (64 KB at the preset), with b and h. A
// block is two groups of 8 warps, each walking its own tiles of 16 rows with
// its own buffer, copied with cp.async: while one group waits for its copy or
// runs its epilogue, the other's products keep the tensor cores busy. A warp
// takes two rows of its group's tile; a row's 15 pairs are an m16 tile (the
// 16th row zeros). Each lane forms its A elements c = e_i[k] e_j[k] from the
// staged fields and splits them once per k-step (slot t takes k0 + 2t, slot t +
// 4 takes k0 + 2t + 1, so a lane's fields and its B fragment are 8- and 16-byte
// loads), and every B fragment feeds both rows' mma.sync m16n8k8, over column
// panels of 64, the three products of 3xTF32 pass by pass over two n8 tiles at
// a time (more B fragments in registers would spill). The epilogue adds b,
// takes the relu, multiplies by h and sums the quad by shuffles; the softmax
// over the pairs runs across the warp's quads by shuffles, and the pool sum_p
// w_p c_p recomputes c from the staged fields in float32 on CUDA cores, in pair
// order.
//
// The backward stages W and W^T in shared memory once (f32), then walks over
// tiles of R rows: the tile's fields go to shared memory, masked at load (rows
// past B are zeros, never read from memory, so no mask multiplies garbage), and
// each row is owned by NG = A_pad / 4 neighbouring lanes of a warp, a lane
// computing z for its 4 columns of A and all 15 pairs in registers with float32
// FMAs (pair_scores): it recomputes the forward so, keeps dz in shared memory
// for the tile, forms dc and de per row with W^T from shared memory, and
// accumulates dW in registers (each thread a fixed 8 x 4 patch of it) and db, dh
// per thread across all its tiles; each block writes its partial dW, db, dh
// once, and afm_pool_bwd_reduce_kernel sums the partials in block order. No
// atomics, fixed orders of summation: runs repeat bit for bit. The two
// directions sum z in other orders, so where z lies within rounding of 0 their
// relu masks may differ. Shapes: 6 fields, A <= 128 (the backward pads it with
// zero columns to a power of two of at least 16, the forward to a multiple of
// 64), and a block's shared memory and the dW patch bound D; the Python launcher
// checks them.
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

using tf32mma::cp_async16_or_zero;
using tf32mma::cp_async4_or_zero;
using tf32mma::cp_async_commit;
using tf32mma::cp_async_wait_all;
using tf32mma::mma_3xtf32;
using tf32mma::split_tf32_bits;

constexpr int kThreads = 256;
constexpr int kF = 6;     // fields
constexpr int kP = 15;    // pairs
constexpr int kMaxJD = 8;  // d rows of dW per thread in the backward
constexpr int kRowPad = 4;  // floats after each staged row: shifts banks, keeps 16-byte alignment
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPanel = 8;  // n8 tiles of the forward's column panel
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use on Hopper

__device__ __forceinline__ constexpr int pair_i(int p) {
  return p < 5 ? 0 : p < 9 ? 1 : p < 12 ? 2 : p < 14 ? 3 : 4;
}
__device__ __forceinline__ constexpr int pair_j(int p) {
  return p + 1 - (p < 5 ? 0 : p < 9 ? 4 : p < 12 ? 7 : p < 14 ? 9 : 10);
}

// Sizes shared by host and device: D padded to 4, A padded to 4 * NG.
struct Shape {
  int D, A, Dp, Ap, NG, R, ES, DZS;
};

Shape make_shape(int D, int A) {
  Shape s;
  s.D = D;
  s.A = A;
  s.Dp = (D + 3) & ~3;
  int ap = 16;
  while (ap < A) ap *= 2;
  s.Ap = ap;
  s.NG = ap / 4;
  s.R = kThreads / s.NG;
  s.ES = kF * s.Dp + kRowPad;
  s.DZS = kP * s.Ap + kRowPad;
  return s;
}

size_t bwd_smem_floats(const Shape& s) {
  return static_cast<size_t>(s.R) * s.ES + static_cast<size_t>(s.R) * s.Dp +
         2 * static_cast<size_t>(s.Dp) * s.Ap + 2 * s.Ap + static_cast<size_t>(s.R) * s.DZS;
}

// Component q (a constant after unrolling) of a float4.
__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float group_sum(float x, int NG) {
  for (int off = NG >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// W [D, A] -> Ws [Dp][Ap], zero padded; b, h -> bs, hs [Ap]; optionally W^T -> WTs [Ap][Dp].
__device__ void stage_params(const float* __restrict__ W, const float* __restrict__ b,
                             const float* __restrict__ h, const Shape& s, float* Ws, float* bs,
                             float* hs, float* WTs) {
  for (int t = threadIdx.x; t < s.Dp * s.Ap; t += kThreads) {
    const int d = t / s.Ap, a = t - d * s.Ap;
    const float v = (d < s.D && a < s.A) ? W[static_cast<size_t>(d) * s.A + a] : 0.f;
    Ws[t] = v;
    if (WTs != nullptr) WTs[a * s.Dp + d] = v;
  }
  for (int a = threadIdx.x; a < s.Ap; a += kThreads) {
    bs[a] = a < s.A ? b[a] : 0.f;
    hs[a] = a < s.A ? h[a] : 0.f;
  }
}

// The tile's fields [rows, 6, D] -> es [R][ES] (and g [rows, D] -> gs [R][Dp]);
// rows past B and columns past D are zeros.
__device__ void stage_tile(const float* __restrict__ fields, const float* __restrict__ g,
                           long long r0, long long B, const Shape& s, float* es, float* gs) {
  const int per_row = kF * s.Dp;
  for (int t = threadIdx.x; t < s.R * per_row; t += kThreads) {
    const int r = t / per_row, rem = t - r * per_row;
    const int f = rem / s.Dp, d = rem - f * s.Dp;
    const long long row = r0 + r;
    es[r * s.ES + rem] =
        (row < B && d < s.D) ? fields[(static_cast<size_t>(row) * kF + f) * s.D + d] : 0.f;
  }
  if (gs != nullptr) {
    for (int t = threadIdx.x; t < s.R * s.Dp; t += kThreads) {
      const int r = t / s.Dp, d = t - r * s.Dp;
      const long long row = r0 + r;
      gs[t] = (row < B && d < s.D) ? g[static_cast<size_t>(row) * s.D + d] : 0.f;
    }
  }
}

// z = c_p W (no bias) for this lane's 4 columns a0 .. a0 + 3 and all 15 pairs.
__device__ __forceinline__ void pair_scores(const float* er, const float* Ws, const Shape& s,
                                            int a0, float (&z)[kP][4]) {
#pragma unroll
  for (int p = 0; p < kP; ++p) {
#pragma unroll
    for (int q = 0; q < 4; ++q) z[p][q] = 0.f;
  }
#pragma unroll 2
  for (int k = 0; k < s.Dp; ++k) {
    float e[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) e[f] = er[f * s.Dp + k];
    const float4 w = *reinterpret_cast<const float4*>(Ws + k * s.Ap + a0);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const float c = e[pair_i(p)] * e[pair_j(p)];
      z[p][0] = fmaf(c, w.x, z[p][0]);
      z[p][1] = fmaf(c, w.y, z[p][1]);
      z[p][2] = fmaf(c, w.z, z[p][2]);
      z[p][3] = fmaf(c, w.w, z[p][3]);
    }
  }
}

// z += b; the softmax weights over the pairs of the row, on every lane of its group.
__device__ __forceinline__ void attention_weights(float (&z)[kP][4], const float* bs,
                                                  const float* hs, const Shape& s, int a0,
                                                  float (&wts)[kP]) {
  float mx = -3.402823466e38f;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    float sp = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      z[p][q] += bs[a0 + q];
      sp = fmaf(fmaxf(z[p][q], 0.f), hs[a0 + q], sp);
    }
    wts[p] = group_sum(sp, s.NG);
    mx = fmaxf(mx, wts[p]);
  }
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    wts[p] = expf(wts[p] - mx);
    sum += wts[p];
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) wts[p] = wts[p] / sum;
}

// ------------------------------------------------------------------ forward
//
// The forward's layout: W pre-split for 3xTF32 and transposed, WS [Ak][ldw]
// where row n holds, for each pair of k (2kk, 2kk + 1), the four words hi
// (W[2kk][n]), hi (W[2kk + 1][n]), lo (W[2kk][n]), lo (W[2kk + 1][n]): one
// 16-byte load is a lane's B fragment, hi and lo. ldw is 16 mod 32 floats, so
// the loads of a quarter-warp (rows g, g + 1; pairs t) touch every bank once.
// A is padded with zeros to a multiple of 64 (a column panel: no mma.sync is
// predicated). bs, hs [Ak]; the fields of a tile, es [2][R][6][ldf] (ldf 8 mod 32 floats),
// two buffers. Zeros past D and A everywhere.
struct FwdShape {
  int D, A, Dk, Ak, R, ldw, ldf;
  int oW, oB, oH, oE, total;
  bool vec;  // D % 4 == 0: the fields' rows are copied 16 bytes at a time
};

constexpr int kFwdGroups = 2;  // groups of kThreads a forward block, each on its own tiles
constexpr int kFwdThreads = kFwdGroups * kThreads;
constexpr int kFwdRows = 2 * (kThreads / 32);  // a group's tile: two rows a warp
constexpr int kHalf = 2;  // B fragments in registers at once

int round_up(int n, int m) { return (n + m - 1) / m * m; }

FwdShape make_fwd_shape(int D, int A, int R) {
  FwdShape s;
  s.D = D, s.A = A, s.R = R;
  s.Dk = round_up(D, 8), s.Ak = round_up(A, 8 * kPanel);
  s.ldw = 2 * s.Dk + (16 - 2 * s.Dk % 32 + 32) % 32;
  s.ldf = s.Dk + (8 - s.Dk % 32 + 32) % 32;
  s.oW = 0;
  s.oB = s.oW + s.Ak * s.ldw;
  s.oH = s.oB + s.Ak;
  s.oE = s.oH + s.Ak;
  s.total = s.oE + kFwdGroups * R * kF * s.ldf;
  s.vec = D % 4 == 0;
  return s;
}

size_t fwd_smem_bytes(const FwdShape& s) { return sizeof(float) * static_cast<size_t>(s.total); }

// Two rows a warp: the most rows (kFwdRows, else fewer warps busy) that fit.
FwdShape fit_fwd_shape(int D, int A) {
  FwdShape s = make_fwd_shape(D, A, kFwdRows);
  for (int R = kFwdRows - 2; R >= 2 && fwd_smem_bytes(s) > kSmemLimit; R -= 2) s = make_fwd_shape(D, A, R);
  return s;
}

// The fields of rows r0 .. r0 + R - 1 into es [R][6][ldf] (columns below D),
// asynchronously: one commit group. Rows past B are zeros. Threads take fixed
// column chunks (16 bytes, or 4 where D % 4 != 0) of every rows_per-th field
// row, so the loops divide nothing.
__device__ __forceinline__ void copy_fields(const float* __restrict__ fields, long long r0,
                                            long long B, const FwdShape& s, float* es, int tid) {
  const int chunks = s.vec ? s.D >> 2 : s.D, cols = min(chunks, kThreads);
  const int rows_per = kThreads / cols, first = tid / cols, c0 = tid - first * cols;
  if (first < rows_per) {
    const int live = static_cast<int>(B - r0 < s.R ? B - r0 : s.R) * kF;  // field rows below B
    const float* f = fields + static_cast<size_t>(r0) * kF * s.D;
    for (int rf = first; rf < s.R * kF; rf += rows_per) {
      const bool in = rf < live;
      for (int c = c0; c < chunks; c += cols) {
        if (s.vec) {
          const float* src = in ? f + static_cast<size_t>(rf) * s.D + 4 * c : fields;
          cp_async16_or_zero(es + rf * s.ldf + 4 * c, src, in);
        } else {
          const float* src = in ? f + static_cast<size_t>(rf) * s.D + c : fields;
          cp_async4_or_zero(es + rf * s.ldf + c, src, in);
        }
      }
    }
  }
  cp_async_commit();
}

// One row of the tile by one warp, its 15 pairs the m16 tile's rows 0 .. 14 (row
// 15 zeros): z = c W on the tensor cores (3xTF32), two rows at once so that each
// B fragment feeds two m16 tiles; then z + b, relu, . h summed over the quad,
// the softmax over the pairs by shuffles, and the pool sum_p w_p c_p (c
// recomputed from the staged fields) into out.
__device__ __forceinline__ void pool_rows(const float* er0, const float* er1, bool two,
                                          const float* WS, const float* bs, const float* hs,
                                          const FwdShape& s, float* out0, float* out1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // this lane's pairs: g (A rows g) and g + 8 (rows g + 8; pair 15 is the zero row)
  const bool has_b = g < 7;
  const int ia = pair_i(g) * s.ldf + 2 * t, ja = pair_j(g) * s.ldf + 2 * t;
  const int ib = has_b ? pair_i(g + 8) * s.ldf + 2 * t : 0;
  const int jb = has_b ? pair_j(g + 8) * s.ldf + 2 * t : 0;
  const float* er[2] = {er0, two ? er1 : er0};
  float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};  // scores of pairs g, g + 8
  for (int n0 = 0; n0 < s.Ak; n0 += 8 * kPanel) {
    float acc[2][kPanel / kHalf][kHalf][4] = {};
    for (int k0 = 0; k0 < s.Dk; k0 += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* e = er[u] + k0;
        const float2 xi = *reinterpret_cast<const float2*>(e + ia);
        const float2 xj = *reinterpret_cast<const float2*>(e + ja);
        float2 ca = make_float2(xi.x * xj.x, xi.y * xj.y), cb = make_float2(0.f, 0.f);
        if (has_b) {
          const float2 yi = *reinterpret_cast<const float2*>(e + ib);
          const float2 yj = *reinterpret_cast<const float2*>(e + jb);
          cb = make_float2(yi.x * yj.x, yi.y * yj.y);
        }
        split_tf32_bits(ca.x, ah[u][0], al[u][0]);  // (g, slot t): k0 + 2t
        split_tf32_bits(cb.x, ah[u][1], al[u][1]);  // (g + 8, slot t)
        split_tf32_bits(ca.y, ah[u][2], al[u][2]);  // (g, slot t + 4): k0 + 2t + 1
        split_tf32_bits(cb.y, ah[u][3], al[u][3]);
      }
#pragma unroll
      for (int q = 0; q < kPanel / kHalf; ++q) {
        uint32_t bh[kHalf][2], bl[kHalf][2];
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              WS + (n0 + 8 * (q * kHalf + j) + g) * s.ldw + 2 * k0 + 4 * t);
          bh[j][0] = w.x, bh[j][1] = w.y, bl[j][0] = w.z, bl[j][1] = w.w;
        }
        mma_3xtf32(acc[0][q], ah[0], al[0], bh, bl);
        mma_3xtf32(acc[1][q], ah[1], al[1], bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(bs + c);
      const float2 h = *reinterpret_cast<const float2*>(hs + c);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* z = acc[u][j / kHalf][j % kHalf];
        sa[u] = fmaf(fmaxf(z[0] + b.x, 0.f), h.x, sa[u]);
        sa[u] = fmaf(fmaxf(z[1] + b.y, 0.f), h.y, sa[u]);
        sb[u] = fmaf(fmaxf(z[2] + b.x, 0.f), h.x, sb[u]);
        sb[u] = fmaf(fmaxf(z[3] + b.y, 0.f), h.y, sb[u]);
      }
    }
  }
  float* out[2] = {out0, out1};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u == 1 && !two) break;
    float a = sa[u], b = sb[u];
    a += __shfl_xor_sync(kFull, a, 1);
    a += __shfl_xor_sync(kFull, a, 2);
    b += __shfl_xor_sync(kFull, b, 1);
    b += __shfl_xor_sync(kFull, b, 2);
    float mx = has_b ? fmaxf(a, b) : a;
    for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    a = expf(a - mx);
    b = has_b ? expf(b - mx) : 0.f;
    float sum = a + b;
    for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(kFull, sum, off);
    a /= sum, b /= sum;
    float wts[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) wts[p] = __shfl_sync(kFull, p < 8 ? a : b, 4 * (p & 7));
    if (out[u] == nullptr) continue;
    const float* e = er[u];
    for (int d = lane; d < s.D; d += 32) {
      float ev[kF];
#pragma unroll
      for (int f = 0; f < kF; ++f) ev[f] = e[f * s.ldf + d];
      float pooled = 0.f;
#pragma unroll
      for (int p = 0; p < kP; ++p) pooled = fmaf(wts[p], ev[pair_i(p)] * ev[pair_j(p)], pooled);
      out[u][d] = pooled;
    }
  }
}

// The threads of group grp of the block meet (named barrier 1 + grp).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(kThreads) : "memory");
}

__global__ void __launch_bounds__(kFwdThreads, 1)
afm_pool_fwd_kernel(const float* __restrict__ fields, const float* __restrict__ W,
                    const float* __restrict__ b, const float* __restrict__ h,
                    float* __restrict__ out, long long B, FwdShape s) {
  extern __shared__ __align__(16) float smem[];
  const int grp = threadIdx.x / kThreads, tid = threadIdx.x - grp * kThreads;
  const int buf_floats = s.R * kF * s.ldf;
  float* es = smem + s.oE + grp * buf_floats;
  const long long tiles = (B + s.R - 1) / s.R, stride = static_cast<long long>(gridDim.x) * kFwdGroups;
  long long tile = static_cast<long long>(blockIdx.x) * kFwdGroups + grp;
  if (tile < tiles) copy_fields(fields, tile * s.R, B, s, es, tid);  // in flight during the set-up
  for (int e = threadIdx.x; e < kFwdGroups * buf_floats; e += kFwdThreads) {  // columns the copies skip
    if (e % s.ldf >= s.D) smem[s.oE + e] = 0.f;
  }
  float* WS = smem + s.oW;
  const int pairs = s.Dk / 2;
  for (int e = threadIdx.x; e < s.Ak * pairs; e += kFwdThreads) {
    const int n = e / pairs, k = 2 * (e - n * pairs);
    const bool in = n < s.A;
    const float x0 = in && k < s.D ? __ldg(W + static_cast<size_t>(k) * s.A + n) : 0.f;
    const float x1 = in && k + 1 < s.D ? __ldg(W + static_cast<size_t>(k + 1) * s.A + n) : 0.f;
    uint4 v;
    split_tf32_bits(x0, v.x, v.z);
    split_tf32_bits(x1, v.y, v.w);
    *reinterpret_cast<uint4*>(WS + n * s.ldw + 2 * k) = v;
  }
  for (int a = threadIdx.x; a < s.Ak; a += kFwdThreads) {
    smem[s.oB + a] = a < s.A ? __ldg(b + a) : 0.f;
    smem[s.oH + a] = a < s.A ? __ldg(h + a) : 0.f;
  }
  __syncthreads();  // W, b, h and the zeros in place

  // Each group walks its own tiles with one buffer: while one group waits for
  // its copy or runs its softmax and pool, the other's products keep the
  // tensor cores busy.
  const int r = 2 * (tid >> 5);  // this warp's rows of a tile: r, r + 1
  for (; tile < tiles; tile += stride) {
    const long long r0 = tile * s.R;
    cp_async_wait_all();
    group_sync(grp);  // this tile's fields are in
    if (r < s.R && r0 + r < B) {  // warp-uniform
      const float* e = es + r * kF * s.ldf;
      const bool two = r0 + r + 1 < B;
      pool_rows(e, e + kF * s.ldf, two, WS, smem + s.oB, smem + s.oH, s,
                out + static_cast<size_t>(r0 + r) * s.D,
                two ? out + static_cast<size_t>(r0 + r + 1) * s.D : nullptr);
    }
    group_sync(grp);  // the fields are free
    if (tile + stride < tiles) copy_fields(fields, (tile + stride) * s.R, B, s, es, tid);
  }
}

__global__ void __launch_bounds__(kThreads)
afm_pool_bwd_kernel(const float* __restrict__ fields, const float* __restrict__ W,
                    const float* __restrict__ b, const float* __restrict__ h,
                    const float* __restrict__ g, float* __restrict__ de,
                    float* __restrict__ dw_part, float* __restrict__ db_part,
                    float* __restrict__ dh_part, long long B, Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* es = smem;                                    // [R][ES]
  float* gs = es + static_cast<size_t>(s.R) * s.ES;    // [R][Dp]
  float* Ws = gs + static_cast<size_t>(s.R) * s.Dp;    // [Dp][Ap]
  float* WTs = Ws + static_cast<size_t>(s.Dp) * s.Ap;  // [Ap][Dp]
  float* bs = WTs + static_cast<size_t>(s.Ap) * s.Dp;  // [Ap]
  float* hs = bs + s.Ap;                               // [Ap]
  float* dzs = hs + s.Ap;                              // [R][DZS]: dz [15][Ap] of each row
  stage_params(W, b, h, s, Ws, bs, hs, WTs);
  const int rg = threadIdx.x / s.NG, ng = threadIdx.x - rg * s.NG, a0 = 4 * ng;
  const int JD = (s.Dp + s.R - 1) / s.R;  // this thread's dW rows: d = rg + R j, j < JD

  float dw_acc[kMaxJD][4], dh_acc[4], db_acc[4];
#pragma unroll
  for (int j = 0; j < kMaxJD; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) dw_acc[j][q] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) dh_acc[q] = db_acc[q] = 0.f;

  const long long tiles = (B + s.R - 1) / s.R;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * s.R;
    const int rows = static_cast<int>(min(static_cast<long long>(s.R), B - r0));
    __syncthreads();  // parameters staged; the previous tile's readers are done
    stage_tile(fields, g, r0, B, s, es, gs);
    __syncthreads();
    const float* er = es + rg * s.ES;
    const float* gr = gs + rg * s.Dp;
    float z[kP][4], wts[kP];
    pair_scores(er, Ws, s, a0, z);
    attention_weights(z, bs, hs, s, a0, wts);

    // dwts_p = g . c_p over the row, then ds
    float ds[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) ds[p] = 0.f;
    for (int d = ng; d < s.Dp; d += s.NG) {
      const float gd = gr[d];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        ds[p] = fmaf(gd, er[pair_i(p) * s.Dp + d] * er[pair_j(p) * s.Dp + d], ds[p]);
      }
    }
    float wd = 0.f;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      ds[p] = group_sum(ds[p], s.NG);
      wd = fmaf(wts[p], ds[p], wd);
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) ds[p] = wts[p] * (ds[p] - wd);

    // dz for this lane's 4 columns; dh and db sums
    float* dzr = dzs + rg * s.DZS;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      float dzq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool pos = z[p][q] > 0.f;
        dzq[q] = pos ? ds[p] * hs[a0 + q] : 0.f;
        dh_acc[q] = fmaf(pos ? z[p][q] : 0.f, ds[p], dh_acc[q]);
        db_acc[q] += dzq[q];
      }
      *reinterpret_cast<float4*>(dzr + p * s.Ap + a0) = make_float4(dzq[0], dzq[1], dzq[2], dzq[3]);
    }
    __syncthreads();  // every row's dz is in dzs

    // dW += c^T dz over the tile's rows: this thread's rows d = rg + R j, columns a0 ..
    for (int r = 0; r < rows; ++r) {
      const float* e_r = es + r * s.ES;
      float ev[kF][kMaxJD];
#pragma unroll
      for (int j = 0; j < kMaxJD; ++j) {
        const int d = rg + s.R * j;
        const bool in = j < JD && d < s.Dp;
#pragma unroll
        for (int f = 0; f < kF; ++f) ev[f][j] = in ? e_r[f * s.Dp + d] : 0.f;
      }
      const float* dz_r = dzs + r * s.DZS;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float4 dz = *reinterpret_cast<const float4*>(dz_r + p * s.Ap + a0);
#pragma unroll
        for (int j = 0; j < kMaxJD; ++j) {
          const float c = ev[pair_i(p)][j] * ev[pair_j(p)][j];
          dw_acc[j][0] = fmaf(c, dz.x, dw_acc[j][0]);
          dw_acc[j][1] = fmaf(c, dz.y, dw_acc[j][1]);
          dw_acc[j][2] = fmaf(c, dz.z, dw_acc[j][2]);
          dw_acc[j][3] = fmaf(c, dz.w, dw_acc[j][3]);
        }
      }
    }

    // dc_p = w_p g + W dz_p and de, in chunks of 4 columns of D
    const long long row = r0 + rg;
    for (int d0 = 4 * ng; d0 < s.Dp; d0 += 4 * s.NG) {
      float dc[kP][4];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dc[p][q] = 0.f;
      }
      for (int a = 0; a < s.Ap; a += 4) {
        float4 wt[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) wt[u] = *reinterpret_cast<const float4*>(WTs + (a + u) * s.Dp + d0);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const float4 dz = *reinterpret_cast<const float4*>(dzr + p * s.Ap + a);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float dzu = at(dz, u);
            dc[p][0] = fmaf(dzu, wt[u].x, dc[p][0]);
            dc[p][1] = fmaf(dzu, wt[u].y, dc[p][1]);
            dc[p][2] = fmaf(dzu, wt[u].z, dc[p][2]);
            dc[p][3] = fmaf(dzu, wt[u].w, dc[p][3]);
          }
        }
      }
      const float4 g4 = *reinterpret_cast<const float4*>(gr + d0);
      float4 e4[kF];
#pragma unroll
      for (int f = 0; f < kF; ++f) e4[f] = *reinterpret_cast<const float4*>(er + f * s.Dp + d0);
      float de_r[kF][4];
#pragma unroll
      for (int f = 0; f < kF; ++f) {
#pragma unroll
        for (int q = 0; q < 4; ++q) de_r[f][q] = 0.f;
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float c = fmaf(wts[p], at(g4, q), dc[p][q]);
          de_r[pair_i(p)][q] = fmaf(c, at(e4[pair_j(p)], q), de_r[pair_i(p)][q]);
          de_r[pair_j(p)][q] = fmaf(c, at(e4[pair_i(p)], q), de_r[pair_j(p)][q]);
        }
      }
      if (row < B) {
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          float* dst = de + (static_cast<size_t>(row) * kF + f) * s.D;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (d0 + q < s.D) dst[d0 + q] = de_r[f][q];
          }
        }
      }
    }
  }

  // this block's partial sums: dW from registers; dh, db summed over the row groups in order
  float* dwp = dw_part + static_cast<size_t>(blockIdx.x) * s.D * s.A;
#pragma unroll
  for (int j = 0; j < kMaxJD; ++j) {
    const int d = rg + s.R * j;
    if (j < JD && d < s.D) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (a0 + q < s.A) dwp[static_cast<size_t>(d) * s.A + a0 + q] = dw_acc[j][q];
      }
    }
  }
  __syncthreads();  // dzs is free: reuse it for the dh, db reduction
  float* red_h = dzs;
  float* red_b = dzs + s.R * s.Ap;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    red_h[rg * s.Ap + a0 + q] = dh_acc[q];
    red_b[rg * s.Ap + a0 + q] = db_acc[q];
  }
  __syncthreads();
  for (int a = threadIdx.x; a < s.A; a += kThreads) {
    float sh = 0.f, sb = 0.f;
    for (int r = 0; r < s.R; ++r) {
      sh += red_h[r * s.Ap + a];
      sb += red_b[r * s.Ap + a];
    }
    dh_part[static_cast<size_t>(blockIdx.x) * s.A + a] = sh;
    db_part[static_cast<size_t>(blockIdx.x) * s.A + a] = sb;
  }
}

// dW [D A], db [A], dh [A]: the nparts block partials of each, summed in block order.
__global__ void __launch_bounds__(kThreads)
afm_pool_bwd_reduce_kernel(const float* __restrict__ dw_part, const float* __restrict__ db_part,
                           const float* __restrict__ dh_part, float* __restrict__ dw,
                           float* __restrict__ db, float* __restrict__ dh, int nparts, int DA,
                           int A) {
  const int n = DA + 2 * A;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < n; j += gridDim.x * kThreads) {
    const float* src;
    int stride, col;
    float* dst;
    if (j < DA) {
      src = dw_part, stride = DA, col = j, dst = dw + j;
    } else if (j < DA + A) {
      src = db_part, stride = A, col = j - DA, dst = db + col;
    } else {
      src = dh_part, stride = A, col = j - DA - A, dst = dh + col;
    }
    float acc = 0.f;
    for (int b = 0; b < nparts; ++b) acc += src[static_cast<size_t>(b) * stride + col];
    *dst = acc;
  }
}

bool shape_ok(long long B, int D, int A) { return B >= 1 && D >= 1 && A >= 1 && A <= 128; }

// Blocks of a persistent launch: every SM filled as far as its shared memory allows.
template <class Kernel>
cudaError_t persistent_blocks(Kernel kernel, size_t smem, long long tiles, int* blocks,
                              int threads = kThreads) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = static_cast<int>(min(tiles, static_cast<long long>(sms) * per_sm));
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* afm_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int afm_attention_num_fields() { return kF; }

// The shared memory of each kernel, and the largest padded D the backward's dW
// patch covers, for the launcher's checks.
size_t afm_attention_fwd_smem_bytes(int D, int A) { return fwd_smem_bytes(fit_fwd_shape(D, A)); }
size_t afm_attention_bwd_smem_bytes(int D, int A) { return sizeof(float) * bwd_smem_floats(make_shape(D, A)); }
int afm_attention_bwd_max_dim(int A) { return kMaxJD * make_shape(4, A).R; }

// fields [B, 6, D], W [D, A], b [A], h [A] f32 -> out [B, D] f32.
int afm_attention_fwd(const void* fields, const void* W, const void* b, const void* h, void* out,
                      long long B, int D, int A, void* stream) {
  if (!shape_ok(B, D, A)) return cudaErrorInvalidValue;
  FwdShape s = fit_fwd_shape(D, A);
  s.vec = s.vec && reinterpret_cast<uintptr_t>(fields) % 16 == 0;
  const size_t smem = fwd_smem_bytes(s);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  int blocks = 0;
  const long long tiles = (B + s.R - 1) / s.R;
  const cudaError_t err = persistent_blocks(afm_pool_fwd_kernel, smem, (tiles + kFwdGroups - 1) / kFwdGroups,
                                            &blocks, kFwdThreads);
  if (err != cudaSuccess) return err;
  afm_pool_fwd_kernel<<<blocks, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), static_cast<const float*>(W),
      static_cast<const float*>(b), static_cast<const float*>(h), static_cast<float*>(out), B, s);
  return cudaGetLastError();
}

// The number of blocks (partial rows) afm_attention_bwd launches, for the
// launcher to size dw_part [blocks, D, A], db_part and dh_part [blocks, A].
int afm_attention_bwd_blocks(long long B, int D, int A) {
  if (!shape_ok(B, D, A)) return -1;
  const Shape s = make_shape(D, A);
  int blocks = 0;
  if (persistent_blocks(afm_pool_bwd_kernel, sizeof(float) * bwd_smem_floats(s),
                        (B + s.R - 1) / s.R, &blocks) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// fields [B, 6, D], W [D, A], b [A], h [A], g [B, D] f32 -> de [B, 6, D] and the
// per-block partials; `blocks` as afm_attention_bwd_blocks gave it.
int afm_attention_bwd(const void* fields, const void* W, const void* b, const void* h,
                      const void* g, void* de, void* dw_part, void* db_part, void* dh_part,
                      long long B, int D, int A, int blocks, void* stream) {
  if (!shape_ok(B, D, A) || blocks < 1) return cudaErrorInvalidValue;
  const Shape s = make_shape(D, A);
  if ((s.Dp + s.R - 1) / s.R > kMaxJD) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * bwd_smem_floats(s);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        afm_pool_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  afm_pool_bwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), static_cast<const float*>(W),
      static_cast<const float*>(b), static_cast<const float*>(h), static_cast<const float*>(g),
      static_cast<float*>(de), static_cast<float*>(dw_part), static_cast<float*>(db_part),
      static_cast<float*>(dh_part), B, s);
  return cudaGetLastError();
}

// dw [D, A], db [A], dh [A] f32 from the nparts partials of afm_attention_bwd.
int afm_attention_bwd_reduce(const void* dw_part, const void* db_part, const void* dh_part,
                             void* dw, void* db, void* dh, int nparts, int D, int A, void* stream) {
  if (nparts < 1 || D < 1 || A < 1) return cudaErrorInvalidValue;
  const int n = D * A + 2 * A;
  const int blocks = min((n + kThreads - 1) / kThreads, 1024);
  afm_pool_bwd_reduce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dw_part), static_cast<const float*>(db_part),
      static_cast<const float*>(dh_part), static_cast<float*>(dw), static_cast<float*>(db),
      static_cast<float*>(dh), nparts, D * A, A);
  return cudaGetLastError();
}

}  // extern "C"
