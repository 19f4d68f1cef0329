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
// Bound: operations. A row's forward is 15 x 2 D A = 245,760 float32 operations at
// the AFM preset (D 128, A 64) and reads 3 KB, so at 67 TFLOP/s the FMAs, not the
// bytes, set the time; the backward does about three times the forward's work
// (the forward again, W dz for dc, and the dW outer products). The point of the TPU
// kernels, kept here: the [B, 15, D] pair products and the [B, 15, A] activations
// never reach device memory. A block stages W (and, for the backward, W^T) in
// shared memory once (128 x 64 f32 = 32 KB), then walks over tiles of R rows: the
// tile's fields go to shared memory, masked at load (rows past B are zeros, never
// read from memory, so no mask multiplies garbage), and each row is owned by NG =
// A_pad / 4 neighbouring lanes of a warp, a lane computing z for its 4 columns of
// A and all 15 pairs in registers with float32 FMAs (no TF32): per step of the D
// loop, 6 broadcast loads of e, one float4 of W and 15 products c_p feed 60 FMAs.
// The scores are summed across the NG lanes by shuffles, the softmax (max
// subtracted) is taken in registers, and the pooled row written once. The
// backward recomputes that forward in the block, keeps dz in shared memory for the
// tile, forms dc and de per row with W^T from shared memory, and accumulates dW in
// registers (each thread a fixed 8 x 4 patch of it) and db, dh per thread across
// all its tiles; each block writes its partial dW, db, dh once, and
// afm_pool_bwd_reduce_kernel sums the partials in block order, so runs repeat bit
// for bit. Shapes: 6 fields, A <= 128 (padded with zero columns to a power of two
// of at least 16), and a block's shared memory and the dW patch bound D; the
// Python launcher checks them.
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kF = 6;     // fields
constexpr int kP = 15;    // pairs
constexpr int kMaxJD = 8;  // d rows of dW per thread in the backward
constexpr int kRowPad = 4;  // floats after each staged row: shifts banks, keeps 16-byte alignment
constexpr unsigned kFull = 0xffffffffu;

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

size_t fwd_smem_floats(const Shape& s) {
  return static_cast<size_t>(s.R) * s.ES + static_cast<size_t>(s.Dp) * s.Ap + 2 * s.Ap;
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

__global__ void __launch_bounds__(kThreads)
afm_pool_fwd_kernel(const float* __restrict__ fields, const float* __restrict__ W,
                    const float* __restrict__ b, const float* __restrict__ h,
                    float* __restrict__ out, long long B, Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* es = smem;                                   // [R][ES]
  float* Ws = es + static_cast<size_t>(s.R) * s.ES;   // [Dp][Ap]
  float* bs = Ws + static_cast<size_t>(s.Dp) * s.Ap;  // [Ap]
  float* hs = bs + s.Ap;                              // [Ap]
  stage_params(W, b, h, s, Ws, bs, hs, nullptr);
  const int rg = threadIdx.x / s.NG, ng = threadIdx.x - rg * s.NG, a0 = 4 * ng;
  const long long tiles = (B + s.R - 1) / s.R;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * s.R;
    __syncthreads();  // W staged; the previous tile's readers are done with es
    stage_tile(fields, nullptr, r0, B, s, es, nullptr);
    __syncthreads();
    const float* er = es + rg * s.ES;
    float z[kP][4], wts[kP];
    pair_scores(er, Ws, s, a0, z);
    attention_weights(z, bs, hs, s, a0, wts);
    const long long row = r0 + rg;
    if (row < B) {
      for (int d = ng; d < s.D; d += s.NG) {
        float pooled = 0.f;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          pooled = fmaf(wts[p], er[pair_i(p) * s.Dp + d] * er[pair_j(p) * s.Dp + d], pooled);
        }
        out[static_cast<size_t>(row) * s.D + d] = pooled;
      }
    }
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
cudaError_t persistent_blocks(Kernel kernel, size_t smem, long long tiles, int* blocks) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
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
size_t afm_attention_fwd_smem_bytes(int D, int A) { return sizeof(float) * fwd_smem_floats(make_shape(D, A)); }
size_t afm_attention_bwd_smem_bytes(int D, int A) { return sizeof(float) * bwd_smem_floats(make_shape(D, A)); }
int afm_attention_bwd_max_dim(int A) { return kMaxJD * make_shape(4, A).R; }

// fields [B, 6, D], W [D, A], b [A], h [A] f32 -> out [B, D] f32.
int afm_attention_fwd(const void* fields, const void* W, const void* b, const void* h, void* out,
                      long long B, int D, int A, void* stream) {
  if (!shape_ok(B, D, A)) return cudaErrorInvalidValue;
  const Shape s = make_shape(D, A);
  const size_t smem = sizeof(float) * fwd_smem_floats(s);
  int blocks = 0;
  const cudaError_t err = persistent_blocks(afm_pool_fwd_kernel, smem, (B + s.R - 1) / s.R, &blocks);
  if (err != cudaSuccess) return err;
  afm_pool_fwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
