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
// cores); the backward does three such products (z again, W dz for dc, and the
// dW outer products). The point of the TPU kernels, kept here: the [B, 15, D]
// pair products and the [B, 15, A] activations never reach device memory.
//
// Both directions compute z = c W with one piece of device code (panel_z): a
// row's 15 pairs are an m16 tile (the 16th row zeros), each lane forms its A
// elements c = e_i[k] e_j[k] from the staged fields and splits them once per
// k-step (slot t takes k0 + 2t, slot t + 4 takes k0 + 2t + 1, so a lane's fields
// and its B fragment are 8- and 16-byte loads), and mma.sync m16n8k8 runs the
// three products of 3xTF32 pass by pass over two n8 tiles at a time, over
// column panels of 64 (A padded with zeros, so no mma.sync is predicated). Each
// accumulator sees the same sequence of mma.sync in both kernels, so the
// backward's z and its softmax weights are the forward's bit for bit. The
// backward's relu masks are those of a float32 sum on CUDA cores: a z + b
// within the tensor cores' error bound of 0 (kKink) is summed again as the
// previous, CUDA-core backward summed it (refine) before its mask is taken,
// since the check against the float32 plain version needs masks that a
// float32 sum gives (one flipped mask moves a row's d fields by ds_p h_a
// W[:, a], which can lie far past AFM_BWD_RTOL); the forward's output sees no
// mask (relu is continuous). W is held pre-split into TF32 hi and lo parts (SplitMat) in shared
// memory where it fits (64 KB at the preset); otherwise the same code reads W
// from device memory through L1 and L2 and splits it as it goes (GlobalMat,
// the kernels' <false, *> instantiations), which is what lets D and A grow.
// Past D = 128 the products' sum is chunked (panel_z's kChunked).
//
// The forward (afm_pool_fwd_kernel): persistent blocks (one an SM), two groups
// of 8 warps each walking its own tiles of rows with its own buffer, copied
// with cp.async: while one group waits for its copy or runs its epilogue, the
// other's products keep the tensor cores busy. A warp takes two rows, so every
// B fragment feeds two m16 tiles. The epilogue adds b, takes the relu,
// multiplies by h and sums the quad by shuffles; the softmax over the pairs runs
// across the warp's quads by shuffles, and the pool sum_p w_p c_p recomputes c
// from the staged fields in float32 on CUDA cores, in pair order.
//
// The backward (afm_pool_bwd_kernel): persistent blocks of 8 warps holding W
// and W^T pre-split in shared memory where both fit beside the tiles (128 KB
// at the preset). A block is two groups of 4 warps, each walking its own tiles
// of up to 4 rows, one row a warp, with its own buffers and named barriers, so
// that one group's tensor phase can run beside the other's CUDA-core phase:
// * the tensor phase, per row: z (panel_z) and the scores, dwts_p = g . c_p
//   from the staged fields and g (each lane its k slots, summed over the quad),
//   the softmax, ds; then dz = (z + b > 0) ds h is formed in the accumulators'
//   C fragments and handed to the A fragments of dc = dz W^T in registers: the
//   C fragment of n8 tile j holds columns 8j + 2t, 8j + 2t + 1 of pairs g,
//   g + 8, so the k-step over those 8 columns takes 8j + 2t as its slot t and
//   8j + 2t + 1 as slot t + 4 (a0 = c0, a1 = c2, a2 = c1, a3 = c3), and W^T's
//   B fragment holds W[d][8j + 2t], W[d][8j + 2t + 1], one 16-byte load of the
//   split W^T. dc runs on mma.sync in 3xTF32 in chunks of 64 columns of D;
//   then dc_p += w_p g, and the chunk goes 32 columns at a time through a
//   per-warp scratch so that lane l sums de_i += dc_p e_j, de_j += dc_p e_i for
//   column l in pair order, in float32, and writes it. dz and ds go to shared
//   memory (the chunks past the first read dz back from there; where A takes
//   more than one column panel, z is recomputed once for the first), and
//   relu(z + b) ds, summed over the pairs by shuffles, to the warp's dh sums.
// * the CUDA-core phase, over the tile's rows: each thread of the group
//   accumulates a fixed 8 x 8 patch of dW (d rows rg + RG j, columns 8 ng ..)
//   in registers from dz, and db for its 8 columns over the rows r = rg (mod
//   RG). The next tile's cotangents are copied meanwhile, its fields after it.
// Where D takes more than one patch of dW rows (PD = 8 RG), each block takes a
// D-panel and a range of rows: the blocks of panel 0 write d fields, db and dh,
// the others only recompute z for their rows' dW. Each group writes its
// partial dW (its panel's rows), db, dh once, and afm_pool_bwd_reduce_kernel
// sums the partials in block order. No atomics, fixed orders of summation:
// runs repeat bit for bit. Shapes: 6 fields, A <= 256, any D >= 1 for which a
// tile of one row fits in shared memory; the Python launcher checks them.
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

using tf32mma::cp_async16_or_zero;
using tf32mma::cp_async4_or_zero;
using tf32mma::cp_async_commit;
using tf32mma::cp_async_wait_all;
using tf32mma::mma_3xtf32;
using tf32mma::split_tf32_bits;

constexpr int kThreads = 256;  // a group of the forward, a block of the backward
constexpr int kWarps = kThreads / 32;
constexpr int kF = 6;     // fields
constexpr int kP = 15;    // pairs
constexpr int kMaxA = 256;  // widest A the kernels take
constexpr int kJD = 8;      // d rows of dW per thread in the backward
constexpr int kJA = 8;      // its columns (a multiple of 4)
constexpr int kBwdGroups = 2;  // groups of a backward block, each on its own tiles
constexpr int kBwdThreads = kThreads / kBwdGroups;  // threads of a backward group
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kChunk = 64;  // columns of D of a dc chunk in the backward
constexpr int kLanes = 32;  // columns of D a de pass takes: one a lane
constexpr int kUnchunked = 128;  // the widest D whose z sums in the mma.sync accumulators alone
constexpr int kZChunk = 8;       // k-steps of a chunk of z's sum past it
// |z + b| below kKink sum_d |c_d| max_d |W[d][a]| is within the error bound of
// z from the tensor cores (3xTF32 products, 2^-21 each, and the accumulators'
// rounding), so the backward recomputes it before it takes the relu mask.
constexpr float kKink = 6.103515625e-05f;  // 2^-14
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPanel = 8;  // n8 tiles of a column panel
constexpr int kHalf = 2;   // B fragments in registers at once
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use on Hopper

__device__ __forceinline__ constexpr int pair_i(int p) {
  return p < 5 ? 0 : p < 9 ? 1 : p < 12 ? 2 : p < 14 ? 3 : 4;
}
__device__ __forceinline__ constexpr int pair_j(int p) {
  return p + 1 - (p < 5 ? 0 : p < 9 ? 4 : p < 12 ? 7 : p < 14 ? 9 : 10);
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }
// n (a multiple of 4) padded to 8 mod 32 floats: 8-byte loads or stores of a
// warp's rows g and pairs t touch every bank once a half-warp.
int stride8(int n) { return n + (8 - n % 32 + 32) % 32; }
// n padded to 16 mod 32 floats: 16-byte loads of a quarter-warp (rows g, g + 1;
// chunks t) touch every bank once.
int stride16(int n) { return n + (16 - n % 32 + 32) % 32; }

// W's parts: hi = tf32(w) and lo = w - hi, exact in float32 (its low bits are
// not rounded away: the mma.sync reads lo's top 19 bits, and hi + lo gives w
// back exactly, which refine sums with).
__device__ __forceinline__ void split_exact(float w, uint32_t& hi, uint32_t& lo) {
  hi = tf32mma::tf32_bits(w);
  lo = __float_as_uint(w - __uint_as_float(hi));
}

// A weight matrix as a B operand: frag(n, k) gives the hi and lo parts
// (3xTF32) of its elements (k, n) and (k + 1, n), k even (B's slots t and t + 4
// of column n), zeros past the widths. Two of them: W for z = c W (n = a,
// k = d: W[k][n], W[k + 1][n]) and W^T for dc = dz W^T (n = d, k = a: W[n][k],
// W[n][k + 1]).
//
// On chip, split once a block: row n holds, for each pair (k, k + 1), the four
// words hi (k, n), hi (k + 1, n), lo (k, n), lo (k + 1, n); one 16-byte load is a
// lane's B fragment. The row stride ld is 16 mod 32 floats.
struct SplitMat {
  const float* p;
  int ld;
  __device__ __forceinline__ void frag(int n, int k, uint32_t (&bh)[2], uint32_t (&bl)[2]) const {
    const uint4 w = *reinterpret_cast<const uint4*>(p + n * ld + 2 * k);
    bh[0] = w.x, bh[1] = w.y, bl[0] = w.z, bl[1] = w.w;
  }
};

// In device memory: W [D][A] as it is, split as it is read.
template <bool kT>
struct GlobalMat {
  const float* __restrict__ W;
  int D, A;
  __device__ __forceinline__ float at(int n, int k) const {
    if constexpr (kT) {
      return n < D && k < A ? __ldg(W + static_cast<size_t>(n) * A + k) : 0.f;
    } else {
      return n < A && k < D ? __ldg(W + static_cast<size_t>(k) * A + n) : 0.f;
    }
  }
  __device__ __forceinline__ void frag(int n, int k, uint32_t (&bh)[2], uint32_t (&bl)[2]) const {
    split_exact(at(n, k), bh[0], bl[0]);
    split_exact(at(n, k + 1), bh[1], bl[1]);
  }
};

template <bool kOnChip, bool kT>
using Mat = std::conditional_t<kOnChip, SplitMat, GlobalMat<kT>>;

// A SplitMat of rows n < N (zeros past the widths) and k < K (K even) at dst,
// from W [D][A] (kT: element (k, n) is W[n][k], else W[k][n]).
template <bool kT>
__device__ void stage_split(const float* __restrict__ W, int D, int A, int N, int K, int ld,
                            float* dst, int tid, int nthreads) {
  const GlobalMat<kT> m{W, D, A};
  const int pairs = K / 2;
  for (int e = tid; e < N * pairs; e += nthreads) {
    const int n = e / pairs, k = 2 * (e - n * pairs);
    uint4 v;
    split_exact(m.at(n, k), v.x, v.z);
    split_exact(m.at(n, k + 1), v.y, v.w);
    *reinterpret_cast<uint4*>(dst + n * ld + 2 * k) = v;
  }
}

// Rows r0 .. r0 + R - 1 of src [B][n][D] into dst [R][n][ld] (columns below D),
// asynchronously (the caller commits), by threads tid < nthreads. Rows past B
// are zeros. Threads take fixed column chunks (16 bytes where vec, else 4) of
// every rows_per-th row, so the loops divide nothing.
__device__ __forceinline__ void copy_rows(const float* __restrict__ src, long long r0, long long B,
                                          int n, int D, int R, int ld, bool vec, float* dst,
                                          int tid, int nthreads = kThreads) {
  const int chunks = vec ? D >> 2 : D, cols = min(chunks, nthreads);
  const int rows_per = nthreads / cols, first = tid / cols, c0 = tid - first * cols;
  if (first >= rows_per) return;
  const int live = static_cast<int>(B - r0 < R ? B - r0 : R) * n;  // rows below B
  const float* f = src + static_cast<size_t>(r0) * n * D;
  for (int rf = first; rf < R * n; rf += rows_per) {
    const bool in = rf < live;
    for (int c = c0; c < chunks; c += cols) {
      if (vec) {
        const float* from = in ? f + static_cast<size_t>(rf) * D + 4 * c : src;
        cp_async16_or_zero(dst + rf * ld + 4 * c, from, in);
      } else {
        const float* from = in ? f + static_cast<size_t>(rf) * D + c : src;
        cp_async4_or_zero(dst + rf * ld + c, from, in);
      }
    }
  }
}

// This lane's place in a row's m16 tile of pairs: pairs g (rows g) and g + 8
// (rows g + 8; pair 15 is the zero row), their fields' offsets in a staged row
// [6][ldf] at k slot t.
struct PairLane {
  int g, t, ia, ja, ib, jb;
  bool has_b;
  __device__ __forceinline__ PairLane(int ldf) {
    const int lane = threadIdx.x & 31;
    g = lane >> 2, t = lane & 3, has_b = g < 7;
    ia = pair_i(g) * ldf + 2 * t, ja = pair_j(g) * ldf + 2 * t;
    ib = has_b ? pair_i(g + 8) * ldf + 2 * t : 0;
    jb = has_b ? pair_j(g + 8) * ldf + 2 * t : 0;
  }
};

template <int U>
using PanelAcc = float[U][kPanel / kHalf][kHalf][4];

template <int U>
__device__ __forceinline__ void zero_panel(PanelAcc<U>& acc) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int q = 0; q < kPanel / kHalf; ++q) {
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[u][q][j][c] = 0.f;
      }
    }
  }
}

// z = c W, columns n0 .. n0 + 63, of U rows (er[u]: staged [6][ldf]) on the
// tensor cores (3xTF32), into acc[u]; n8 tile j of the panel is acc[u][j / kHalf][j % kHalf].
// kChunked (D past kUnchunked): the mma.sync accumulate kZChunk k-steps at a
// time from zero, and each chunk is added to acc in float32. The tensor
// cores' accumulation drifts with the number of products it takes: unchunked,
// the forward at D 256, A 256 missed AFM_FWD_RTOL against the float32 plain
// version in tests/test_torch_cuda_kernels.py, chunked it meets it. The chunks
// cost a second set of accumulators, which the preset's D does not pay.
template <int U, bool kChunked, class M>
__device__ __forceinline__ void panel_z(const float* const (&er)[U], const PairLane& l, M w, int Dk,
                                        int n0, PanelAcc<U>& acc) {
  zero_panel(acc);
  PanelAcc<kChunked ? U : 1> part;  // the chunk's accumulators (kChunked)
  if constexpr (kChunked) zero_panel(part);
#pragma unroll 2
  for (int k0 = 0; k0 < Dk; k0 += 8) {
    uint32_t ah[U][4], al[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* e = er[u] + k0;
      const float2 xi = *reinterpret_cast<const float2*>(e + l.ia);
      const float2 xj = *reinterpret_cast<const float2*>(e + l.ja);
      float2 ca = make_float2(xi.x * xj.x, xi.y * xj.y), cb = make_float2(0.f, 0.f);
      if (l.has_b) {
        const float2 yi = *reinterpret_cast<const float2*>(e + l.ib);
        const float2 yj = *reinterpret_cast<const float2*>(e + l.jb);
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
      for (int j = 0; j < kHalf; ++j) w.frag(n0 + 8 * (q * kHalf + j) + l.g, k0 + 2 * l.t, bh[j], bl[j]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if constexpr (kChunked) {
          mma_3xtf32(part[u][q], ah[u], al[u], bh, bl);
        } else {
          mma_3xtf32(acc[u][q], ah[u], al[u], bh, bl);
        }
      }
    }
    if constexpr (kChunked) {
      if (((k0 >> 3) + 1) % kZChunk == 0 || k0 + 8 >= Dk) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < kPanel / kHalf; ++q) {
#pragma unroll
            for (int j = 0; j < kHalf; ++j) {
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[u][q][j][c] += part[u][q][j][c], part[u][q][j][c] = 0.f;
            }
          }
        }
      }
    }
  }
}

// The scores' part of the panel at n0: sa[u] += relu(z + b) . h over this lane's
// columns of pair g, sb[u] of pair g + 8 (bs, hs zero past A).
template <int U>
__device__ __forceinline__ void panel_scores(const PanelAcc<U>& acc, const float* bs, const float* hs,
                                             int n0, int t, float (&sa)[U], float (&sb)[U]) {
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(bs + c);
    const float2 h = *reinterpret_cast<const float2*>(hs + c);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* z = acc[u][j / kHalf][j % kHalf];
      sa[u] = fmaf(fmaxf(z[0] + b.x, 0.f), h.x, sa[u]);
      sa[u] = fmaf(fmaxf(z[1] + b.y, 0.f), h.y, sa[u]);
      sb[u] = fmaf(fmaxf(z[2] + b.x, 0.f), h.x, sb[u]);
      sb[u] = fmaf(fmaxf(z[3] + b.y, 0.f), h.y, sb[u]);
    }
  }
}

// The softmax over a row's 15 pairs from the lanes' partial scores: on return
// a and b are the weights of pairs g and g + 8 (0 for pair 15), on every lane.
__device__ __forceinline__ void pair_softmax(float& a, float& b, bool has_b) {
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
}

// The threads of group grp of the block, nthreads of them, meet (named barrier 1 + grp).
__device__ __forceinline__ void group_sync(int grp, int nthreads = kThreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(nthreads) : "memory");
}

// Blocks of a persistent launch: every SM filled as far as its shared memory allows.
template <class Kernel>
cudaError_t persistent_blocks(Kernel kernel, size_t smem, int threads, long long* most) {
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
  *most = static_cast<long long>(sms) * per_sm;
  return cudaSuccess;
}

// ------------------------------------------------------------------ forward
//
// Shared memory: W pre-split (on chip only), WS [Ak][ldw]; bs, hs [Ak]; the
// fields of a tile, es [2][R][6][ldf] (ldf 8 mod 32 floats), two groups'
// buffers. Zeros past D and A everywhere.
struct FwdShape {
  int D, A, Dk, Ak, R, ldw, ldf;
  int oW, oB, oH, oE, total;
  bool vec;      // D % 4 == 0: the fields' rows are copied 16 bytes at a time
  bool on_chip;  // W pre-split in shared memory, else read from device memory
};

constexpr int kFwdGroups = 2;  // groups of kThreads a forward block, each on its own tiles
constexpr int kFwdThreads = kFwdGroups * kThreads;
constexpr int kFwdRows = 2 * kWarps;  // a group's tile: two rows a warp

FwdShape make_fwd_shape(int D, int A, int R, bool on_chip) {
  FwdShape s;
  s.D = D, s.A = A, s.R = R, s.on_chip = on_chip;
  s.Dk = round_up(D, 8), s.Ak = round_up(A, 8 * kPanel);
  s.ldw = stride16(2 * s.Dk);
  s.ldf = stride8(s.Dk);
  s.oW = 0;
  s.oB = s.oW + (on_chip ? s.Ak * s.ldw : 0);
  s.oH = s.oB + s.Ak;
  s.oE = s.oH + s.Ak;
  s.total = s.oE + kFwdGroups * R * kF * s.ldf;
  s.vec = D % 4 == 0;
  return s;
}

size_t fwd_smem_bytes(const FwdShape& s) { return sizeof(float) * static_cast<size_t>(s.total); }

// W on chip if any tile fits beside it, else in device memory; then two rows a
// warp, the most rows (kFwdRows, else fewer warps busy) that fit.
FwdShape fit_fwd_shape(int D, int A) {
  FwdShape s = make_fwd_shape(D, A, 2, false);
  for (bool on_chip : {true, false}) {
    for (int R = kFwdRows; R >= 2; R -= 2) {
      s = make_fwd_shape(D, A, R, on_chip);
      if (fwd_smem_bytes(s) <= kSmemLimit) return s;
    }
  }
  return s;
}

// One or two rows of the tile by one warp: z (panel_z) over every panel, the
// scores, the softmax over the pairs by shuffles, and the pool sum_p w_p c_p
// (c recomputed from the staged fields) into out.
template <bool kChunked, class M>
__device__ __forceinline__ void pool_rows(const float* er0, const float* er1, bool two, M w,
                                          const float* bs, const float* hs, const FwdShape& s,
                                          float* out0, float* out1) {
  const PairLane l(s.ldf);
  const int lane = threadIdx.x & 31;
  const float* er[2] = {er0, two ? er1 : er0};
  float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};  // scores of pairs g, g + 8
  for (int n0 = 0; n0 < s.Ak; n0 += 8 * kPanel) {
    PanelAcc<2> acc;
    panel_z<2, kChunked>(er, l, w, s.Dk, n0, acc);
    panel_scores<2>(acc, bs, hs, n0, l.t, sa, sb);
  }
  float* out[2] = {out0, out1};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u == 1 && !two) break;
    float a = sa[u], b = sb[u];
    pair_softmax(a, b, l.has_b);
    float wts[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) wts[p] = __shfl_sync(kFull, p < 8 ? a : b, 4 * (p & 7));
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

template <bool kOnChip, bool kChunked>
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
  if (tile < tiles) copy_rows(fields, tile * s.R, B, kF, s.D, s.R, s.ldf, s.vec, es, tid);
  cp_async_commit();  // in flight during the set-up
  for (int e = threadIdx.x; e < kFwdGroups * buf_floats; e += kFwdThreads) {  // columns the copies skip
    if (e % s.ldf >= s.D) smem[s.oE + e] = 0.f;
  }
  Mat<kOnChip, false> w;
  if constexpr (kOnChip) {
    stage_split<false>(W, s.D, s.A, s.Ak, s.Dk, s.ldw, smem + s.oW, threadIdx.x, kFwdThreads);
    w = {smem + s.oW, s.ldw};
  } else {
    w = {W, s.D, s.A};
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
      pool_rows<kChunked>(e, e + kF * s.ldf, two, w, smem + s.oB, smem + s.oH, s,
                          out + static_cast<size_t>(r0 + r) * s.D,
                          two ? out + static_cast<size_t>(r0 + r + 1) * s.D : nullptr);
    }
    group_sync(grp);  // the fields are free
    if (tile + stride < tiles) copy_rows(fields, (tile + stride) * s.R, B, kF, s.D, s.R, s.ldf, s.vec, es, tid);
    cp_async_commit();
  }
}

// ----------------------------------------------------------------- backward
//
// Shared memory (floats): W and W^T pre-split (on chip only), WS [Ak][ldw] and
// WT [Dc][ldt]; bs, hs and wm (max_d |W[d][a]|) [Ah]; for each of the two
// groups, its tile's fields es [R][6][ldf] and cotangents gs [R][ldf], dz of
// each row, zs [R][15][ldz] (columns past Ak stay zero), and ds, dss [R][16];
// each warp's dh sums, dhw [8][Ah], and a scratch of 16 x ldc for dc.
struct BwdShape {
  int D, A, Dk, Dc, Ak, Ap, Ah;  // D to the mma's 8 and to a dc chunk; A to a panel, to a power of two
  int NG, RG, PD, P;             // dW threads: NG across A (kJA columns each), RG across D; a D-panel's rows, panels
  int R, ldw, ldt, ldf, ldz, ldc, ZS;  // R rows a group's tile; ZS floats a group's zs
  int oWS, oWT, oB, oH, oM, oE, oG, oZ, oS, oDh, oC, total;
  bool vec, on_chip;
};

BwdShape make_bwd_shape(int D, int A, int R, bool on_chip) {
  BwdShape s;
  s.D = D, s.A = A, s.R = R, s.on_chip = on_chip;
  s.Dk = round_up(D, 8), s.Dc = round_up(D, kChunk), s.Ak = round_up(A, 8 * kPanel);
  s.Ap = 16;
  while (s.Ap < A) s.Ap *= 2;
  s.Ah = s.Ak > s.Ap ? s.Ak : s.Ap;
  s.NG = s.Ap / kJA, s.RG = kBwdThreads / s.NG, s.PD = kJD * s.RG, s.P = (D + s.PD - 1) / s.PD;
  s.ldw = stride16(2 * s.Dk), s.ldt = stride16(2 * s.Ak);
  s.ldf = stride8(s.Dk), s.ldz = stride8(s.Ah), s.ldc = stride8(kLanes);
  int o = 0;
  auto take = [&o](int n) {
    const int start = o;
    o += round_up(n, 4);
    return start;
  };
  s.oWS = take(on_chip ? s.Ak * s.ldw : 0);
  s.oWT = take(on_chip ? s.Dc * s.ldt : 0);
  s.oB = take(s.Ah);
  s.oH = take(s.Ah);
  s.oM = take(s.Ah);
  s.oE = take(kBwdGroups * R * kF * s.ldf);
  s.oG = take(kBwdGroups * R * s.ldf);
  const int zs = R * kP * s.ldz, red = s.RG * s.Ap;  // zs is reused for the db sums
  s.ZS = round_up(zs > red ? zs : red, 4);
  s.oZ = take(kBwdGroups * s.ZS);
  s.oS = take(kBwdGroups * R * 16);
  s.oDh = take(kWarps * s.Ah);
  s.oC = take(kWarps * 16 * s.ldc);
  s.total = o;
  s.vec = D % 4 == 0;
  return s;
}

size_t bwd_smem_bytes(const BwdShape& s) { return sizeof(float) * static_cast<size_t>(s.total); }

// W and W^T on chip if tiles of at least half a group's warps' rows fit beside
// them, else in device memory; then the most rows (one a warp) that fit.
BwdShape fit_bwd_shape(int D, int A) {
  BwdShape s = make_bwd_shape(D, A, 1, false);
  for (bool on_chip : {true, false}) {
    for (int R = kBwdWarps; R >= (on_chip ? kBwdWarps / 2 : 1); --R) {
      s = make_bwd_shape(D, A, R, on_chip);
      if (bwd_smem_bytes(s) <= kSmemLimit) return s;
    }
  }
  return s;
}

// The lanes' z + b values v0 (pair g, column c), v1 (g, c + 1), v2 (g + 8, c)
// and v3 (g + 8, c + 1), c = c0 + 2t, where a bit of flags asks for it: summed
// again on CUDA cores as the previous backward summed every z, c = e_i e_j and
// fmaf(c, W[d][a], z) in d order from 0 in float32, then + b; W is hi + lo
// (split_exact). Each flagged lane sums its own values; the others wait.
template <class M>
__device__ __forceinline__ void refine(float& v0, float& v1, float& v2, float& v3, unsigned flags,
                                       const float* er, M w, const float* bs, int c0, int Dk,
                                       int ldf) {
  const int lane = threadIdx.x & 31;
  while (flags != 0) {
    const int which = __ffs(flags) - 1;
    const int p = (lane >> 2) + (which >= 2 ? 8 : 0), a = c0 + 2 * (lane & 3) + (which & 1);
    const float* ei = er + pair_i(p) * ldf;
    const float* ej = er + pair_j(p) * ldf;
    float z = 0.f;
    for (int d = 0; d < Dk; d += 2) {
      uint32_t bh[2], bl[2];
      w.frag(a, d, bh, bl);
      z = fmaf(ei[d] * ej[d], __uint_as_float(bh[0]) + __uint_as_float(bl[0]), z);
      z = fmaf(ei[d + 1] * ej[d + 1], __uint_as_float(bh[1]) + __uint_as_float(bl[1]), z);
    }
    const float v = z + bs[a];
    v0 = which == 0 ? v : v0, v1 = which == 1 ? v : v1, v2 = which == 2 ? v : v2, v3 = which == 3 ? v : v3;
    flags &= flags - 1;
  }
}

// One row by one warp, the tensor phase: z and the softmax, ds into dsr; then,
// per panel of A, z + b (a value within the tensor cores' error bound of 0,
// kKink n1 max|W|, summed again by refine), dz into zr [15][ldz] and relu(z +
// b) ds summed over the pairs into this warp's dh sums dhw; and per chunk of
// 32 columns of D, dc = dz W^T + w g (dz handed from the z accumulators to the
// A fragments in registers in the first chunk, read back from zr in the
// others) and de into de_row, when with_de.
template <bool kOnChip, bool kChunked>
__device__ __forceinline__ void row_backward(const float* er, const float* gr,
                                             Mat<kOnChip, false> ws, Mat<kOnChip, true> wt,
                                             const float* bs, const float* hs, const float* wm,
                                             const BwdShape& s, float* zr, float* dsr, float* dhw,
                                             float* cs, bool with_de, float* __restrict__ de_row) {
  const PairLane l(s.ldf);
  const int lane = threadIdx.x & 31, g = l.g, t = l.t;
  const float* ers[1] = {er};
  const bool one_panel = s.Ak == 8 * kPanel;
  PanelAcc<1> acc;
  float sa[1] = {0.f}, sb[1] = {0.f};
  for (int n0 = 0; n0 < s.Ak; n0 += 8 * kPanel) {
    panel_z<1, kChunked>(ers, l, ws, s.Dk, n0, acc);
    panel_scores<1>(acc, bs, hs, n0, t, sa, sb);
  }
  // dwts = g . c and n1 = sum |c| of pairs g and g + 8: this lane's k slots, then the quad
  float da = 0.f, db = 0.f, na = 0.f, nb = 0.f;
  for (int k0 = 0; k0 < s.Dk; k0 += 8) {
    const float* e = er + k0;
    const float2 gg = *reinterpret_cast<const float2*>(gr + k0 + 2 * t);
    const float2 xi = *reinterpret_cast<const float2*>(e + l.ia);
    const float2 xj = *reinterpret_cast<const float2*>(e + l.ja);
    const float2 ca = make_float2(xi.x * xj.x, xi.y * xj.y);
    da = fmaf(ca.x, gg.x, da), da = fmaf(ca.y, gg.y, da);
    na += fabsf(ca.x) + fabsf(ca.y);
    if (l.has_b) {
      const float2 yi = *reinterpret_cast<const float2*>(e + l.ib);
      const float2 yj = *reinterpret_cast<const float2*>(e + l.jb);
      const float2 cb = make_float2(yi.x * yj.x, yi.y * yj.y);
      db = fmaf(cb.x, gg.x, db), db = fmaf(cb.y, gg.y, db);
      nb += fabsf(cb.x) + fabsf(cb.y);
    }
  }
  for (int off = 1; off < 4; off <<= 1) {
    da += __shfl_xor_sync(kFull, da, off);
    db += __shfl_xor_sync(kFull, db, off);
    na += __shfl_xor_sync(kFull, na, off);
    nb += __shfl_xor_sync(kFull, nb, off);
  }
  float wa = sa[0], wb = sb[0];
  pair_softmax(wa, wb, l.has_b);
  float wd = l.has_b ? fmaf(wb, db, wa * da) : wa * da;  // sum_p w_p dwts_p over the quads
  for (int off = 4; off < 32; off <<= 1) wd += __shfl_xor_sync(kFull, wd, off);
  const float dsa = wa * (da - wd), dsb = l.has_b ? wb * (db - wd) : 0.f;
  if (t == 0) dsr[g] = dsa, dsr[g + 8] = dsb;
  na *= kKink, nb *= kKink;

  for (int d0 = 0; d0 < (with_de ? s.Dc : kChunk); d0 += kChunk) {
    float dc[kChunk / 8 / kHalf][kHalf][4] = {};
    for (int n0 = 0; n0 < s.Ak; n0 += 8 * kPanel) {
      if (d0 == 0 && !one_panel) panel_z<1, kChunked>(ers, l, ws, s.Dk, n0, acc);  // the same bits as above
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        float dz0, dz1, dz2, dz3;
        if (d0 == 0) {
          const float* z = acc[0][j / kHalf][j % kHalf];
          const float2 b = *reinterpret_cast<const float2*>(bs + c);
          const float2 h = *reinterpret_cast<const float2*>(hs + c);
          const float2 m = *reinterpret_cast<const float2*>(wm + c);
          float v0 = z[0] + b.x, v1 = z[1] + b.y, v2 = z[2] + b.x, v3 = z[3] + b.y;
          const unsigned flags = (fabsf(v0) < na * m.x ? 1u : 0u) | (fabsf(v1) < na * m.y ? 2u : 0u) |
                                 (fabsf(v2) < nb * m.x ? 4u : 0u) | (fabsf(v3) < nb * m.y ? 8u : 0u);
          refine(v0, v1, v2, v3, flags, er, ws, bs, n0 + 8 * j, s.Dk, s.ldf);
          dz0 = v0 > 0.f ? dsa * h.x : 0.f, dz1 = v1 > 0.f ? dsa * h.y : 0.f;
          dz2 = v2 > 0.f ? dsb * h.x : 0.f, dz3 = v3 > 0.f ? dsb * h.y : 0.f;
          *reinterpret_cast<float2*>(zr + g * s.ldz + c) = make_float2(dz0, dz1);
          if (l.has_b) *reinterpret_cast<float2*>(zr + (g + 8) * s.ldz + c) = make_float2(dz2, dz3);
          if (with_de) {  // dh_a += sum_p relu(z + b) ds_p: the pairs over the lanes g by shuffles
            float u0 = fmaf(fmaxf(v0, 0.f), dsa, fmaxf(v2, 0.f) * dsb);
            float u1 = fmaf(fmaxf(v1, 0.f), dsa, fmaxf(v3, 0.f) * dsb);
            for (int off = 4; off < 32; off <<= 1) {
              u0 += __shfl_xor_sync(kFull, u0, off);
              u1 += __shfl_xor_sync(kFull, u1, off);
            }
            if (g == 0) dhw[c] += u0, dhw[c + 1] += u1;
          }
        } else {  // the chunk's dz as the first chunk stored it
          const float2 x = *reinterpret_cast<const float2*>(zr + g * s.ldz + c);
          const float2 y = l.has_b ? *reinterpret_cast<const float2*>(zr + (g + 8) * s.ldz + c)
                                   : make_float2(0.f, 0.f);
          dz0 = x.x, dz1 = x.y, dz2 = y.x, dz3 = y.y;
        }
        if (!with_de) continue;
        // C -> A: (g, 2t) -> slot t, (g + 8, 2t) -> a1, (g, 2t + 1) -> slot t + 4
        uint32_t ah[4], al[4];
        split_tf32_bits(dz0, ah[0], al[0]);
        split_tf32_bits(dz2, ah[1], al[1]);
        split_tf32_bits(dz1, ah[2], al[2]);
        split_tf32_bits(dz3, ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < kChunk / 8 / kHalf; ++q) {
          uint32_t bh[kHalf][2], bl[kHalf][2];
#pragma unroll
          for (int i = 0; i < kHalf; ++i) wt.frag(d0 + 8 * (q * kHalf + i) + g, c, bh[i], bl[i]);
          mma_3xtf32(dc[q], ah, al, bh, bl);
        }
      }
    }
    if (!with_de) break;
    // dc_p += w_p g into the scratch [16][ldc], 32 columns at a time, then
    // column lane in pair order
#pragma unroll
    for (int d1 = 0; d1 < kChunk; d1 += kLanes) {
#pragma unroll
      for (int j = 0; j < kLanes / 8; ++j) {
        const int jj = d1 / 8 + j, d = d0 + 8 * jj + 2 * t;
        const float2 gg = d < s.Dk ? *reinterpret_cast<const float2*>(gr + d) : make_float2(0.f, 0.f);
        const float* v = dc[jj / kHalf][jj % kHalf];
        *reinterpret_cast<float2*>(cs + g * s.ldc + 8 * j + 2 * t) =
            make_float2(fmaf(wa, gg.x, v[0]), fmaf(wa, gg.y, v[1]));
        if (l.has_b) {
          *reinterpret_cast<float2*>(cs + (g + 8) * s.ldc + 8 * j + 2 * t) =
              make_float2(fmaf(wb, gg.x, v[2]), fmaf(wb, gg.y, v[3]));
        }
      }
      __syncwarp();
      const int d = d0 + d1 + lane;
      if (d < s.D) {
        float e[kF], de[kF];
#pragma unroll
        for (int f = 0; f < kF; ++f) e[f] = er[f * s.ldf + d], de[f] = 0.f;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const float c = cs[p * s.ldc + lane];
          de[pair_i(p)] = fmaf(c, e[pair_j(p)], de[pair_i(p)]);
          de[pair_j(p)] = fmaf(c, e[pair_i(p)], de[pair_j(p)]);
        }
#pragma unroll
        for (int f = 0; f < kF; ++f) de_row[f * s.D + d] = de[f];
      }
      __syncwarp();  // the scratch is free
    }
  }
}

template <bool kOnChip, bool kChunked>
__global__ void __launch_bounds__(kThreads, 1)
afm_pool_bwd_kernel(const float* __restrict__ fields, const float* __restrict__ W,
                    const float* __restrict__ b, const float* __restrict__ h,
                    const float* __restrict__ g, float* __restrict__ de,
                    float* __restrict__ dw_part, float* __restrict__ db_part,
                    float* __restrict__ dh_part, long long B, BwdShape s) {
  extern __shared__ __align__(16) float sm[];
  const int grp = threadIdx.x / kBwdThreads, tid = threadIdx.x - grp * kBwdThreads;
  const int warp = tid >> 5, bwarp = threadIdx.x >> 5;  // in the group, in the block
  // block = k * P + panel: the blocks k of a D-panel; the groups of all panels'
  // blocks k share their rows, and each group writes partial number part
  const int panel = blockIdx.x % s.P, part = (blockIdx.x / s.P) * kBwdGroups + grp;
  const int parts = gridDim.x / s.P * kBwdGroups;
  float* es = sm + s.oE + grp * s.R * kF * s.ldf;
  float* gs = sm + s.oG + grp * s.R * s.ldf;
  float* zs = sm + s.oZ + grp * s.ZS;
  float* dss = sm + s.oS + grp * s.R * 16;
  const float* bs = sm + s.oB;
  const float* hs = sm + s.oH;
  const long long tiles = (B + s.R - 1) / s.R;
  long long tile = part;
  if (tile < tiles) {
    copy_rows(fields, tile * s.R, B, kF, s.D, s.R, s.ldf, s.vec, es, tid, kBwdThreads);
    copy_rows(g, tile * s.R, B, 1, s.D, s.R, s.ldf, s.vec, gs, tid, kBwdThreads);
  }
  cp_async_commit();  // in flight during the set-up
  // columns the copies skip (es and gs of both groups are adjacent, all ldf wide)
  for (int e = threadIdx.x; e < kBwdGroups * s.R * (kF + 1) * s.ldf; e += kThreads) {
    if (e % s.ldf >= s.D) sm[s.oE + e] = 0.f;
  }
  for (int e = threadIdx.x; e < kBwdGroups * s.ZS; e += kThreads) sm[s.oZ + e] = 0.f;
  for (int e = threadIdx.x; e < kWarps * s.Ah; e += kThreads) sm[s.oDh + e] = 0.f;
  Mat<kOnChip, false> ws;
  Mat<kOnChip, true> wt;
  if constexpr (kOnChip) {
    stage_split<false>(W, s.D, s.A, s.Ak, s.Dk, s.ldw, sm + s.oWS, threadIdx.x, kThreads);
    stage_split<true>(W, s.D, s.A, s.Dc, s.Ak, s.ldt, sm + s.oWT, threadIdx.x, kThreads);
    ws = {sm + s.oWS, s.ldw}, wt = {sm + s.oWT, s.ldt};
  } else {
    ws = {W, s.D, s.A}, wt = {W, s.D, s.A};
  }
  for (int a = threadIdx.x; a < s.Ah; a += kThreads) {
    float mx = 0.f;
    for (int d = 0; a < s.A && d < s.D; ++d) mx = fmaxf(mx, fabsf(__ldg(W + static_cast<size_t>(d) * s.A + a)));
    sm[s.oB + a] = a < s.A ? __ldg(b + a) : 0.f;
    sm[s.oH + a] = a < s.A ? __ldg(h + a) : 0.f;
    sm[s.oM + a] = mx;
  }
  __syncthreads();  // weights and zeros in place

  // Each group walks its own tiles: while one group's warps run the tensor
  // phase, the other's may run their dW phase on the CUDA cores.
  const int rg = tid / s.NG, ng = tid - rg * s.NG, a0 = kJA * ng;
  const int dbase = panel * s.PD + rg;  // this thread's dW rows: dbase + RG j
  const bool with_de = panel == 0;
  float dw_acc[kJD][kJA] = {}, db_acc[kJA] = {};
  for (; tile < tiles; tile += parts) {
    const long long r0 = tile * s.R;
    const int rows = static_cast<int>(min(static_cast<long long>(s.R), B - r0));
    const long long next = tile + parts;
    cp_async_wait_all();
    group_sync(grp, kBwdThreads);  // the tile's fields and cotangents are in
    if (warp < rows) {  // warp-uniform
      row_backward<kOnChip, kChunked>(es + warp * kF * s.ldf, gs + warp * s.ldf, ws, wt, bs, hs,
                                      sm + s.oM, s, zs + warp * kP * s.ldz, dss + warp * 16,
                                      sm + s.oDh + bwarp * s.Ah, sm + s.oC + bwarp * 16 * s.ldc,
                                      with_de, de + static_cast<size_t>(r0 + warp) * kF * s.D);
    }
    group_sync(grp, kBwdThreads);  // every row's dz and ds are in; gs is free
    if (next < tiles) copy_rows(g, next * s.R, B, 1, s.D, s.R, s.ldf, s.vec, gs, tid, kBwdThreads);
    cp_async_commit();

    // dW += c^T dz over the tile's rows; db over the rows r = rg (mod RG)
    for (int r = 0; r < rows; ++r) {
      const float* e_r = es + r * kF * s.ldf;
      const float* z_r = zs + r * kP * s.ldz;
      float ev[kF][kJD];
#pragma unroll
      for (int j = 0; j < kJD; ++j) {
        const int d = dbase + s.RG * j;
#pragma unroll
        for (int f = 0; f < kF; ++f) ev[f][j] = d < s.D ? e_r[f * s.ldf + d] : 0.f;
      }
      const bool mine = with_de && r % s.RG == rg;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        float dz[kJA];
#pragma unroll
        for (int q = 0; q < kJA; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(z_r + p * s.ldz + a0 + q);
          dz[q] = v.x, dz[q + 1] = v.y, dz[q + 2] = v.z, dz[q + 3] = v.w;
        }
        if (mine) {
#pragma unroll
          for (int q = 0; q < kJA; ++q) db_acc[q] += dz[q];
        }
#pragma unroll
        for (int j = 0; j < kJD; ++j) {
          const float c = ev[pair_i(p)][j] * ev[pair_j(p)][j];
#pragma unroll
          for (int q = 0; q < kJA; ++q) dw_acc[j][q] = fmaf(c, dz[q], dw_acc[j][q]);
        }
      }
    }
    group_sync(grp, kBwdThreads);  // es and zs are free
    if (next < tiles) copy_rows(fields, next * s.R, B, kF, s.D, s.R, s.ldf, s.vec, es, tid, kBwdThreads);
    cp_async_commit();
  }

  // this group's partial sums: its panel's rows of dW from registers; db
  // summed over the row groups in order, dh over the group's warps in order (panel 0)
  float* dwp = dw_part + static_cast<size_t>(part) * s.D * s.A;
#pragma unroll
  for (int j = 0; j < kJD; ++j) {
    const int d = dbase + s.RG * j;
    if (d < s.D) {
#pragma unroll
      for (int q = 0; q < kJA; ++q) {
        if (a0 + q < s.A) dwp[static_cast<size_t>(d) * s.A + a0 + q] = dw_acc[j][q];
      }
    }
  }
  if (!with_de) return;  // block-uniform
  cp_async_wait_all();
  group_sync(grp, kBwdThreads);  // zs is free: reuse it for the db reduction
  float* red_b = zs;
#pragma unroll
  for (int q = 0; q < kJA; ++q) red_b[rg * s.Ap + a0 + q] = db_acc[q];
  group_sync(grp, kBwdThreads);
  for (int a = tid; a < s.A; a += kBwdThreads) {
    float sh = 0.f, sb = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) sh += sm[s.oDh + (grp * kBwdWarps + w) * s.Ah + a];
    for (int r = 0; r < s.RG; ++r) sb += red_b[r * s.Ap + a];
    dh_part[static_cast<size_t>(part) * s.A + a] = sh;
    db_part[static_cast<size_t>(part) * s.A + a] = sb;
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

bool shape_ok(long long B, int D, int A) { return B >= 1 && D >= 1 && A >= 1 && A <= kMaxA; }

using FwdKernel = void (*)(const float*, const float*, const float*, const float*, float*, long long,
                          FwdShape);
using BwdKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                          float*, float*, float*, float*, long long, BwdShape);

// The instantiation for the layout: weights on chip or not, z's sum chunked
// past D = kUnchunked.
FwdKernel fwd_kernel(const FwdShape& s) {
  const bool chunked = s.D > kUnchunked;
  return s.on_chip ? (chunked ? afm_pool_fwd_kernel<true, true> : afm_pool_fwd_kernel<true, false>)
                   : (chunked ? afm_pool_fwd_kernel<false, true> : afm_pool_fwd_kernel<false, false>);
}

BwdKernel bwd_kernel(const BwdShape& s) {
  const bool chunked = s.D > kUnchunked;
  return s.on_chip ? (chunked ? afm_pool_bwd_kernel<true, true> : afm_pool_bwd_kernel<true, false>)
                   : (chunked ? afm_pool_bwd_kernel<false, true> : afm_pool_bwd_kernel<false, false>);
}

cudaError_t launch_fwd(const float* fields, const float* W, const float* b, const float* h,
                       float* out, long long B, const FwdShape& s, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(s);
  const FwdKernel kernel = fwd_kernel(s);
  long long most = 0;
  const cudaError_t err = persistent_blocks(kernel, smem, kFwdThreads, &most);
  if (err != cudaSuccess) return err;
  const long long tiles = (B + s.R - 1) / s.R, wanted = (tiles + kFwdGroups - 1) / kFwdGroups;
  const int blocks = static_cast<int>(wanted < most ? wanted : most);
  kernel<<<blocks, kFwdThreads, smem, stream>>>(fields, W, b, h, out, B, s);
  return cudaGetLastError();
}

// The partials of a backward launch: two (its groups') a block of each D-panel.
cudaError_t bwd_parts(long long B, const BwdShape& s, int* parts) {
  long long most = 0;
  const cudaError_t err = persistent_blocks(bwd_kernel(s), bwd_smem_bytes(s), kThreads, &most);
  if (err != cudaSuccess) return err;
  const long long tiles = (B + s.R - 1) / s.R, wanted = (tiles + kBwdGroups - 1) / kBwdGroups;
  const long long per_panel = most / s.P > 0 ? most / s.P : 1;
  *parts = static_cast<int>(kBwdGroups * (wanted < per_panel ? wanted : per_panel));
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* afm_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int afm_attention_num_fields() { return kF; }
int afm_attention_max_attention() { return kMaxA; }

// The shared memory of each kernel's layout at (D, A), for the launcher's checks.
size_t afm_attention_fwd_smem_bytes(int D, int A) { return fwd_smem_bytes(fit_fwd_shape(D, A)); }
size_t afm_attention_bwd_smem_bytes(int D, int A) { return bwd_smem_bytes(fit_bwd_shape(D, A)); }

// fields [B, 6, D], W [D, A], b [A], h [A] f32 -> out [B, D] f32.
int afm_attention_fwd(const void* fields, const void* W, const void* b, const void* h, void* out,
                      long long B, int D, int A, void* stream) {
  if (!shape_ok(B, D, A)) return cudaErrorInvalidValue;
  FwdShape s = fit_fwd_shape(D, A);
  s.vec = s.vec && reinterpret_cast<uintptr_t>(fields) % 16 == 0;
  if (fwd_smem_bytes(s) > kSmemLimit) return cudaErrorInvalidValue;
  const auto* f = static_cast<const float*>(fields);
  const auto* w = static_cast<const float*>(W);
  const auto* bb = static_cast<const float*>(b);
  const auto* hh = static_cast<const float*>(h);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return launch_fwd(f, w, bb, hh, o, B, s, st);
}

// The number of partials afm_attention_bwd writes, for the launcher to size
// dw_part [parts, D, A], db_part and dh_part [parts, A]; -1 if it takes no launch.
int afm_attention_bwd_blocks(long long B, int D, int A) {
  if (!shape_ok(B, D, A)) return -1;
  const BwdShape s = fit_bwd_shape(D, A);
  if (bwd_smem_bytes(s) > kSmemLimit) return -1;
  int parts = 0;
  const cudaError_t err = bwd_parts(B, s, &parts);
  return err == cudaSuccess ? parts : -1;
}

// fields [B, 6, D], W [D, A], b [A], h [A], g [B, D] f32 -> de [B, 6, D] and the
// per-block partials; `blocks` (partials) as afm_attention_bwd_blocks gave it.
int afm_attention_bwd(const void* fields, const void* W, const void* b, const void* h,
                      const void* g, void* de, void* dw_part, void* db_part, void* dh_part,
                      long long B, int D, int A, int blocks, void* stream) {
  if (!shape_ok(B, D, A) || blocks < 1 || blocks % kBwdGroups != 0) return cudaErrorInvalidValue;
  BwdShape s = fit_bwd_shape(D, A);
  s.vec = s.vec && reinterpret_cast<uintptr_t>(fields) % 16 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const size_t smem = bwd_smem_bytes(s);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const BwdKernel kernel = bwd_kernel(s);
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const auto* f = static_cast<const float*>(fields);
  const auto* w = static_cast<const float*>(W);
  const auto* bb = static_cast<const float*>(b);
  const auto* hh = static_cast<const float*>(h);
  const auto* gg = static_cast<const float*>(g);
  auto* d = static_cast<float*>(de);
  auto* dwp = static_cast<float*>(dw_part);
  auto* dbp = static_cast<float*>(db_part);
  auto* dhp = static_cast<float*>(dh_part);
  const auto st = static_cast<cudaStream_t>(stream);
  const int grid = blocks / kBwdGroups * s.P;
  kernel<<<grid, kThreads, smem, st>>>(f, w, bb, hh, gg, d, dwp, dbp, dhp, B, s);
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
