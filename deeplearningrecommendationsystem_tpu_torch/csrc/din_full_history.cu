// DIN's full-history catalog scorer for Hopper (sm_90a), forward only, with a
// plain C interface for ctypes: every (user, item) pair scored against the
// user's complete, unpadded history.
//
// Replaces no Pallas kernel: the JAX package scores full histories through XLA
// (models/base.py::catalog_scores_full_history: length buckets, right padding,
// masked attention). This kernel was added because that composition, ported as
// it is, spent most of a catalog refresh on padding and on the activation
// unit's first layer, recomputed for every item. Its plain PyTorch version is
// din_full_history_scores_plain in
// deeplearningrecommendationsystem_tpu_torch/ops/din_full_history.py: the
// bucketed, masked scorer.
//
// What it computes, for user u with history ids h_1 .. h_n (n >= 1; the
// launcher makes an empty history one position of id 0) and every item i. The
// activation unit's first layer is decomposed (wh = W1_h + W1_(h-t),
// wt = W1_t - W1_(h-t)) and hoisted out of the (user, item, position) loop into
// two [I, A1] tables the launcher makes with two plain products, HW = item wh
// and TW = item wt + b1, so that h_l wh is HW[h_l]:
//   z1_l = HW[h_l] + TW[i],  s_l = relu(relu(z1_l) w2 + b2) w3,
//   w = softmax_l(s),  pooled[u][i] = sum_l w_l item[h_l]                    [D]
// The last layer's bias shifts every score of a pair alike and cancels in the
// softmax, so it is dropped. The fc head then runs on the pooled rows
// (din_head.cu's din_head_fwd_fc, launched by the same Python launcher).
//
// Bound: operations. Per (user, item, position) the second layer takes
// 2 A1 A2 products, 16,384 at the DIN preset (D 64, A 128, 64); ml-100k's
// 100,000 positions by 1,682 items make 2.76e12, which in float32 accuracy on
// the tensor cores (3xTF32, tf32_mma.cuh: three TF32 products each) is 16.7 ms
// at 495 TFLOP/s, and about 27 ms at the 63% of it that mma.sync reaches on an
// H100 (tools/probe_mma_rate.py). The first layer's sums, relus and splits, the
// epilogue and the online softmax and pool, about 900 operations per (user,
// item, position), run on the CUDA cores beside them: 2.3 ms at 67 TFLOP/s.
// The bytes (the two tables, the item table, the histories, the pooled rows
// written once, 0.4 GB) take 0.13 ms.
//
// The design:
// * A unit of work is (user, kItems = 16 items): one m16 tile's rows. A warp
//   walks its units alone, with no block barrier after the set-up; persistent
//   blocks of kWarps warps stage w2 once in shared memory, already split into
//   TF32 hi and lo parts (din_pool.cuh's SplitMat layout: one 16-byte load a B
//   fragment, no bank conflicts), with b2 and w3 and zeros past every width.
//   Units are taken longest history first (the launcher's order), dealt to the
//   warps in a snake (round r deals units r W .. r W + W - 1, forwards in even
//   rounds and backwards in odd ones), so that every warp gets a like sum of
//   positions and the tail of the grid is short. Lengths run from 1 to about
//   700 at ml-100k: nothing is padded to a bucket.
// * A unit stages its 16 items' TW rows in the warp's part of shared memory,
//   then walks the history kStep = 2 positions at a time: two m16 tiles, one a
//   position, that share each B fragment of w2, so a shared-memory load feeds
//   six mma.sync. A row's z1 is formed in registers from HW (read through L1)
//   and the staged TW, relu'd, split into hi and lo and put straight into the A
//   fragments: slot t takes column k0 + 2t and slot t + 4 column k0 + 2t + 1,
//   the permutation of din_pool.cuh, so an A fragment is one 8-byte load. The
//   second layer goes over column panels of 64 (8 n8 tiles), zero padded, so no
//   mma.sync is predicated. Its k loop is unrolled by 8, so that the next
//   k-steps' loads are in flight during a k-step's products: on an H100 at
//   din-refresh's shapes 38.5 ms, against 47.3 not unrolled and 45.5 with the
//   next step's rows prefetched into L1 instead (226 registers, no spills).
//   The epilogue adds b2, takes the relu, multiplies by w3 and sums each row
//   over the quad by shuffles: every lane of a quad then holds the scores of
//   its rows g and g + 8 at both positions. A position past the history's end
//   (the second of an odd last step) scores -inf.
// * The softmax is online, per item, in registers: a running max, a running sum
//   and the running pooled row, rescaled once a step; a lane keeps columns
//   16 j + 4 t .. 16 j + 4 t + 3 (j < D / 16) of its two items, so the pool is
//   four float4 loads of each position's item row and fmas, no shuffles, and
//   the pooled row is divided by the sum and written once at the unit's end.
// Widths D, A1, A2 are multiples of 4 and D is at most kMaxD (a lane's pooled
// columns live in registers). Every sum has a fixed order and there are no
// atomics, so a launch repeats bit for bit.
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

using tf32mma::mma_3xtf32;
using tf32mma::split_tf32_bits;

constexpr int kWarps = 8;  // warps of a block, each on its own units
constexpr int kThreads = 32 * kWarps;
constexpr int kItems = 16;   // items of a unit: one m16 tile's rows
constexpr int kStep = 2;     // history positions a step: m16 tiles that share each B fragment
constexpr int kPanel = 8;    // n8 tiles of a column panel of the second layer
constexpr int kMaxD = 64;    // the widest embedding: a lane holds D / 4 pooled columns of two items
constexpr int kCols = kMaxD / 16;  // float4 columns of an item that a lane holds
constexpr size_t kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;

int round_to(int n, int m) { return (n + m - 1) / m * m; }
int stride8(int n) { return n + (8 - n % 32 + 32) % 32; }

// Widths and the offsets (floats) of shared memory.
struct Layout {
  int D, A1, A2;
  int A1p, A2p;  // A1 rounded up to the mma's k (8), A2 to a column panel (64)
  int P2;        // 16-byte chunks a row of the split w2: A1p / 2, rounded up to 8
  int ldt;       // row stride (floats) of a warp's TW tile, 8 mod 32: a warp's
                 // fragment loads touch every bank once a half-warp
  // the split w2 [A2p][P2] (16-byte chunks), b2, w3 [A2p], the warps' TW tiles [kItems][ldt]
  int oW2, oB2, oW3, oTW;
  int total;
};

bool widths_ok(int D, int A1, int A2) {
  auto ok = [](int n) { return n >= 4 && n % 4 == 0; };
  return ok(D) && ok(A1) && ok(A2) && D <= kMaxD;
}

Layout make_layout(int D, int A1, int A2) {
  Layout s;
  s.D = D, s.A1 = A1, s.A2 = A2;
  s.A1p = round_to(A1, 8), s.A2p = round_to(A2, 8 * kPanel);
  s.P2 = round_to(s.A1p / 2, 8);
  s.ldt = stride8(s.A1p);
  int o = 0;
  auto take = [&o](int n) {
    const int start = o;
    o += round_to(n, 4);
    return start;
  };
  s.oW2 = take(4 * s.A2p * s.P2);
  s.oB2 = take(s.A2p);
  s.oW3 = take(s.A2p);
  s.oTW = take(kWarps * kItems * s.ldt);
  s.total = o;
  return s;
}

size_t smem_bytes(const Layout& s) { return sizeof(float) * static_cast<size_t>(s.total); }

struct Args {
  const int* offsets;  // [U + 1] each user's first position in ids, and the end
  const int* order;    // [U] the users, longest history first
  const int* ids;      // [N] the histories' item ids, user after user
  const float* hw;     // [I][A1] item wh
  const float* tw;     // [I][A1] item wt + b1
  const float* item;   // [I][D] the item table
  const float* w2;     // [A1][A2]
  const float* b2;     // [A2]
  const float* w3;     // [A2] (the [A2, 1] weight)
  float* pooled;       // [U][I][D]
  int U, I;
};

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// w2 [A1][A2] into its split form at dst: A2p rows n of P2 chunks (hi w2[k][n],
// hi w2[k + 1][n], lo w2[k][n], lo w2[k + 1][n]), chunk k / 2 of row n at
// (k / 2) ^ (4 (n & 1)), zeros past the widths (A1 is a multiple of 4, so k < A1
// means k + 1 < A1).
__device__ __forceinline__ void stage_w2(const float* __restrict__ w2, const Layout& s, uint4* dst) {
  for (int e = threadIdx.x; e < s.A2p * s.P2; e += kThreads) {
    const int n = e / s.P2, q = e - n * s.P2, k = 2 * q;
    const bool in = n < s.A2 && k < s.A1;
    const float x0 = in ? __ldg(w2 + static_cast<size_t>(k) * s.A2 + n) : 0.f;
    const float x1 = in ? __ldg(w2 + static_cast<size_t>(k + 1) * s.A2 + n) : 0.f;
    uint4 v;
    split_tf32_bits(x0, v.x, v.z);
    split_tf32_bits(x1, v.y, v.w);
    dst[n * s.P2 + (q ^ ((n & 1) << 2))] = v;
  }
}

// The B fragment (hi and lo) of column n, rows k and k + 1 (k even) of the split w2.
__device__ __forceinline__ void w2_frag(const uint4* w2s, int P2, int n, int k, uint32_t (&bh)[2],
                                        uint32_t (&bl)[2]) {
  const uint4 w = w2s[n * P2 + ((k >> 1) ^ ((n & 1) << 2))];
  bh[0] = w.x, bh[1] = w.y, bl[0] = w.z, bl[1] = w.w;
}

// The scores of this warp's 16 items (rows g, g + 8) against history ids id0
// and id1: sc[m][r] for position m, row g + 8 r, in every lane of the quad.
// ta, tb: the lane's TW rows g and g + 8, column 2t.
__device__ __forceinline__ void step_scores(const Args& a, const Layout& s, const uint4* w2s,
                                            const float* b2s, const float* w3s, const float* ta,
                                            const float* tb, int id0, int id1, int g, int t,
                                            float (&sc)[kStep][2]) {
  const float* h0 = a.hw + static_cast<size_t>(id0) * s.A1 + 2 * t;
  const float* h1 = a.hw + static_cast<size_t>(id1) * s.A1 + 2 * t;
  float part[kStep][2] = {};
  for (int n2 = 0; n2 < s.A2p; n2 += 8 * kPanel) {
    float acc[kStep][kPanel][4] = {};
#pragma unroll 8
    for (int k0 = 0; k0 < s.A1p; k0 += 8) {
      const bool in = k0 + 2 * t < s.A1;  // A1 % 4 == 0: column k0 + 2t + 1 too
      const float2 x0 = in ? ldg2(h0 + k0) : make_float2(0.f, 0.f);
      const float2 x1 = in ? ldg2(h1 + k0) : make_float2(0.f, 0.f);
      const float2 u = *reinterpret_cast<const float2*>(ta + k0);
      const float2 v = *reinterpret_cast<const float2*>(tb + k0);
      uint32_t ah[kStep][4], al[kStep][4];
      // A fragment of position m: (g, slot t) column k0 + 2t, (g + 8, slot t),
      // (g, slot t + 4) column k0 + 2t + 1, (g + 8, slot t + 4)
      split_tf32_bits(relu(x0.x + u.x), ah[0][0], al[0][0]);
      split_tf32_bits(relu(x0.x + v.x), ah[0][1], al[0][1]);
      split_tf32_bits(relu(x0.y + u.y), ah[0][2], al[0][2]);
      split_tf32_bits(relu(x0.y + v.y), ah[0][3], al[0][3]);
      split_tf32_bits(relu(x1.x + u.x), ah[1][0], al[1][0]);
      split_tf32_bits(relu(x1.x + v.x), ah[1][1], al[1][1]);
      split_tf32_bits(relu(x1.y + u.y), ah[1][2], al[1][2]);
      split_tf32_bits(relu(x1.y + v.y), ah[1][3], al[1][3]);
      uint32_t bh[kPanel][2], bl[kPanel][2];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) w2_frag(w2s, s.P2, n2 + 8 * j + g, k0 + 2 * t, bh[j], bl[j]);
#pragma unroll
      for (int m = 0; m < kStep; ++m) mma_3xtf32(acc[m], ah[m], al[m], bh, bl);
    }
    // C fragment of n8 tile j: (g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1)
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      const int c = n2 + 8 * j + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(b2s + c);
      const float2 w = *reinterpret_cast<const float2*>(w3s + c);
#pragma unroll
      for (int m = 0; m < kStep; ++m) {
        part[m][0] = fmaf(relu(acc[m][j][0] + b.x), w.x, part[m][0]);
        part[m][0] = fmaf(relu(acc[m][j][1] + b.y), w.y, part[m][0]);
        part[m][1] = fmaf(relu(acc[m][j][2] + b.x), w.x, part[m][1]);
        part[m][1] = fmaf(relu(acc[m][j][3] + b.y), w.y, part[m][1]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kStep; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = part[m][r];
      x += __shfl_xor_sync(kFull, x, 1);
      x += __shfl_xor_sync(kFull, x, 2);
      sc[m][r] = x;
    }
  }
}

// One unit: items i0 .. i0 + 15 against user's history, pooled rows to a.pooled.
__device__ __forceinline__ void score_unit(const Args& a, const Layout& s, const uint4* w2s,
                                           const float* b2s, const float* w3s, float* TW, int user,
                                           int i0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // the last unit's reads of TW are done
  const int c4 = s.A1p >> 2;
  for (int e = lane; e < kItems * c4; e += 32) {
    const int r = e / c4, c = 4 * (e - r * c4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i0 + r < a.I && c < s.A1) v = ldg4(a.tw + static_cast<size_t>(i0 + r) * s.A1 + c);
    *reinterpret_cast<float4*>(TW + r * s.ldt + c) = v;
  }
  __syncwarp();
  const int beg = __ldg(a.offsets + user), n = __ldg(a.offsets + user + 1) - beg;
  const int* hist = a.ids + beg;
  const float* ta = TW + g * s.ldt + 2 * t;
  const float* tb = ta + 8 * s.ldt;
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf}, den[2] = {0.f, 0.f};
  float4 pool[2][kCols];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) pool[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int p = 0; p < n; p += kStep) {
    const int id0 = __ldg(hist + p), id1 = p + 1 < n ? __ldg(hist + p + 1) : id0;
    float sc[kStep][2];
    step_scores(a, s, w2s, b2s, w3s, ta, tb, id0, id1, g, t, sc);
    if (p + 1 >= n) sc[1][0] = sc[1][1] = neg_inf;
    const float* e0 = a.item + static_cast<size_t>(id0) * s.D;
    const float* e1 = a.item + static_cast<size_t>(id1) * s.D;
    float4 x0[kCols], x1[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = 16 * j + 4 * t;
      x0[j] = d < s.D ? ldg4(e0 + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      x1[j] = d < s.D ? ldg4(e1 + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], fmaxf(sc[0][r], sc[1][r]));
      const float scale = expf(mx[r] - m);  // 0 at the first step, where mx is -inf
      const float p0 = expf(sc[0][r] - m), p1 = expf(sc[1][r] - m);
      den[r] = den[r] * scale + p0 + p1;
      mx[r] = m;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float4& o = pool[r][j];
        o.x = fmaf(p1, x1[j].x, fmaf(p0, x0[j].x, o.x * scale));
        o.y = fmaf(p1, x1[j].y, fmaf(p0, x0[j].y, o.y * scale));
        o.z = fmaf(p1, x1[j].z, fmaf(p0, x0[j].z, o.z * scale));
        o.w = fmaf(p1, x1[j].w, fmaf(p0, x0[j].w, o.w * scale));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    if (i >= a.I) continue;
    float* out = a.pooled + (static_cast<size_t>(user) * a.I + i) * s.D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = 16 * j + 4 * t;
      if (d < s.D) {
        const float4 o = pool[r][j];
        *reinterpret_cast<float4*>(out + d) =
            make_float4(o.x / den[r], o.y / den[r], o.z / den[r], o.w / den[r]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) din_full_history_kernel(Args a, Layout s) {
  extern __shared__ __align__(16) float sm[];
  stage_w2(a.w2, s, reinterpret_cast<uint4*>(sm + s.oW2));
  for (int i = threadIdx.x; i < s.A2p; i += kThreads) {
    sm[s.oB2 + i] = i < s.A2 ? __ldg(a.b2 + i) : 0.f;
    sm[s.oW3 + i] = i < s.A2 ? __ldg(a.w3 + i) : 0.f;
  }
  __syncthreads();  // the weights are in place; from here each warp walks alone
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint4* w2s = reinterpret_cast<const uint4*>(sm + s.oW2);
  float* TW = sm + s.oTW + warp * kItems * s.ldt;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long me = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const int groups = (a.I + kItems - 1) / kItems;
  const long long units = static_cast<long long>(a.U) * groups;
  for (long long r = 0;; ++r) {  // the snake: a warp's units only grow from round to round
    const long long e = r * warps + ((r & 1) ? warps - 1 - me : me);
    if (e >= units) break;
    score_unit(a, s, w2s, sm + s.oB2, sm + s.oW3, TW, __ldg(a.order + e / groups),
               static_cast<int>(e % groups) * kItems, lane);
  }
}

}  // namespace

extern "C" {

const char* din_full_history_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int din_full_history_item_tile() { return kItems; }
int din_full_history_position_step() { return kStep; }
int din_full_history_max_dim() { return kMaxD; }
int din_full_history_warps() { return kWarps; }

// 1 where the kernel takes embedding width D and attention widths (A1, A2):
// multiples of 4, D at most kMaxD, and the split w2 beside the warps' TW tiles
// within a block's shared memory; else 0. ops/cuda/din_full_history.py::fits
// mirrors it.
int din_full_history_fits(int D, int A1, int A2) {
  return widths_ok(D, A1, A2) && smem_bytes(make_layout(D, A1, A2)) <= kSmemLimit ? 1 : 0;
}

// offsets [U + 1], order [U], ids [N] int32; hw, tw [I, A1], item [I, D],
// w2 [A1, A2], b2 [A2], w3 [A2] f32 -> pooled [U, I, D] f32.
int din_full_history_pool(const void* offsets, const void* order, const void* ids, const void* hw,
                          const void* tw, const void* item, const void* w2, const void* b2,
                          const void* w3, void* pooled, int U, int I, int D, int A1, int A2,
                          void* stream) {
  if (U < 1 || I < 1 || !din_full_history_fits(D, A1, A2)) return cudaErrorInvalidValue;
  const Layout s = make_layout(D, A1, A2);
  const size_t smem = smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(din_full_history_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, din_full_history_kernel, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long units = static_cast<long long>(U) * ((I + kItems - 1) / kItems);
  const long long wanted = (units + kWarps - 1) / kWarps, most = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(wanted < most ? wanted : most);
  const Args a{static_cast<const int*>(offsets), static_cast<const int*>(order),
               static_cast<const int*>(ids),     static_cast<const float*>(hw),
               static_cast<const float*>(tw),    static_cast<const float*>(item),
               static_cast<const float*>(w2),    static_cast<const float*>(b2),
               static_cast<const float*>(w3),    static_cast<float*>(pooled),
               U,
               I};
  din_full_history_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, s);
  return cudaGetLastError();
}

}  // extern "C"
