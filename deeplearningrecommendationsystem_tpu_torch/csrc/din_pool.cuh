// DIN's attention unit, softmax and pool on Hopper's tensor cores in float32
// accuracy (3xTF32 mma.sync m16n8k8, tf32_mma.cuh): din_pool_kernel and its
// launch. din_attention.cu launches it as the window pool (the last bias
// dropped); din_head.cu as the float32 head's attention stage (kB3: the last
// bias kept), whose fc head then runs on the pooled rows.
//
// What it computes, per row of history h [L, D] and target t [D], with the
// decomposed first layer wh = W1_h + W1_(h-t), wt = W1_t - W1_(h-t) [D, A1]:
//   z1_l = h_l wh + t wt + b1,  s_l = relu(relu(z1_l) w2 + b2) w3 (+ b3),
//   w = softmax_l(s),  pooled = sum_l w_l h_l                                [D]
//
// The design:
// * Persistent blocks (one an SM) that stage wh and w2 once in shared memory,
//   already split into TF32 hi and lo parts (128 KB at the preset, SplitMat),
//   with b1, b2 and w3 and zeros past every width; wt, a twenty-first of the
//   products, is read from device memory through L1. Where the split weights
//   do not fit beside a tile, the same code reads all the weights from device
//   memory and splits them as it goes (din_pool_kernel<false>). A1 and A2 are
//   padded with zeros to column panels of 64, so no mma.sync is predicated (a
//   predicated one costs a warp synchronisation).
// * A block is two groups of 8 warps, each walking its own tiles with its own
//   buffer (named barriers): while one group waits for its tile's cp.async
//   copy or runs its softmax and pool, the other's products keep the tensor
//   cores busy. A tile is R rows, R * L positions (R picked so that the
//   positions fill a group's m16 tiles: 12 rows, 120 positions at L 10); rows
//   past B are zero-filled by the copy, never read.
// * t wt + b1 once a row: warps take (16 rows, 2 n8 tiles) tasks on the tensor
//   cores, into T in shared memory.
// * A warp takes an m16 tile of positions at a time (the tile's R * L positions
//   flattened): z1 = h wh + T, 3xTF32 mma.sync m16n8k8 over column panels of
//   64, h split into hi and lo as it is loaded (tf32_bits); relu(z1) stays in
//   the accumulators and goes register to register into the second layer as
//   its A operand. The C fragment of n8 tile j holds columns 8j + 2t and
//   8j + 2t + 1 of rows g and g + 8; the second layer's k-step over those 8
//   columns takes column 8j + 2t as its k slot t and 8j + 2t + 1 as slot t + 4,
//   so a0 = c0, a1 = c2, a2 = c1, a3 = c3, and its B fragment holds rows 8j + 2t
//   and 8j + 2t + 1 of w2 (one 16-byte load of the split w2, hi and lo). Every
//   k-step of the first layer permutes its slots the same way, so an A fragment
//   is one 8-byte load of a row. The three products of 3xTF32 go pass by pass
//   over two n8 tiles at a time (more B fragments in registers would spill).
//   The epilogue adds b2, takes the relu, multiplies by w3 and sums the quad by
//   shuffles: only the 16 scores go to shared memory.
// * One warp a row for the softmax over its L scores; then one thread an
//   output for the pool sum_l w_l h_l, float32 on CUDA cores, from the staged
//   history, straight to device memory.
// Widths D, A1, A2 are multiples of 4 and L at most 64 (din_common.cuh's
// widths_ok); a fragment slot past a width holds a zero. Every sum has a fixed
// order and there are no atomics, so a launch repeats bit for bit.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "din_common.cuh"
#include "tf32_mma.cuh"

namespace dinpool {

using tf32mma::cp_async16_or_zero;
using tf32mma::cp_async_commit;
using tf32mma::cp_async_wait_all;
using tf32mma::mma_3xtf32;
using tf32mma::split_tf32_bits;

constexpr int kGroups = 2;  // groups of 8 warps a block, each on its own tiles
constexpr int kGroupThreads = 256;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kWarps = kGroupThreads / 32;  // warps of a group
constexpr int kMaxRows = 32;  // rows of a tile at most
constexpr int kPanel = 8;     // n8 tiles of a column panel
constexpr int kHalf = 2;      // B fragments in registers at once
constexpr int kTaskN = 2;     // n8 tiles of a t wt task
constexpr size_t kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;

// Widths, the tile and the offsets (floats) of shared memory. Row strides are
// 8 mod 32 floats, so the 8-byte fragment loads of a warp (8 rows g, 4 pairs t)
// touch every bank once a half-warp.
struct PoolLayout {
  int L, D, A1, A2;
  int R, M, Mp, Rp;    // rows of a tile, its positions; both rounded up to 16
  int Dk, A1p, A2p;    // D rounded up to the mma's 8; A1, A2 to a column panel (64)
  int ldh, ldt;        // row strides (floats) of H and X (Dk wide), of T (A1p wide)
  int P1, P2;          // 16-byte chunks a row of whS (Dk / 2) and w2S (A1p / 2), to 8
  int oWh, oW2, oB1, oB2, oW3;  // the weights, when on chip
  int oH, oX, oT, oS;  // a group's H [Mp][ldh], X [Rp][ldh], T [R][ldt], S [Mp], each group's in turn
  int total;
  bool on_chip;
};

int round_to(int n, int m) { return (n + m - 1) / m * m; }
int stride8(int n) { return n + (8 - n % 32 + 32) % 32; }

PoolLayout make_layout(int L, int D, int A1, int A2, int R, bool on_chip) {
  PoolLayout s;
  s.L = L, s.D = D, s.A1 = A1, s.A2 = A2, s.R = R, s.M = R * L;
  s.Mp = round_to(s.M, 16), s.Rp = round_to(R, 16);
  s.Dk = round_to(D, 8), s.A1p = round_to(A1, 8 * kPanel), s.A2p = round_to(A2, 8 * kPanel);
  s.ldh = stride8(s.Dk), s.ldt = stride8(s.A1p);
  s.P1 = round_to(s.Dk / 2, 8), s.P2 = round_to(s.A1p / 2, 8);
  int o = 0;
  auto take = [&o](int n) {
    const int start = o;
    o += round_to(n, 4);
    return start;
  };
  s.on_chip = on_chip;
  s.oWh = on_chip ? take(4 * s.A1p * s.P1) : -1;
  s.oW2 = on_chip ? take(4 * s.A2p * s.P2) : -1;
  s.oB1 = on_chip ? take(s.A1p) : -1;
  s.oB2 = on_chip ? take(s.A2p) : -1;
  s.oW3 = on_chip ? take(s.A2p) : -1;
  s.oH = take(kGroups * s.Mp * s.ldh);
  s.oX = take(kGroups * s.Rp * s.ldh);
  s.oT = take(kGroups * s.R * s.ldt);
  s.oS = take(kGroups * s.Mp);
  s.total = o;
  return s;
}

size_t smem_bytes(const PoolLayout& s) { return sizeof(float) * static_cast<size_t>(s.total); }

// The layout with the weights on chip if any tile fits beside them, else in
// device memory; then the tile (at most kMaxRows rows) whose positions fill the
// most of its warps' m16 tiles, the larger on a tie.
bool fit_layout(int L, int D, int A1, int A2, PoolLayout* out) {
  for (bool on_chip : {true, false}) {
    double best = 0.0;
    for (int R = 1; R <= kMaxRows; ++R) {
      const PoolLayout s = make_layout(L, D, A1, A2, R, on_chip);
      if (smem_bytes(s) > kSmemLimit) break;
      const int rounds = (s.Mp / 16 + kWarps - 1) / kWarps;
      const double filled = static_cast<double>(s.M) / (16.0 * kWarps * rounds);
      if (filled >= best) best = filled, *out = s;
    }
    if (best > 0.0) return true;
  }
  return false;
}

struct PoolWeights {
  const float *wh, *wt, *b1, *w2, *b2, *w3;  // wh, wt [D][A1], w2 [A1][A2]: the launcher's
};

// A weight matrix W [K][N] as the B operand: frag(n, k) gives the hi and lo
// parts (3xTF32) of W[k][n] and W[k + 1][n], k even (B's slots t and t + 4 of
// column n), zeros past the widths.
//
// On chip, split once a block: W^T as 16-byte chunks (hi W[k][n], hi
// W[k + 1][n], lo W[k][n], lo W[k + 1][n]), P chunks a row (a multiple of 8),
// chunk k / 2 of row n at (k / 2) ^ (4 (n & 1)): a quarter-warp's loads (rows
// g, g + 1; four neighbouring chunks t) touch every bank once, with no padding.
struct SplitMat {
  const uint4* p;
  int P;
  __device__ __forceinline__ void frag(int n, int k, uint32_t (&bh)[2], uint32_t (&bl)[2]) const {
    const uint4 w = p[n * P + ((k >> 1) ^ ((n & 1) << 2))];
    bh[0] = w.x, bh[1] = w.y, bl[0] = w.z, bl[1] = w.w;
  }
};

// In device memory, row-major, split as it is read (K is a multiple of 4, so
// k < K means k + 1 < K).
struct GlobalMat {
  const float* __restrict__ p;
  int K, N;
  __device__ __forceinline__ void frag(int n, int k, uint32_t (&bh)[2], uint32_t (&bl)[2]) const {
    const bool in = n < N && k < K;
    const float x0 = in ? __ldg(p + static_cast<size_t>(k) * N + n) : 0.f;
    const float x1 = in ? __ldg(p + static_cast<size_t>(k + 1) * N + n) : 0.f;
    split_tf32_bits(x0, bh[0], bl[0]);
    split_tf32_bits(x1, bh[1], bl[1]);
  }
};

template <bool kOnChip>
using Mat = std::conditional_t<kOnChip, SplitMat, GlobalMat>;

// W [K][N] (device memory) into its SplitMat form at dst: rows (N padded) rows of P chunks.
__device__ __forceinline__ void stage_split(const float* __restrict__ W, int K, int N, int rows,
                                            int P, uint4* dst) {
  for (int e = threadIdx.x; e < rows * P; e += kThreads) {
    const int n = e / P, q = e - n * P, k = 2 * q;
    const bool in = n < N && k < K;
    const float x0 = in ? __ldg(W + static_cast<size_t>(k) * N + n) : 0.f;
    const float x1 = in ? __ldg(W + static_cast<size_t>(k + 1) * N + n) : 0.f;
    uint4 v;
    split_tf32_bits(x0, v.x, v.z);
    split_tf32_bits(x1, v.y, v.w);
    dst[n * P + (q ^ ((n & 1) << 2))] = v;
  }
}

template <bool kOnChip>
struct Vec {
  const float* p;
  int n;
  __device__ __forceinline__ float2 pair(int i) const {
    if constexpr (kOnChip) {
      return *reinterpret_cast<const float2*>(p + i);  // zero padded
    } else {
      return i < n ? make_float2(__ldg(p + i), __ldg(p + i + 1)) : make_float2(0.f, 0.f);
    }
  }
};

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// The A fragment (hi and lo) of rows g, g + 8 of a row-major tile at p (this
// lane's row g, column k0 + 2t; stride ld): slot t takes column k0 + 2t and
// slot t + 4 column k0 + 2t + 1.
__device__ __forceinline__ void load_a(const float* p, int ld, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 v = *reinterpret_cast<const float2*>(p + 8 * ld);
  split_tf32_bits(u.x, ah[0], al[0]);
  split_tf32_bits(v.x, ah[1], al[1]);
  split_tf32_bits(u.y, ah[2], al[2]);
  split_tf32_bits(v.y, ah[3], al[3]);
}


// The history and target rows of the tile at r0 into H [M][ldh], X [R][ldh]
// (columns below D), asynchronously: one commit group. Rows past B are zeros.
// Threads take fixed 16-byte column chunks of every rows_per-th row, so the
// loops divide nothing.
__device__ __forceinline__ void stage_tile(const float* __restrict__ hist,
                                           const float* __restrict__ tgt, long long r0,
                                           long long B, const PoolLayout& s, float* H, float* X,
                                           int tid) {
  const int d4 = s.D >> 2, cols = min(d4, kGroupThreads), rows_per = kGroupThreads / cols;
  const int first = tid / cols, c0 = tid - first * cols;
  if (first < rows_per) {
    const int rows = static_cast<int>(B - r0 < s.R ? B - r0 : s.R);  // rows below B
    const int live = rows * s.L;
    const float* h = hist + static_cast<size_t>(r0) * s.L * s.D;
    const float* t = tgt + static_cast<size_t>(r0) * s.D;
    for (int m = first; m < s.M; m += rows_per) {
      for (int c = c0; c < d4; c += cols) {
        const float* src = m < live ? h + static_cast<size_t>(m) * s.D + 4 * c : hist;
        cp_async16_or_zero(H + m * s.ldh + 4 * c, src, m < live);
      }
    }
    for (int r = first; r < s.R; r += rows_per) {
      for (int c = c0; c < d4; c += cols) {
        const float* src = r < rows ? t + static_cast<size_t>(r) * s.D + 4 * c : tgt;
        cp_async16_or_zero(X + r * s.ldh + 4 * c, src, r < rows);
      }
    }
  }
  cp_async_commit();
}

// T [R][ldt] = X wt + b1, on the tensor cores: tasks of 16 rows by kTaskN n8 tiles.
template <bool kOnChip>
__device__ __forceinline__ void target_term(const float* X, GlobalMat wt, Vec<kOnChip> b1,
                                            const PoolLayout& s, float* T, int warp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int groups = s.A1p / (8 * kTaskN);
  const int tasks = (s.Rp / 16) * groups;
  for (int task = warp; task < tasks; task += kWarps) {
    const int m0 = (task / groups) * 16, n0 = (task % groups) * 8 * kTaskN;
    float acc[kTaskN][4] = {};
    const float* xa = X + (m0 + g) * s.ldh + 2 * t;
#pragma unroll 4
    for (int k0 = 0; k0 < s.Dk; k0 += 8) {
      uint32_t ah[4], al[4], bh[kTaskN][2], bl[kTaskN][2];
      load_a(xa + k0, s.ldh, ah, al);
#pragma unroll
      for (int j = 0; j < kTaskN; ++j) wt.frag(n0 + 8 * j + g, k0 + 2 * t, bh[j], bl[j]);
      mma_3xtf32(acc, ah, al, bh, bl);
    }
#pragma unroll
    for (int j = 0; j < kTaskN; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      const float2 b = b1.pair(c);
      if (m0 + g < s.R) {  // T holds the tile's rows only
        *reinterpret_cast<float2*>(T + (m0 + g) * s.ldt + c) = make_float2(acc[j][0] + b.x, acc[j][1] + b.y);
      }
      if (m0 + g + 8 < s.R) {
        *reinterpret_cast<float2*>(T + (m0 + g + 8) * s.ldt + c) =
            make_float2(acc[j][2] + b.x, acc[j][3] + b.y);
      }
    }
  }
}

// The scores of positions m0 .. m0 + 15 into S: both layers on the tensor
// cores, relu(z1) handed from the first layer's accumulators to the second's A
// fragments in registers; with kB3, plus the last layer's bias b3.
template <bool kOnChip, bool kB3>
__device__ __forceinline__ void position_scores(int m0, const float* H, const float* T,
                                                Mat<kOnChip> wh, Mat<kOnChip> w2, Vec<kOnChip> b2,
                                                Vec<kOnChip> w3, float b3, const PoolLayout& s,
                                                float* S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pa = m0 + g, pb = pa + 8;
  const float* ta = pa < s.M ? T + (pa / s.L) * s.ldt + 2 * t : nullptr;
  const float* tb = pb < s.M ? T + (pb / s.L) * s.ldt + 2 * t : nullptr;
  const float* ha = H + pa * s.ldh + 2 * t;
  float score_a = 0.f, score_b = 0.f;
  constexpr int kH = kPanel / kHalf;  // n8 tile j of a panel is [j / kHalf][j % kHalf]
  for (int n2 = 0; n2 < s.A2p; n2 += 8 * kPanel) {
    float acc2[kH][kHalf][4] = {};
    for (int n1 = 0; n1 < s.A1p; n1 += 8 * kPanel) {
      float acc1[kH][kHalf][4];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        const float2 x = ta != nullptr ? *reinterpret_cast<const float2*>(ta + n1 + 8 * j)
                                       : make_float2(0.f, 0.f);
        const float2 y = tb != nullptr ? *reinterpret_cast<const float2*>(tb + n1 + 8 * j)
                                       : make_float2(0.f, 0.f);
        float* c = acc1[j / kHalf][j % kHalf];
        c[0] = x.x, c[1] = x.y, c[2] = y.x, c[3] = y.y;
      }
      for (int k0 = 0; k0 < s.Dk; k0 += 8) {
        uint32_t ah[4], al[4];
        load_a(ha + k0, s.ldh, ah, al);
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          uint32_t bh[kHalf][2], bl[kHalf][2];
#pragma unroll
          for (int j = 0; j < kHalf; ++j) {
            wh.frag(n1 + 8 * (h * kHalf + j) + g, k0 + 2 * t, bh[j], bl[j]);
          }
          mma_3xtf32(acc1[h], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        const float* c = acc1[j / kHalf][j % kHalf];
        uint32_t ah[4], al[4];
        // C -> A: (g, 2t) -> slot t, (g, 2t + 1) -> slot t + 4
        split_tf32_bits(relu(c[0]), ah[0], al[0]);
        split_tf32_bits(relu(c[2]), ah[1], al[1]);
        split_tf32_bits(relu(c[1]), ah[2], al[2]);
        split_tf32_bits(relu(c[3]), ah[3], al[3]);
        const int k = n1 + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          uint32_t bh[kHalf][2], bl[kHalf][2];
#pragma unroll
          for (int i = 0; i < kHalf; ++i) w2.frag(n2 + 8 * (h * kHalf + i) + g, k, bh[i], bl[i]);
          mma_3xtf32(acc2[h], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPanel; ++i) {
      const float* z = acc2[i / kHalf][i % kHalf];
      const int c = n2 + 8 * i + 2 * t;
      const float2 b = b2.pair(c), w = w3.pair(c);
      score_a = fmaf(relu(z[0] + b.x), w.x, score_a);
      score_a = fmaf(relu(z[1] + b.y), w.y, score_a);
      score_b = fmaf(relu(z[2] + b.x), w.x, score_b);
      score_b = fmaf(relu(z[3] + b.y), w.y, score_b);
    }
  }
  score_a += __shfl_xor_sync(kFull, score_a, 1);
  score_a += __shfl_xor_sync(kFull, score_a, 2);
  score_b += __shfl_xor_sync(kFull, score_b, 1);
  score_b += __shfl_xor_sync(kFull, score_b, 2);
  if constexpr (kB3) score_a += b3, score_b += b3;
  if (t == 0) S[pa] = score_a, S[pb] = score_b;
}

// Row r of the tile by one warp: the softmax of its L scores (lane l holds
// positions l and l + 32), the weights written over the scores in S.
__device__ __forceinline__ void softmax_row(int r, const PoolLayout& s, float* S) {
  const int lane = threadIdx.x & 31;
  float w[2];
  float mx = -3.402823466e38f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int l = lane + 32 * j;
    w[j] = l < s.L ? S[r * s.L + l] : -3.402823466e38f;
    mx = fmaxf(mx, w[j]);
  }
  mx = din::warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    w[j] = lane + 32 * j < s.L ? expf(w[j] - mx) : 0.f;
    sum += w[j];
  }
  sum = din::warp_sum(sum);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (lane + 32 * j < s.L) S[r * s.L + lane + 32 * j] = w[j] / sum;
  }
}

// pooled [r][d] = sum_l w_l h_l[d] for the tile's rows below B, one thread an
// output, in l order, into out (the tile's first row).
__device__ __forceinline__ void pool_rows(const float* H, const float* W, const PoolLayout& s,
                                          int rows, float* __restrict__ out, int tid) {
  for (int e = tid; e < rows * s.D; e += kGroupThreads) {
    const int r = e / s.D, d = e - r * s.D;
    const float* h = H + r * s.L * s.ldh + d;
    const float* w = W + r * s.L;
    float acc = 0.f;
#pragma unroll 4
    for (int l = 0; l < s.L; ++l) acc = fmaf(w[l], h[l * s.ldh], acc);
    out[e] = acc;
  }
}

// The threads of group grp of the block meet (named barrier 1 + grp).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(kGroupThreads) : "memory");
}

// pooled [B][D] into out; the scores take b3 [1] with kB3 (b3 unread without).
template <bool kOnChip, bool kB3>
__global__ void __launch_bounds__(kThreads, 1)
din_pool_kernel(const float* __restrict__ hist, const float* __restrict__ tgt, PoolWeights a,
                float* __restrict__ out, long long B, PoolLayout s, const float* __restrict__ b3) {
  extern __shared__ __align__(16) float sm[];
  const int grp = threadIdx.x / kGroupThreads, tid = threadIdx.x - grp * kGroupThreads;
  const int warp = tid >> 5;
  float* H = sm + s.oH + grp * s.Mp * s.ldh;
  float* X = sm + s.oX + grp * s.Rp * s.ldh;
  float* T = sm + s.oT + grp * s.R * s.ldt;
  float* S = sm + s.oS + grp * s.Mp;
  const long long tiles = (B + s.R - 1) / s.R, stride = static_cast<long long>(gridDim.x) * kGroups;
  long long tile = static_cast<long long>(blockIdx.x) * kGroups + grp;
  if (tile < tiles) stage_tile(hist, tgt, tile * s.R, B, s, H, X, tid);  // in flight during the set-up

  // zeros where the copies never write: columns D .. ldh of staged rows, and
  // the padding positions and rows, in both groups' buffers
  for (int e = threadIdx.x; e < kGroups * s.Mp * s.ldh; e += kThreads) {
    const int m = (e / s.ldh) % s.Mp, d = e % s.ldh;
    if (m >= s.M || d >= s.D) sm[s.oH + e] = 0.f;
  }
  for (int e = threadIdx.x; e < kGroups * s.Rp * s.ldh; e += kThreads) {
    const int r = (e / s.ldh) % s.Rp, d = e % s.ldh;
    if (r >= s.R || d >= s.D) sm[s.oX + e] = 0.f;
  }
  const GlobalMat wt{a.wt, s.D, s.A1};  // t wt is a twenty-first of the products: read through L1
  float b3v = 0.f;
  if constexpr (kB3) b3v = __ldg(b3);
  Mat<kOnChip> wh, w2;
  Vec<kOnChip> b1, b2, w3;
  if constexpr (kOnChip) {
    uint4* whS = reinterpret_cast<uint4*>(sm + s.oWh);
    uint4* w2S = reinterpret_cast<uint4*>(sm + s.oW2);
    stage_split(a.wh, s.D, s.A1, s.A1p, s.P1, whS);
    stage_split(a.w2, s.A1, s.A2, s.A2p, s.P2, w2S);
    for (int i = threadIdx.x; i < s.A1p; i += kThreads) sm[s.oB1 + i] = i < s.A1 ? __ldg(a.b1 + i) : 0.f;
    for (int i = threadIdx.x; i < s.A2p; i += kThreads) {
      sm[s.oB2 + i] = i < s.A2 ? __ldg(a.b2 + i) : 0.f;
      sm[s.oW3 + i] = i < s.A2 ? __ldg(a.w3 + i) : 0.f;
    }
    wh = {whS, s.P1}, w2 = {w2S, s.P2};
    b1 = {sm + s.oB1, s.A1}, b2 = {sm + s.oB2, s.A2}, w3 = {sm + s.oW3, s.A2};
  } else {
    wh = {a.wh, s.D, s.A1}, w2 = {a.w2, s.A1, s.A2};
    b1 = {a.b1, s.A1}, b2 = {a.b2, s.A2}, w3 = {a.w3, s.A2};
  }
  __syncthreads();  // weights and zeros in place

  // Each group walks its own tiles with one buffer: while one group waits for
  // its copy or runs its softmax and pool, the other's products keep the
  // tensor cores busy.
  for (; tile < tiles; tile += stride) {
    const long long r0 = tile * s.R;
    cp_async_wait_all();
    group_sync(grp);  // this tile's rows are in
    target_term(X, wt, b1, s, T, warp);
    group_sync(grp);
    for (int m0 = 16 * warp; m0 < s.Mp; m0 += 16 * kWarps) {
      position_scores<kOnChip, kB3>(m0, H, T, wh, w2, b2, w3, b3v, s, S);
    }
    group_sync(grp);
    const int rows = static_cast<int>(B - r0 < s.R ? B - r0 : s.R);
    for (int r = warp; r < rows; r += kWarps) softmax_row(r, s, S);
    group_sync(grp);
    pool_rows(H, S, s, rows, out + static_cast<size_t>(r0) * s.D, tid);
    group_sync(grp);  // H, X and S are free
    if (tile + stride < tiles) stage_tile(hist, tgt, (tile + stride) * s.R, B, s, H, X, tid);
  }
}

template <bool kOnChip, bool kB3 = false>
cudaError_t launch(const float* hist, const float* tgt, const PoolWeights& a, float* out,
                   long long B, const PoolLayout& s, cudaStream_t stream,
                   const float* b3 = nullptr) {
  const size_t smem = smem_bytes(s);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        din_pool_kernel<kOnChip, kB3>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, din_pool_kernel<kOnChip, kB3>, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (B + s.R - 1) / s.R, most = static_cast<long long>(sms) * per_sm;
  const long long wanted = (tiles + kGroups - 1) / kGroups;
  const int blocks = static_cast<int>(wanted < most ? wanted : most);
  din_pool_kernel<kOnChip, kB3><<<blocks, kThreads, smem, stream>>>(hist, tgt, a, out, B, s, b3);
  return cudaGetLastError();
}

}  // namespace dinpool
