// The fused DIN head's building blocks (din_head.cu): the tile layout in shared
// memory, the block-wide products, the forward of the activation unit, softmax
// and pool, and the forward kernel (din_fwd_kernel). din_pool.cuh (the window
// pool, and the float32 head's attention stage) takes only widths_ok,
// kMaxHistory and the warp reductions; its pool kernel is its own.
//
// A block of kThreads threads walks tiles of R rows (R * L history positions).
// A tile's history rows, the activations of its R * L positions and its fc
// activations live in shared memory; the weights are read through the read-only
// data path (L1, then L2: at the DIN preset they are 361 KB, more than a block's
// shared memory). Rows past B are staged as zeros and never read from device
// memory, and their outputs are not written. Every product has a fixed order of
// summation, so a launch repeats bit for bit.
//
// Storage type T: float, or __nv_bfloat16 for the DIN head's bf16 path. History,
// target and weights are read in T and widened to float32 as they are staged or
// loaded; shared memory holds float32 only. Under bf16 the products follow the
// JAX kernel's precision (ops/pallas/din_head.py, _mdot and _cdot): each operand
// of a product is rounded to bf16 as it enters the product (op<T>), never as it
// is stored, because the same values also feed float32 sums that the JAX kernel
// does not round (the biases' gradients, the softmax's backward, the pool).
// Accumulation, z, the relu masks, the softmax and the pooled vector stay
// float32.
//
// The products: for bf16, warp-level mma.sync m16n8k16 on the tensor cores
// with float32 accumulation (block_mm_mma, block_mm_tn_acc_mma), each operand
// rounded to the nearest bf16 as it is packed into its fragment (the rounding
// of op<bf16>), so the operands are those of the CUDA-core path and only the
// order of summation differs; a caller can keep bf16 products on the CUDA
// cores (kTensor false): din_head.cu's backward does, for its recompute of the
// forward. For float, float32 FMA on CUDA cores (block_mm_fma,
// block_mm_tn_acc_fma): the float32 backward's attention unit, and the
// kernels of the float32 head at widths its tensor-core kernels do not take.
// The float32 fc head, forward and backward (din_head.cu's din_head_fc_kernel
// and din_head_bwd_fc_head_kernel), multiplies on the tensor cores in float32
// accuracy (3xTF32 mma.sync m16n8k8: block_mm_tf32, B from Tf32Mat or, for
// A @ W^T, Tf32MatT).
//
// Widths D, A1, A2, F1, F2 must be multiples of 4 (float4 loads, or 8-byte
// quads of bf16), L at most kMaxHistory; the Python launchers check them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tf32_mma.cuh"

namespace din {

constexpr int kThreads = 512;
constexpr int kMaxRows = 16;      // rows of a tile at most
constexpr int kMaxHistory = 64;   // history length L at most
constexpr int kPad = 4;           // floats after each staged row: shifts banks, keeps 16-byte alignment
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use on Hopper
constexpr unsigned kFull = 0xffffffffu;

// The tile layout: widths, rows and the offsets (in floats) of the regions of
// shared memory. Regions: H [M][ldh] history rows; X [R][ldx] = [pooled | t];
// R1 [M][ld1] relu(z1) (the backward turns it into dz1 in place); R2 [M][ld2]
// relu(z2) (backward only; then dz2); T [R][ldt] t @ wt + b1 (backward: then the
// sum of dz1 over the positions); Q: the score partials [M][A2 / 4], later f1
// [R][ldf1] and f2 [R][ldf2]; W [M] softmax weights; S [M] ds; P [R][ldx] =
// [dpooled | dt]; G [R] the logit cotangent.
struct Layout {
  int L, D, A1, A2, F1, F2, R, M;
  int ldh, ldx, ld1, ld2, ldt, ldf1, ldf2;
  int oH, oX, oR1, oR2, oT, oQ, oF2, oW, oS, oP, oG, total;
};

inline int round4(int n) { return (n + 3) & ~3; }

inline Layout make_layout(int L, int D, int A1, int A2, int F1, int F2, int R, bool backward) {
  Layout s;
  s.L = L, s.D = D, s.A1 = A1, s.A2 = A2, s.F1 = F1, s.F2 = F2, s.R = R, s.M = R * L;
  s.ldh = D + kPad, s.ldx = 2 * D + kPad, s.ld1 = A1 + kPad, s.ld2 = A2 + kPad;
  s.ldt = A1 + kPad, s.ldf1 = F1 + kPad, s.ldf2 = F2 + kPad;
  int o = 0;
  auto take = [&o](int n) {
    const int start = o;
    o += round4(n);
    return start;
  };
  s.oH = take(s.M * s.ldh);
  s.oX = take(R * s.ldx);
  s.oR1 = take(s.M * s.ld1);
  s.oR2 = backward ? take(s.M * s.ld2) : -1;
  s.oT = take(R * s.ldt);
  const int partials = s.M * (A2 / 4);
  const int fc_floats = round4(R * s.ldf1) + R * s.ldf2;
  s.oQ = take(partials > fc_floats ? partials : fc_floats);
  s.oF2 = s.oQ + round4(R * s.ldf1);
  s.oW = take(s.M);
  s.oS = backward ? take(s.M) : -1;
  s.oP = backward ? take(R * s.ldx) : -1;
  s.oG = backward ? take(R) : -1;
  s.total = o;
  return s;
}

inline size_t smem_bytes(const Layout& s) { return sizeof(float) * static_cast<size_t>(s.total); }

// The largest tile (at most kMaxRows rows) whose layout fits a block's shared memory.
inline bool fit_layout(int L, int D, int A1, int A2, int F1, int F2, bool backward,
                       Layout* out) {
  for (int R = kMaxRows; R >= 1; --R) {
    const Layout s = make_layout(L, D, A1, A2, F1, F2, R, backward);
    if (smem_bytes(s) <= kSmemLimit) {
      *out = s;
      return true;
    }
  }
  return false;
}

inline bool widths_ok(long long B, int L, int D, int A1, int A2, int F1, int F2) {
  auto ok = [](int n) { return n >= 4 && n % 4 == 0; };
  return B >= 1 && L >= 1 && L <= kMaxHistory && ok(D) && ok(A1) && ok(A2) && ok(F1) && ok(F2);
}

// Component q (a constant after unrolling) of a float4.
__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4& as4(float* p) { return *reinterpret_cast<float4*>(p); }

// Four neighbouring values of device memory as float32, read through the
// read-only path: a float4, or an 8-byte quad of bf16 (a bf16 is the high half
// of the float32 with the same bits).
__device__ __forceinline__ float4 load4(const float* p) { return ldg4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// x as an operand of a product in storage type T: itself for float32, rounded
// to the nearest bf16 for bf16 (the JAX kernel's cast before its dot).
template <class T>
__device__ __forceinline__ float op(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// op<T> of four values; for bf16 rounded two at a time (one packing
// conversion a pair: the same round to nearest even as op<bf16>).
template <class T>
__device__ __forceinline__ float4 op4(float4 v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
    const uint32_t ua = *reinterpret_cast<const uint32_t*>(&a), ub = *reinterpret_cast<const uint32_t*>(&b);
    return make_float4(__uint_as_float(ua << 16), __uint_as_float(ua & 0xffff0000u),
                       __uint_as_float(ub << 16), __uint_as_float(ub & 0xffff0000u));
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// C [M][N] = A [M][K] @ B: A in shared memory (row stride lda), B in device
// memory (type T), [K][N] with row stride ldb, or with kTransB stored transposed,
// [N][K] with row stride ldb (then C = A @ B^T); A's values enter the product as
// op<T>, or as they are with kExactA (values already of type T: op<T> would
// leave them as they are). Each thread computes patches of TM rows
// by 4 columns, summing over k in order, and hands each row of a patch that lies
// below M to epi(row, column, float4). A warp takes 8 row groups by 4 column
// groups: its loads of B touch 64 contiguous bytes and its loads of A 8 rows, so
// B leaves L2 about 8 times less often than with one row group a warp.
template <int TM, bool kTransB, bool kExactA = false, class T, class Epi>
__device__ __forceinline__ void block_mm_fma(const float* A, int lda, const T* __restrict__ B,
                                             int ldb, int M, int K, int N, Epi epi) {
  const int groups = (M + TM - 1) / TM, n4 = N >> 2;
  const int tile_rows = (groups + 7) >> 3;
  const int lanes = tile_rows * ((n4 + 3) >> 2) * 32;
  for (int p = threadIdx.x; p < lanes; p += blockDim.x) {
    const int tile = p >> 5, lane = p & 31;
    const int tc = tile / tile_rows;
    const int rg = (tile - tc * tile_rows) * 8 + (lane & 7), cg = tc * 4 + (lane >> 3);
    if (rg >= groups || cg >= n4) continue;
    const int r0 = rg * TM, c0 = cg * 4;
    const float* arow[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) arow[i] = A + min(r0 + i, M - 1) * lda;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    }
    for (int k = 0; k < K; k += 4) {
      float4 b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        b[u] = kTransB ? load4(B + static_cast<size_t>(c0 + u) * ldb + k)
                       : load4(B + static_cast<size_t>(k + u) * ldb + c0);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 ai = *reinterpret_cast<const float4*>(arow[i] + k);
        const float4 a = kExactA ? ai : op4<T>(ai);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float av = at(a, u);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[i][q] = fmaf(av, kTransB ? at(b[q], u) : at(b[u], q), acc[i][q]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (r0 + i < M) epi(r0 + i, c0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

// G [K][N] (device memory, row stride N) += X [M][K]^T Z [M][N], X and Z in shared
// memory, both entering the product as op<T>; each thread owns 4 x 4 patches of G
// and sums over m in order.
template <class T>
__device__ __forceinline__ void block_mm_tn_acc_fma(const float* X, int ldx, const float* Z,
                                                    int ldz, int M, int K, int N,
                                                    float* __restrict__ G) {
  const int n4 = N >> 2;
  const int patches = (K >> 2) * n4;
  for (int p = threadIdx.x; p < patches; p += blockDim.x) {
    const int kg = p / n4;
    const int k0 = kg * 4, c0 = (p - kg * n4) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    }
    for (int m = 0; m < M; ++m) {
      const float4 x = op4<T>(*reinterpret_cast<const float4*>(X + m * ldx + k0));
      const float4 z = op4<T>(*reinterpret_cast<const float4*>(Z + m * ldz + c0));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(at(x, i), at(z, q), acc[i][q]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4& g = as4(G + static_cast<size_t>(k0 + i) * N + c0);
      float4 v = g;
      v.x += acc[i][0], v.y += acc[i][1], v.z += acc[i][2], v.w += acc[i][3];
      g = v;
    }
  }
}

// ------------------------------------------------------------ tensor cores (bf16)
//
// mma.sync m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"): with
// g = lane / 4 and t = lane % 4, a lane holds A (16 x 16, row-major) as
// {(g, 2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9)}, B (16 x 8,
// by column) as {(2t..2t+1, g), (2t+8..2t+9, g)} and C (16 x 8, float32) as
// (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1); each 32-bit register packs two
// bf16, the lower index in the low half. Fragment elements past M, K or N are
// zeros, and nothing past them is read.

constexpr int kMmaNT = 2;  // n8 tiles a warp takes per task: its A fragment serves both

// acc (16 x 8, float32) += a (16 x 16, bf16) b (16 x 8, bf16). The tensor core
// sums the 16 products from a zero accumulator and acc takes that sum with a
// rounded float32 add: summed inside the mma, acc would be aligned with each
// step's products and truncated, an error that grows with every step.
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  float d[4];
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
  acc[0] += d[0], acc[1] += d[1], acc[2] += d[2], acc[3] += d[3];
}

// x and y rounded to the nearest bf16 (op<bf16>'s rounding), packed with x low.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

constexpr int kMmaSteps = 4;  // k16 steps whose loads a warp issues before their mmas

// block_mm for bf16 B on the tensor cores. The reduction is over all of a k16
// step whatever order its terms take, so a step's slots map to k as suits the
// loads: lane t's slots 2t, 2t + 1, 2t + 8, 2t + 9 take k0 + 4t .. k0 + 4t + 3,
// one float4 of A's row in shared memory and one 8-byte run of B's row when B
// is stored transposed. A warp takes a task of one m16 tile by kMmaNT n8 tiles
// (16 columns, n0 ..); column slot c of n8 tile j is column n0 + 2c + j, so
// without kTransB one 32-bit load gives a lane its column pair (n0 + 2g, + 1)
// for both tiles, and the accumulators hold four neighbouring columns of a row
// for the epilogue. A warp loads kMmaSteps steps before it multiplies them, so
// their loads are in flight together (steps past K are zeros). The tasks go
// round the warps in a fixed order. K and N are multiples of 4, so a lane's
// quad of k and of columns lies all inside or all outside them; zeros outside,
// and nothing there is read.
template <bool kTransB, class Epi>
__device__ __forceinline__ void block_mm_mma(const float* A, int lda,
                                             const __nv_bfloat16* __restrict__ B, int ldb, int M,
                                             int K, int N, Epi epi) {
  static_assert(kMmaNT == 2, "a lane's 32-bit column pair feeds two n8 tiles");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int groups = (N + 15) >> 4;
  const int tasks = ((M + 15) >> 4) * groups;
  const unsigned* B32 = reinterpret_cast<const unsigned*>(B);
  for (int task = threadIdx.x >> 5; task < tasks; task += blockDim.x >> 5) {
    const int m0 = (task / groups) * 16, n0 = (task % groups) * 16;
    const int ra = m0 + g, rb = ra + 8, nb = n0 + 2 * g;  // nb: this lane's B columns
    const bool ina = ra < M, inb = rb < M;
    const float* pa = A + (ina ? ra : 0) * lda + 4 * t;
    const float* pb = A + (inb ? rb : 0) * lda + 4 * t;
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16 * kMmaSteps) {
      uint32_t a[kMmaSteps][4], b[kMmaSteps][2][2];
#pragma unroll
      for (int st = 0; st < kMmaSteps; ++st) {
        const int k = k0 + 16 * st + 4 * t;
        a[st][0] = a[st][1] = a[st][2] = a[st][3] = 0u;
        b[st][0][0] = b[st][0][1] = b[st][1][0] = b[st][1][1] = 0u;
        if (k >= K) continue;
        if (ina) {
          const float4 v = *reinterpret_cast<const float4*>(pa + k0 + 16 * st);
          a[st][0] = pack_bf16(v.x, v.y), a[st][2] = pack_bf16(v.z, v.w);
        }
        if (inb) {
          const float4 v = *reinterpret_cast<const float4*>(pb + k0 + 16 * st);
          a[st][1] = pack_bf16(v.x, v.y), a[st][3] = pack_bf16(v.z, v.w);
        }
        if constexpr (kTransB) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (nb + j < N) {
              const uint2 q =
                  __ldg(reinterpret_cast<const uint2*>(B + static_cast<size_t>(nb + j) * ldb + k));
              b[st][j][0] = q.x, b[st][j][1] = q.y;
            }
          }
        } else if (nb < N) {
          const unsigned* q = B32 + (static_cast<size_t>(k) * ldb + nb) / 2;
          const unsigned w0 = __ldg(q), w1 = __ldg(q + ldb / 2), w2 = __ldg(q + ldb),
                         w3 = __ldg(q + ldb / 2 * 3);
          b[st][0][0] = __byte_perm(w0, w1, 0x5410), b[st][0][1] = __byte_perm(w2, w3, 0x5410);
          b[st][1][0] = __byte_perm(w0, w1, 0x7632), b[st][1][1] = __byte_perm(w2, w3, 0x7632);
        }
      }
#pragma unroll
      for (int st = 0; st < kMmaSteps; ++st) {
        mma_bf16(acc[0], a[st], b[st][0]);
        mma_bf16(acc[1], a[st], b[st][1]);
      }
    }
    const int col = n0 + 4 * t;
    if (col < N) {
      if (ina) epi(ra, col, make_float4(acc[0][0], acc[1][0], acc[0][1], acc[1][1]));
      if (inb) epi(rb, col, make_float4(acc[0][2], acc[1][2], acc[0][3], acc[1][3]));
    }
  }
}

// block_mm_tn_acc for bf16 on the tensor cores: G's rows (k) are the mma's M and
// the tile's rows m its reduction. A warp takes a task of one m16 tile of G's
// rows by kMmaNT n8 tiles, walks m in steps of 16 and adds its accumulator
// fragments into G; the tasks go round the warps in a fixed order, so the same
// lane owns the same elements of G on every tile (no atomics, runs repeat bit for
// bit). X and Z are read as scalars: (m, k) and (m + 1, k) make a register.
__device__ __forceinline__ void block_mm_tn_acc_mma(const float* X, int ldx, const float* Z,
                                                    int ldz, int M, int K, int N,
                                                    float* __restrict__ G) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int groups = (N + 8 * kMmaNT - 1) / (8 * kMmaNT);
  const int tasks = ((K + 15) >> 4) * groups;
  auto x = [&](int m, int k) { return m < M && k < K ? X[m * ldx + k] : 0.f; };
  auto z = [&](int m, int n) { return m < M && n < N ? Z[m * ldz + n] : 0.f; };
  for (int task = threadIdx.x >> 5; task < tasks; task += blockDim.x >> 5) {
    const int ka = (task / groups) * 16 + g, kb = ka + 8, n0 = (task % groups) * 8 * kMmaNT;
    float acc[kMmaNT][4];
#pragma unroll
    for (int j = 0; j < kMmaNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int m0 = 0; m0 < M; m0 += 16) {
      const int m = m0 + 2 * t;
      const uint32_t a[4] = {pack_bf16(x(m, ka), x(m + 1, ka)), pack_bf16(x(m, kb), x(m + 1, kb)),
                             pack_bf16(x(m + 8, ka), x(m + 9, ka)),
                             pack_bf16(x(m + 8, kb), x(m + 9, kb))};
#pragma unroll
      for (int j = 0; j < kMmaNT; ++j) {
        const int n = n0 + 8 * j + g;
        const uint32_t b[2] = {pack_bf16(z(m, n), z(m + 1, n)), pack_bf16(z(m + 8, n), z(m + 9, n))};
        mma_bf16(acc[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < kMmaNT; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      if (c >= N) continue;
      if (ka < K) {
        float2& o = *reinterpret_cast<float2*>(G + static_cast<size_t>(ka) * N + c);
        o = make_float2(o.x + acc[j][0], o.y + acc[j][1]);
      }
      if (kb < K) {
        float2& o = *reinterpret_cast<float2*>(G + static_cast<size_t>(kb) * N + c);
        o = make_float2(o.x + acc[j][2], o.y + acc[j][3]);
      }
    }
  }
}

// C [M][N] = A [M][K] @ B (or A @ B^T with kTransB), as block_mm_fma describes:
// on CUDA cores for float B, on the tensor cores for bf16 B unless kTensor is
// false.
template <int TM, bool kTransB, bool kTensor = true, bool kExactA = false, class T, class Epi>
__device__ __forceinline__ void block_mm(const float* A, int lda, const T* __restrict__ B,
                                         int ldb, int M, int K, int N, Epi epi) {
  if constexpr (kTensor && std::is_same_v<T, __nv_bfloat16>) {
    block_mm_mma<kTransB>(A, lda, B, ldb, M, K, N, epi);
  } else {
    block_mm_fma<TM, kTransB, kExactA>(A, lda, B, ldb, M, K, N, epi);
  }
}

// G [K][N] += X [M][K]^T Z [M][N], as block_mm_tn_acc_fma describes: on CUDA
// cores for float, on the tensor cores for bf16.
template <class T>
__device__ __forceinline__ void block_mm_tn_acc(const float* X, int ldx, const float* Z, int ldz,
                                                int M, int K, int N, float* __restrict__ G) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    block_mm_tn_acc_mma(X, ldx, Z, ldz, M, K, N, G);
  } else {
    block_mm_tn_acc_fma<T>(X, ldx, Z, ldz, M, K, N, G);
  }
}

// ------------------------------------------------------- tensor cores (float32)
//
// The float32 fc head's products (din_head.cu's din_head_fc_kernel and
// din_head_bwd_fc_head_kernel) in float32 accuracy on the tensor cores: 3xTF32
// mma.sync m16n8k8 (tf32_mma.cuh), B the float32 weight in device memory, read
// through L1 and L2 and split into TF32 hi and lo parts as each fragment is
// loaded.

// W [K][N] (row-major; rows Ktop .. K - 1 from bottom when it is given: u1 is
// u1p over u1t) as the B operand: frag(n, k) gives the hi and lo parts of
// W[k][n] and W[k + 1][n] (k even; K a multiple of 4, so k and k + 1 lie on one
// side of Ktop and of K), zeros past K and N.
struct Tf32Mat {
  const float* __restrict__ top;
  const float* __restrict__ bottom;
  int Ktop, K, N;
  __device__ __forceinline__ void frag(int n, int k, uint32_t (&bh)[2], uint32_t (&bl)[2]) const {
    const bool in = n < N && k < K;
    const float* w = k < Ktop ? top + static_cast<size_t>(k) * N : bottom + static_cast<size_t>(k - Ktop) * N;
    const float x0 = in ? __ldg(w + n) : 0.f, x1 = in ? __ldg(w + N + n) : 0.f;
    tf32mma::split_tf32_bits(x0, bh[0], bl[0]);
    tf32mma::split_tf32_bits(x1, bh[1], bl[1]);
  }
};

// W [N][K] (row-major; rows Ntop .. N - 1 from bottom when it is given: u1 is
// u1p over u1t) as the B operand of A @ W^T: frag(n, k) gives the hi and lo
// parts of W[n][k] and W[n][k + 1], one 8-byte load (k even; K a multiple of
// 4, so k < K means k + 1 < K), zeros past K and N.
struct Tf32MatT {
  const float* __restrict__ top;
  const float* __restrict__ bottom;
  int Ntop, N, K;
  __device__ __forceinline__ void frag(int n, int k, uint32_t (&bh)[2], uint32_t (&bl)[2]) const {
    float2 x = make_float2(0.f, 0.f);
    if (n < N && k < K) {
      const float* w = n < Ntop ? top + static_cast<size_t>(n) * K : bottom + static_cast<size_t>(n - Ntop) * K;
      x = __ldg(reinterpret_cast<const float2*>(w + k));
    }
    tf32mma::split_tf32_bits(x.x, bh[0], bl[0]);
    tf32mma::split_tf32_bits(x.y, bh[1], bl[1]);
  }
};

constexpr int kTf32Cols = 16;  // columns of a warp's task: two n8 tiles
constexpr int kTf32Chunk = 8;  // k8 steps summed from zero in the accumulators, then added in float32

// acc[i] = A [M][K] @ W for the m16 tile m0 + 16 i (i < kMT) and the kTf32Cols
// columns n0 .. n0 + 15, in 3xTF32 on the tensor cores (W a Tf32Mat); A in
// shared memory (row stride lda, a multiple of 2). A's k slots are the DIN
// pool's: slot t takes k0 + 2t and slot t + 4 k0 + 2t + 1, so an A fragment is
// one 8-byte load of a row and B's fragment W's rows k0 + 2t, + 1. Column slot c of
// n8 tile j is column n0 + 2c + j, so a lane's C fragment holds the four
// neighbouring columns n0 + 4t .. n0 + 4t + 3 of rows g and g + 8:
// row4(acc[i], 0) and row4(acc[i], 1). A's rows past M and columns past K (a
// multiple of 4) enter as zeros; tiles wholly past M are skipped (a branch of
// the whole warp). Each kTf32Chunk k-steps sum from zero in the mma.sync
// accumulators and are then added into acc in float32, so the accumulators'
// error does not grow with K.
template <int kMT, class Mat>
__device__ __forceinline__ void warp_mm_tf32(const float* A, int lda, int M, int K, const Mat& W,
                                             int m0, int n0, float (&acc)[kMT][2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  const int Kp = (K + 7) & ~7;
  for (int kc = 0; kc < Kp; kc += 8 * kTf32Chunk) {
    float part[kMT][2][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
    }
    const int kend = min(Kp, kc + 8 * kTf32Chunk);
#pragma unroll 2
    for (int k0 = kc; k0 < kend; k0 += 8) {
      const int k = k0 + 2 * t;
      uint32_t bh[2][2], bl[2][2];
      W.frag(n0 + 2 * g, k, bh[0], bl[0]);
      W.frag(n0 + 2 * g + 1, k, bh[1], bl[1]);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (m0 + 16 * i >= M) break;  // the whole warp
        const int ra = m0 + 16 * i + g, rb = ra + 8;
        const float2 u = ra < M && k < K ? *reinterpret_cast<const float2*>(A + ra * lda + k)
                                         : make_float2(0.f, 0.f);
        const float2 v = rb < M && k < K ? *reinterpret_cast<const float2*>(A + rb * lda + k)
                                         : make_float2(0.f, 0.f);
        uint32_t ah[4], al[4];
        tf32mma::split_tf32_bits(u.x, ah[0], al[0]);
        tf32mma::split_tf32_bits(v.x, ah[1], al[1]);
        tf32mma::split_tf32_bits(u.y, ah[2], al[2]);
        tf32mma::split_tf32_bits(v.y, ah[3], al[3]);
        tf32mma::mma_3xtf32(part[i], ah, al, bh, bl);
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

// Row h (0: g, 1: g + 8) of a warp_mm_tf32 tile's C fragments: columns
// n0 + 4t .. n0 + 4t + 3.
__device__ __forceinline__ float4 row4(const float (&c)[2][4], int h) {
  return make_float4(c[0][2 * h], c[1][2 * h], c[0][2 * h + 1], c[1][2 * h + 1]);
}

// C = A [M][K] @ W on the tensor cores (3xTF32), as warp_mm_tf32 computes it:
// the warps take tasks of kMT m16 tiles by kTf32Cols columns in a fixed order
// and hand each row below M of each task to epi(row, column, float4 of four
// columns) for the columns below N (N a multiple of 4).
template <int kMT, class Mat, class Epi>
__device__ __forceinline__ void block_mm_tf32(const float* A, int lda, const Mat& W, int M, int K,
                                              int N, Epi epi) {
  const int t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const int groups = (N + kTf32Cols - 1) / kTf32Cols;
  const int tasks = ((M + 16 * kMT - 1) / (16 * kMT)) * groups;
  for (int task = threadIdx.x >> 5; task < tasks; task += blockDim.x >> 5) {
    const int m0 = (task / groups) * 16 * kMT, n0 = (task % groups) * kTf32Cols;
    float acc[kMT][2][4];
    warp_mm_tf32<kMT>(A, lda, M, K, W, m0, n0, acc);
    const int col = n0 + 4 * t;
    if (col >= N) continue;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * i + g + 8 * h;
        if (row < M) epi(row, col, row4(acc[i], h));
      }
    }
  }
}

// G [c] (device memory) += sum over m of Z [m][c], for c < N; Z in shared
// memory. Given w, the sum is of the products op<T>(Z [m][c]) op<T>(w [m]) (a
// weight gradient); without, of Z itself in float32 (a bias gradient).
template <class T>
__device__ __forceinline__ void block_colsum_acc(const float* Z, int ldz, const float* w, int M,
                                                 int N, float* __restrict__ G) {
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float acc = 0.f;
    for (int m = 0; m < M; ++m) {
      acc = w ? fmaf(op<T>(Z[m * ldz + c]), op<T>(w[m]), acc) : acc + Z[m * ldz + c];
    }
    G[c] += acc;
  }
}

// Butterfly sum and max over a warp: every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// The tile of rows r0 .. r0 + R - 1 into shared memory, widened to float32:
// history rows into H, targets into the right half of X, and (given g) the logit
// cotangent into G. Rows past B are zeros.
template <class T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ hist,
                                           const T* __restrict__ tgt,
                                           const float* __restrict__ g, long long r0,
                                           long long B, const Layout& s, float* sm) {
  const int d4 = s.D >> 2;
  for (int t = threadIdx.x; t < s.M * d4; t += blockDim.x) {
    const int m = t / d4, d = (t - m * d4) * 4;
    const bool in = r0 + m / s.L < B;
    as4(sm + s.oH + m * s.ldh + d) =
        in ? load4(hist + (static_cast<size_t>(r0) * s.L + m) * s.D + d) : make_float4(0, 0, 0, 0);
  }
  for (int t = threadIdx.x; t < s.R * d4; t += blockDim.x) {
    const int r = t / d4, d = (t - r * d4) * 4;
    const bool in = r0 + r < B;
    as4(sm + s.oX + r * s.ldx + s.D + d) =
        in ? load4(tgt + static_cast<size_t>(r0 + r) * s.D + d) : make_float4(0, 0, 0, 0);
  }
  if (g != nullptr) {
    for (int r = threadIdx.x; r < s.R; r += blockDim.x) sm[s.oG + r] = r0 + r < B ? g[r0 + r] : 0.f;
  }
}

template <class T>
struct AttentionWeights {
  const T *wh, *wt, *b1, *w2, *b2, *w3, *b3;  // b3 may be null (dropped)
};

template <class T>
struct FcWeights {
  const T *u1p, *u1t, *c1, *u2, *c2, *u3, *c3;
};

// The activation unit, softmax and pool of the staged tile: T = t @ wt + b1,
// R1 = relu(h @ wh + T), relu(R1 @ w2 + b2) (kept in R2 when the layout has it),
// scores = that @ w3 (+ b3), W = softmax over the L positions, and the pooled rows
// into the left half of X. Ends synchronised. kTensor: block_mm's choice of
// cores for bf16 weights (false: the CUDA-core path, whatever T).
template <class T, bool kTensor = true>
__device__ __forceinline__ void attention_forward(const AttentionWeights<T>& a, const Layout& s,
                                                  float* sm) {
  float* H = sm + s.oH;
  float* X = sm + s.oX;
  float* R1 = sm + s.oR1;
  float* Tt = sm + s.oT;
  float* Q = sm + s.oQ;
  float* W = sm + s.oW;
  const int n4 = s.A2 >> 2;
  // the history and target rows were staged from type T: exact operands
  block_mm<1, false, kTensor, true>(X + s.D, s.ldx, a.wt, s.A1, s.R, s.D, s.A1, [&](int r, int c, float4 v) {
    const float4 b = load4(a.b1 + c);
    as4(Tt + r * s.ldt + c) = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
  });
  __syncthreads();
  block_mm<10, false, kTensor, true>(H, s.ldh, a.wh, s.A1, s.M, s.D, s.A1, [&](int m, int c, float4 v) {
    const float4 t = as4(Tt + (m / s.L) * s.ldt + c);
    as4(R1 + m * s.ld1 + c) =
        make_float4(relu(v.x + t.x), relu(v.y + t.y), relu(v.z + t.z), relu(v.w + t.w));
  });
  __syncthreads();
  float* R2 = s.oR2 >= 0 ? sm + s.oR2 : nullptr;
  block_mm<5, false, kTensor>(R1, s.ld1, a.w2, s.A2, s.M, s.A1, s.A2, [&](int m, int c, float4 v) {
    const float4 b = load4(a.b2 + c);
    const float4 z = make_float4(relu(v.x + b.x), relu(v.y + b.y), relu(v.z + b.z), relu(v.w + b.w));
    if (R2 != nullptr) as4(R2 + m * s.ld2 + c) = z;
    const float4 w3 = load4(a.w3 + c), zo = op4<T>(z);
    Q[m * n4 + (c >> 2)] = fmaf(zo.w, w3.w, fmaf(zo.z, w3.z, fmaf(zo.y, w3.y, zo.x * w3.x)));
  });
  __syncthreads();
  // the softmax of each row by one warp, lane l holding positions l and l + 32
  const float b3 = a.b3 != nullptr ? load1(a.b3) : 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < s.R; r += blockDim.x >> 5) {
    float sc[kMaxHistory / 32];
    float mx = -3.402823466e38f;
#pragma unroll
    for (int j = 0; j < kMaxHistory / 32; ++j) {
      const int l = lane + 32 * j;
      sc[j] = -3.402823466e38f;
      if (l < s.L) {
        const float* q = Q + (r * s.L + l) * n4;
        float acc = 0.f;
        for (int c = 0; c < n4; ++c) acc += q[c];
        sc[j] = acc + b3;
      }
      mx = fmaxf(mx, sc[j]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxHistory / 32; ++j) {
      sc[j] = lane + 32 * j < s.L ? expf(sc[j] - mx) : 0.f;
      sum += sc[j];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int j = 0; j < kMaxHistory / 32; ++j) {
      if (lane + 32 * j < s.L) W[r * s.L + lane + 32 * j] = sc[j] / sum;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < s.R * s.D; t += blockDim.x) {
    const int r = t / s.D, d = t - r * s.D;
    float acc = 0.f;
    for (int l = 0; l < s.L; ++l) acc = fmaf(W[r * s.L + l], H[(r * s.L + l) * s.ldh + d], acc);
    X[r * s.ldx + d] = acc;
  }
  __syncthreads();
}

// The fc head's hidden layers of the tile: F1 = relu(pooled @ u1p + t @ u1t + c1),
// F2 = relu(F1 @ u2 + c2), into Q's f1 and f2 regions. Ends synchronised.
template <class T, bool kTensor = true>
__device__ __forceinline__ void fc_forward(const FcWeights<T>& f, const Layout& s, float* sm) {
  float* X = sm + s.oX;
  float* F1 = sm + s.oQ;
  float* F2 = sm + s.oF2;
  block_mm<2, false, kTensor>(X, s.ldx, f.u1p, s.F1, s.R, s.D, s.F1,
                     [&](int r, int c, float4 v) { as4(F1 + r * s.ldf1 + c) = v; });
  __syncthreads();
  block_mm<2, false, kTensor>(X + s.D, s.ldx, f.u1t, s.F1, s.R, s.D, s.F1, [&](int r, int c, float4 v) {
    float4& o = as4(F1 + r * s.ldf1 + c);
    const float4 p = o, b = load4(f.c1 + c);
    o = make_float4(relu(p.x + v.x + b.x), relu(p.y + v.y + b.y), relu(p.z + v.z + b.z),
                    relu(p.w + v.w + b.w));
  });
  __syncthreads();
  block_mm<1, false, kTensor>(F1, s.ldf1, f.u2, s.F2, s.R, s.F1, s.F2, [&](int r, int c, float4 v) {
    const float4 b = load4(f.c2 + c);
    as4(F2 + r * s.ldf2 + c) =
        make_float4(relu(v.x + b.x), relu(v.y + b.y), relu(v.z + b.z), relu(v.w + b.w));
  });
  __syncthreads();
}

// The whole DIN head's forward over B rows: logits [B] (type T) into out, and,
// given pooled, the pooled rows [B, D] (float32) for the backward's fc head.
// kKOrder: the attention unit on CUDA cores (each sum in k order, as the bf16
// backward recomputes it) rather than on the tensor cores.
template <class T, bool kKOrder = false>
__global__ void __launch_bounds__(kThreads, 1)
din_fwd_kernel(const T* __restrict__ hist, const T* __restrict__ tgt, AttentionWeights<T> a,
               FcWeights<T> f, T* __restrict__ out, float* __restrict__ pooled, long long B,
               Layout s) {
  extern __shared__ __align__(16) float sm[];
  const long long tiles = (B + s.R - 1) / s.R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * s.R;
    __syncthreads();  // the previous tile's readers are done
    stage_tile(hist, tgt, nullptr, r0, B, s, sm);
    __syncthreads();
    attention_forward<T, !kKOrder>(a, s, sm);
    if (pooled != nullptr) {
      const int d4 = s.D >> 2;
      for (int e = threadIdx.x; e < s.R * d4; e += blockDim.x) {
        const int r = e / d4, c = (e - r * d4) * 4;
        if (r0 + r < B) as4(pooled + (r0 + r) * s.D + c) = as4(sm + s.oX + r * s.ldx + c);
      }
    }
    fc_forward(f, s, sm);
    const float* F2 = sm + s.oF2;
    for (int r = warp; r < s.R; r += kThreads / 32) {
      float acc = 0.f;
      for (int c = lane; c < s.F2; c += 32) acc = fmaf(op<T>(F2[r * s.ldf2 + c]), load1(f.u3 + c), acc);
      acc = warp_sum(acc);
      if (lane == 0 && r0 + r < B) store1(out + r0 + r, acc + load1(f.c3));
    }
  }
}

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
  const long long most = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<int>(tiles < most ? tiles : most);
  return cudaSuccess;
}

}  // namespace din
