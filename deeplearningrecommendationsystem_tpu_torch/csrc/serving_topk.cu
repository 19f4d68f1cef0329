// Serving top-k kernels for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replace the Pallas TPU kernels of
//   deeplearningrecommendationsystem_tpu/ops/pallas/serving_topk.py:
//   * topk_serve_matmul  (_matmul_topk_kernel + _merge_topk)  -> matmul_topk_kernel
//   * topk_scores_pallas (_scores_topk_kernel + _merge_topk)  -> scores_topk_kernel
// Their plain PyTorch versions are topk_serve_matmul_plain / topk_scores_plain in
// deeplearningrecommendationsystem_tpu_torch/ops/serving_topk.py.
//
// What both compute: for each user u, over the items i of the catalog,
//   s[u, i] = P[u] . Q[i]      (matmul_topk_kernel, float32 FMA, no TF32)
//   s[u, i] = S[u, i]          (scores_topk_kernel)
//   s[u, i] = -1e30 where seen[u, i] != 0
// and the top k (k <= 128) by (value descending, item index ascending): the first
// k of a stable descending sort. Inputs are assumed finite.
//
// Design. One warp owns one user's running top-k: a sorted buffer of 128 slots
// kept in registers, 4 per lane (slot j = lane * 4 + s). Items arrive in chunks
// of 128, in index order. A lane tests its item against the buffer's k-th entry
// (one compare); the warp inserts the few that pass, in index order, each with
// one warp reduction (its position) and one register shift. Because items come
// in index order, an item equal in value to a kept one never displaces it, which
// gives the lowest-index-wins order with no extra work. The Pallas kernel ran k
// rounds of knock-out over 128 + chunk lanes per chunk (4 k U (I + 128) ops,
// more than the matmul); here the merge costs about one compare per item plus
// k log(I / k) insertions per user on random scores.
//
// matmul_topk_kernel: a block of 8 warps takes a tile of 8 users. For each item
// chunk it stages Q[chunk] in shared memory (row stride D + 1, so lanes reading
// different rows hit different banks), each thread computes 4 users x 1 item with
// the P tile read as float4 broadcasts, the masked scores go to shared memory,
// and each warp merges its user's row. The [U, I] scores never reach device
// memory. P, Q and seen are not padded in memory: the kernel masks the ragged
// user and item edges itself.
//   Bound at the MF serving shape (U=943, I=1682, D=64): the float32 FMA work,
//   2 U I D = 203 MFLOP, over 67 TFLOP/s = 3.0 us; the bytes (P, Q, the U I
//   bytes of seen, the [U, k] outputs) take less. Later work: tensor cores
//   (3xTF32 or bf16x3 to keep float32 accuracy) and TMA staging of Q.
//
// scores_topk_kernel: one warp per user streams its score and seen rows through
// the same merge. Bound: the bytes, U I (4 + 1) read once, plus the outputs.
//
// Each entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when that is not 0.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxK = 128;              // top-k buffer slots (k <= kMaxK)
constexpr int kSlots = kMaxK / 32;      // buffer slots per lane
constexpr int kChunk = 128;             // items per merge chunk
constexpr int kGroups = kChunk / 32;    // items per lane per chunk
constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileU = kWarps;          // users per block in the matmul kernel
constexpr int kUserGroups = kThreads / kChunk;        // 2
constexpr int kUsersPerThread = kTileU / kUserGroups;  // 4
constexpr float kNegInf = -1e30f;       // the mask value of the JAX package
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTileU == kUserGroups * kUsersPerThread, "matmul tiling");

__device__ __forceinline__ float neg_infinity() { return __int_as_float(static_cast<int>(0xff800000u)); }

// (v1, i1) ranks before (v2, i2): higher value, then lower index.
__device__ __forceinline__ bool beats(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// One user's running top-k, held by a warp: slot j = lane * kSlots + s, sorted by
// `beats`. Empty slots hold (-inf, INT_MAX), which every item beats.
struct TopK {
  float v[kSlots];
  int i[kSlots];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      v[s] = neg_infinity();
      i[s] = INT_MAX;
    }
  }

  // The entry at slot k - 1 (the weakest one kept), broadcast to every lane.
  __device__ __forceinline__ void kth(int k, float& tv, int& ti) const {
    const int s_own = (k - 1) % kSlots;
    float pv = v[0];
    int pi = i[0];
#pragma unroll
    for (int s = 1; s < kSlots; ++s) {
      if (s == s_own) {
        pv = v[s];
        pi = i[s];
      }
    }
    tv = __shfl_sync(kFull, pv, (k - 1) / kSlots);
    ti = __shfl_sync(kFull, pi, (k - 1) / kSlots);
  }

  // Insert (cv, ci), the same on every lane, at its sorted position; the last slot drops.
  __device__ __forceinline__ void insert(float cv, int ci) {
    const int lane = threadIdx.x & 31;
    unsigned ahead = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) ahead += beats(v[s], i[s], cv, ci);
    const int pos = static_cast<int>(__reduce_add_sync(kFull, ahead));
    const float up_v = __shfl_up_sync(kFull, v[kSlots - 1], 1);
    const int up_i = __shfl_up_sync(kFull, i[kSlots - 1], 1);
#pragma unroll
    for (int s = kSlots - 1; s >= 0; --s) {
      const int j = lane * kSlots + s;
      const float prev_v = s > 0 ? v[s > 0 ? s - 1 : 0] : up_v;
      const int prev_i = s > 0 ? i[s > 0 ? s - 1 : 0] : up_i;
      if (j > pos) {
        v[s] = prev_v;
        i[s] = prev_i;
      } else if (j == pos) {
        v[s] = cv;
        i[s] = ci;
      }
    }
  }

  __device__ __forceinline__ void store(float* out_v, int* out_i, int k) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = lane * kSlots + s;
      if (j < k) {
        out_v[j] = v[s];
        out_i[j] = i[s];
      }
    }
  }
};

// Merge the n <= kChunk items base .. base + n - 1 into `top`; load(c) gives the
// masked score of item base + c. Called by a whole warp; n and k are warp-uniform.
// Shared by both kernels.
template <class Load>
__device__ __forceinline__ void merge_chunk(TopK& top, Load load, int base, int n, int k) {
  const int lane = threadIdx.x & 31;
  float vals[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int c = g * 32 + lane;
    vals[g] = c < n ? load(c) : 0.f;
  }
  float tv;
  int ti;
  top.kth(k, tv, ti);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int c = g * 32 + lane;
    const int id = base + c;
    unsigned pending = __ballot_sync(kFull, c < n && beats(vals[g], id, tv, ti));
    while (pending) {  // warp-uniform: every lane holds the same mask
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const float cv = __shfl_sync(kFull, vals[g], src);
      const int ci = __shfl_sync(kFull, id, src);
      if (!beats(cv, ci, tv, ti)) continue;  // the k-th entry rose since the ballot
      top.insert(cv, ci);
      top.kth(k, tv, ti);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
matmul_topk_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                   const uint8_t* __restrict__ seen, float* __restrict__ out_v,
                   int* __restrict__ out_i, int U, int I, int D, int k) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = (D + 3) & ~3;            // P rows padded to whole float4s
  float* qs = smem;                       // [kChunk][Dp + 1]
  float* ps = qs + kChunk * (Dp + 1);     // [kTileU][Dp]  (16-byte aligned: kChunk * 4 | 16)
  float* ss = ps + kTileU * Dp;           // [kTileU][kChunk] masked scores of the chunk

  const int u0 = blockIdx.x * kTileU;
  const int warp = threadIdx.x >> 5;
  const int c = threadIdx.x % kChunk;     // item of the chunk this thread scores
  const int ug = threadIdx.x / kChunk;    // its users: ug * kUsersPerThread + j

  for (int t = threadIdx.x; t < kTileU * Dp; t += kThreads) {
    const int r = t / Dp, d = t - r * Dp;
    ps[t] = (u0 + r < U && d < D) ? P[static_cast<size_t>(u0 + r) * D + d] : 0.f;
  }
  TopK top;
  top.init();

  for (int i0 = 0; i0 < I; i0 += kChunk) {
    const int n = min(kChunk, I - i0);
    __syncthreads();  // the previous chunk's merge is done with qs and ss
    for (int t = threadIdx.x; t < kChunk * Dp; t += kThreads) {
      const int r = t / Dp, d = t - r * Dp;
      qs[r * (Dp + 1) + d] = (r < n && d < D) ? Q[static_cast<size_t>(i0 + r) * D + d] : 0.f;
    }
    __syncthreads();

    float acc[kUsersPerThread];
#pragma unroll
    for (int j = 0; j < kUsersPerThread; ++j) acc[j] = 0.f;
    const float* qrow = qs + c * (Dp + 1);
    const float* prow = ps + ug * kUsersPerThread * Dp;
    for (int d = 0; d < Dp; d += 4) {
      const float q0 = qrow[d], q1 = qrow[d + 1], q2 = qrow[d + 2], q3 = qrow[d + 3];
#pragma unroll
      for (int j = 0; j < kUsersPerThread; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(prow + j * Dp + d);
        acc[j] = fmaf(p.x, q0, acc[j]);
        acc[j] = fmaf(p.y, q1, acc[j]);
        acc[j] = fmaf(p.z, q2, acc[j]);
        acc[j] = fmaf(p.w, q3, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kUsersPerThread; ++j) {
      const int r = ug * kUsersPerThread + j;
      const int u = u0 + r;
      float s = acc[j];
      if (c < n && u < U && seen[static_cast<size_t>(u) * I + i0 + c]) s = kNegInf;
      ss[r * kChunk + c] = s;
    }
    __syncthreads();

    if (u0 + warp < U) {
      const float* row = ss + warp * kChunk;
      merge_chunk(top, [row](int cc) { return row[cc]; }, i0, n, k);
    }
  }
  if (u0 + warp < U) {
    const size_t u = static_cast<size_t>(u0 + warp);
    top.store(out_v + u * k, out_i + u * k, k);
  }
}

__global__ void __launch_bounds__(kThreads)
scores_topk_kernel(const float* __restrict__ S, const uint8_t* __restrict__ seen,
                   float* __restrict__ out_v, int* __restrict__ out_i, int U, int I, int k) {
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= U) return;  // the whole warp leaves; this kernel has no block barrier
  const float* srow = S + static_cast<size_t>(u) * I;
  const uint8_t* mrow = seen + static_cast<size_t>(u) * I;
  TopK top;
  top.init();
  for (int i0 = 0; i0 < I; i0 += kChunk) {
    const int n = min(kChunk, I - i0);
    merge_chunk(
        top, [=](int cc) { return mrow[i0 + cc] ? kNegInf : srow[i0 + cc]; }, i0, n, k);
  }
  top.store(out_v + static_cast<size_t>(u) * k, out_i + static_cast<size_t>(u) * k, k);
}

size_t matmul_smem_bytes(int D) {
  const int Dp = (D + 3) & ~3;
  return sizeof(float) * (static_cast<size_t>(kChunk) * (Dp + 1) + kTileU * Dp + kTileU * kChunk);
}

}  // namespace

extern "C" {

int serving_topk_max_k() { return kMaxK; }

size_t serving_topk_matmul_smem_bytes(int D) { return matmul_smem_bytes(D); }

const char* serving_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// P [U, D] f32, Q [I, D] f32, seen [U, I] 1-byte (nonzero = exclude), all
// contiguous on the current device -> out_v [U, k] f32, out_i [U, k] int32.
int serving_topk_matmul_f32(const void* P, const void* Q, const void* seen, void* out_v,
                            void* out_i, int U, int I, int D, int k, void* stream) {
  if (U < 1 || D < 1 || k < 1 || k > kMaxK || k > I) return cudaErrorInvalidValue;
  const size_t smem = matmul_smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (U + kTileU - 1) / kTileU;
  matmul_topk_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(P), static_cast<const float*>(Q),
      static_cast<const uint8_t*>(seen), static_cast<float*>(out_v), static_cast<int*>(out_i),
      U, I, D, k);
  return cudaGetLastError();
}

// S [U, I] f32, seen [U, I] 1-byte, contiguous -> out_v [U, k] f32, out_i [U, k] int32.
int serving_topk_scores_f32(const void* S, const void* seen, void* out_v, void* out_i, int U,
                            int I, int k, void* stream) {
  if (U < 1 || k < 1 || k > kMaxK || k > I) return cudaErrorInvalidValue;
  const int blocks = (U + kWarps - 1) / kWarps;
  scores_topk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const uint8_t*>(seen),
      static_cast<float*>(out_v), static_cast<int*>(out_i), U, I, k);
  return cudaGetLastError();
}

}  // extern "C"
