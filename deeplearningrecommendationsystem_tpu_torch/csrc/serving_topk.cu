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
//   s[u, i] = P[u] . Q[i]      (matmul_topk_kernel, float32 accuracy: 3xTF32)
//   s[u, i] = S[u, i]          (scores_topk_kernel)
//   s[u, i] = -1e30 where seen[u, i] != 0
// and the top k (k <= 128) by (value descending, item index ascending): the first
// k of a stable descending sort. Inputs are assumed finite.
//
// The running top-k. One warp owns one user's sorted buffer of 128 slots in
// registers, 4 per lane (slot j = lane * 4 + s). Candidates come 128 at a time,
// and each is tested against the buffer's k-th entry (one compare). When fewer
// than kSortMin pass, the warp inserts them one by one (one warp reduction for
// the position, one register shift: a few dependent shuffles each); when more
// pass, as in a slice's first chunks, it sorts the chunk with a warp bitonic
// sort and merges it in (the better of each slot against the reversed chunk,
// then a bitonic merge), about 35 compare-exchange stages whatever the count.
// Comparisons carry the item index (`beats`), so the answer does not depend on
// the order items arrive in.
//
// Split catalog. At small user counts (a one-user request, a 32-user batch) one
// warp per user leaves most of the 132 SMs idle, and the time is the latency of
// one warp's walk over the catalog. So each user's catalog is cut into `slices`
// (the launcher picks the count from U, I and the card: only until the blocks
// fill one wave, since each slice adds a list to make and merge): one warp (in
// the matmul kernel, one warp of a block) walks one slice and keeps that
// slice's top k. With one slice the result goes straight to the output. With
// more, each slice's sorted list goes to a workspace, and the last warp (block)
// of a user (user tile) to finish, found through a ticket counter in the
// workspace, merges the lists in slice order with the same sorted merge,
// skipping a list whose best entry fails the threshold. That warp resets the
// ticket to 0, so the counters are ready for the next launch on the stream
// with no memset (the launcher zeroes a workspace once, when it makes it).
// One launch a call. A slice's threshold starts from nothing, so a split
// catalog costs more merge work in all, but the first chunks' many passes
// take the sort path.
//
// matmul_topk_kernel: a block takes a tile of 8 * UPW users (UPW = 1, or 8 for
// large catalogs, where 8-user tiles would read Q from L2 once per 8 users) over
// one slice of the catalog, in chunks of 128 items:
//   * scoring on the tensor cores in float32 accuracy (3xTF32): x = hi + lo with
//     hi = tf32(x), lo = tf32(x - hi), and P Q^T = lo_P hi_Q + hi_P lo_Q + hi_P hi_Q,
//     each an mma.sync m16n8k8 TF32 with float32 accumulation. Integers up to 2^11
//     in magnitude are exact in TF32 (lo = 0), so integer-valued inputs give exact
//     scores. Warp w scores items 16 w .. 16 w + 15 of the chunk for every user
//     of the tile; P is split once per block into shared memory;
//   * Q chunks are copied with cp.async into two buffers: chunk c + 1's copy (and
//     the seen bytes of chunk c + 1, through registers) is in flight while chunk
//     c is scored and merged. The [U, I] scores never reach device memory;
//   * warp w merges users w * UPW .. w * UPW + UPW - 1 of the tile.
//   Bound: the tensor-core work 3 * 2 U I D at 495 TFLOP/s (TF32), the U I
//   compares at 67 TFLOP/s, or the bytes of P, Q, seen and the outputs.
//
// scores_topk_kernel: one warp per (user, slice) streams its scores and seen
// bytes, 8 items a lane per step (two float4 and 8 seen bytes, 1.25 KB a warp)
// with the next step's loads issued before the current step's merge. Rows need
// not be aligned: a scalar head and tail take the unaligned ends. Bound: the
// bytes, U I (4 + 1) read once, plus the outputs.
//
// Entry points take one packed argument block, make the block's device current
// (device_guard.cuh) and return cudaGetLastError() after the launch, or a
// cudaError_t for arguments they do not take; the launcher raises when it is
// not 0.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "device_guard.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kMaxK = 128;              // top-k buffer slots (k <= kMaxK)
constexpr int kSlots = kMaxK / 32;      // buffer slots per lane
constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;             // items a matmul block scores at a time
constexpr int kGroups = kChunk / 32;    // items per lane per chunk
static_assert(kGroups == kSlots, "a matmul chunk is one sort's worth of candidates");
constexpr int kLds = kChunk + 4;        // row stride of the chunk's scores in shared memory
constexpr int kStep = 256;              // items a scores warp reads a step: 8 a lane
constexpr int kMaxDevices = 64;
// dynamic shared memory a matmul block may take: Hopper's 232,448 bytes a block,
// less room for the kernel's static shared memory
constexpr size_t kSmemLimit = 232448 - 1024;
constexpr float kNegInf = -1e30f;       // the mask value of the JAX package
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_infinity() { return __int_as_float(static_cast<int>(0xff800000u)); }

// (v1, i1) ranks before (v2, i2): higher value, then lower index.
__device__ __forceinline__ bool beats(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// One compare-exchange stage of a bitonic network over a warp's kMaxK slots
// (slot j = lane * kSlots + s): slots j and j ^ stride swap unless the lower one
// holds the better entry (the worse, where j & size is set). `size` and
// `stride` are powers of two, known after unrolling.
__device__ __forceinline__ void bitonic_stage(float (&v)[kSlots], int (&id)[kSlots], int size,
                                              int stride) {
  const int lane = threadIdx.x & 31;
  if (stride >= kSlots) {  // the partner is in another lane, at the same s
    const int mask = stride / kSlots;
    const bool lower = (lane & mask) == 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float pv = __shfl_xor_sync(kFull, v[s], mask);
      const int pi = __shfl_xor_sync(kFull, id[s], mask);
      const bool up = ((lane * kSlots + s) & size) == 0;
      if ((lower == up) == beats(pv, pi, v[s], id[s])) {  // take the partner's entry
        v[s] = pv;
        id[s] = pi;
      }
    }
  } else {  // the partner is s ^ stride in this lane
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s & stride) continue;
      const int t = s | stride;
      const bool up = ((lane * kSlots + s) & size) == 0;
      if (up ? beats(v[t], id[t], v[s], id[s]) : beats(v[s], id[s], v[t], id[t])) {
        const float tv = v[s];
        const int ti = id[s];
        v[s] = v[t];
        id[s] = id[t];
        v[t] = tv;
        id[t] = ti;
      }
    }
  }
}

// Sorts a warp's kMaxK entries (slot j = lane * kSlots + s) by `beats`.
__device__ __forceinline__ void bitonic_sort(float (&v)[kSlots], int (&id)[kSlots]) {
#pragma unroll
  for (int size = 2; size <= kMaxK; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) bitonic_stage(v, id, size, stride);
  }
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

  // A sorted list of k entries from device memory, written by another block of
  // this launch: read from L2 (ld.global.cg), not from a possibly stale L1.
  __device__ __forceinline__ void load(const float* lv, const int* li, int k) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = lane * kSlots + s;
      v[s] = j < k ? __ldcg(lv + j) : neg_infinity();
      i[s] = j < k ? __ldcg(li + j) : INT_MAX;
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

  // Keeps the best kMaxK of this buffer and `b`, another buffer sorted by
  // `beats`: b reversed against this one slot by slot, the better of each pair
  // (a bitonic sequence that holds the best kMaxK), then sorted by a bitonic
  // merge.
  __device__ __forceinline__ void merge_sorted(const float (&bv)[kSlots], const int (&bi)[kSlots]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {  // slot kMaxK - 1 - j is lane 31 - lane's slot 3 - s
      const float rv = __shfl_sync(kFull, bv[kSlots - 1 - s], 31 - lane);
      const int ri = __shfl_sync(kFull, bi[kSlots - 1 - s], 31 - lane);
      if (beats(rv, ri, v[s], i[s])) {
        v[s] = rv;
        i[s] = ri;
      }
    }
#pragma unroll
    for (int stride = kMaxK / 2; stride > 0; stride >>= 1) bitonic_stage(v, i, kMaxK, stride);
  }
};

// Below this many candidates that pass the threshold, a chunk's candidates
// are inserted one by one (each a few dependent shuffles); from it on, they
// are sorted and merged in (a bitonic sort and merge: about 35 stages), which
// costs about as much as this many insertions. A slice's first chunks, with
// the threshold still low, take the second way.
constexpr int kSortMin = 8;

// Offers a chunk of kMaxK candidates, kSlots a lane ((v[g], id[g]) where
// ok[g]), to the warp's top-k; (tv, ti) is the running k-th entry and follows.
// Called by a whole warp. Returns whether any candidate passed the threshold.
__device__ __forceinline__ bool offer_chunk(TopK& top, int k, float (&v)[kSlots],
                                            int (&id)[kSlots], const bool (&ok)[kSlots],
                                            float& tv, int& ti) {
  const int lane = threadIdx.x & 31;
  unsigned passed[kSlots];
  int count = 0;
#pragma unroll
  for (int g = 0; g < kSlots; ++g) {
    passed[g] = __ballot_sync(kFull, ok[g] && beats(v[g], id[g], tv, ti));
    count += __popc(passed[g]);
  }
  if (count >= kSortMin) {
#pragma unroll
    for (int g = 0; g < kSlots; ++g) {
      if (!((passed[g] >> lane) & 1u)) {
        v[g] = neg_infinity();
        id[g] = INT_MAX;
      }
    }
    bitonic_sort(v, id);
    top.merge_sorted(v, id);
    top.kth(k, tv, ti);
    return true;
  }
#pragma unroll
  for (int g = 0; g < kSlots; ++g) {
    unsigned pending = passed[g];
    while (pending) {  // warp-uniform: every lane holds the same mask
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const float cv = __shfl_sync(kFull, v[g], src);
      const int ci = __shfl_sync(kFull, id[g], src);
      if (!beats(cv, ci, tv, ti)) continue;  // the k-th entry rose since the ballot
      top.insert(cv, ci);
      top.kth(k, tv, ti);
    }
  }
  return count > 0;
}

// The workspace of a split launch: per-user (or per-tile) ticket counters, then
// every (user, slice)'s sorted list, values and ids.
struct Work {
  int* tickets;
  float* part_v;  // [U][slices][k]
  int* part_i;
};

// Merges the `slices` sorted lists of one user (lv, li: [slices][k]) in slice
// order into out_v, out_i [k]: list 0 is the buffer, each other list whose best
// entry passes the threshold is merged in whole (merge_sorted), the next list's
// loads in flight meanwhile. Called by a whole warp.
__device__ __forceinline__ void merge_lists(const float* lv, const int* li, int slices, int k,
                                            float* out_v, int* out_i) {
  TopK top, next;
  top.load(lv, li, k);
  next.load(lv + k, li + k, k);
  for (int s = 1; s < slices; ++s) {
    const TopK cur = next;
    const size_t at = static_cast<size_t>(s + 1) * k;
    if (s + 1 < slices) next.load(lv + at, li + at, k);
    float tv, bv;
    int ti, bi;
    top.kth(k, tv, ti);
    cur.kth(1, bv, bi);  // the list's best entry
    if (beats(bv, bi, tv, ti)) top.merge_sorted(cur.v, cur.i);
  }
  top.store(out_v, out_i, k);
}

// Takes a ticket of `ticket` for one slice, after every thread that wrote the
// slice's list has fenced its writes (__threadfence) and met the caller at a
// barrier; true for the taker of the last ticket, which resets the counter and
// may then read every slice's list (through L2).
__device__ __forceinline__ bool last_ticket(int* ticket, int slices) {
  const int prev = atomicAdd(ticket, 1);
  if (prev != slices - 1) return false;
  atomicExch(ticket, 0);  // ready for the next launch on the stream
  __threadfence();
  return true;
}

// ------------------------------------------------------------------ scores

// Scores and seen bytes of one step: items base + 8 lane .. base + 8 lane + 7.
struct Step {
  float4 s0, s1;
  uint2 m;
};

__device__ __forceinline__ Step load_step(const float* srow, const uint8_t* mrow, int at) {
  Step st;
  st.s0 = __ldcs(reinterpret_cast<const float4*>(srow + at));
  st.s1 = __ldcs(reinterpret_cast<const float4*>(srow + at + 4));
  st.m = __ldcs(reinterpret_cast<const uint2*>(mrow + at));
  return st;
}

// Offers a step's 8 items a lane, as two chunks of kSlots a lane.
__device__ __forceinline__ void offer_step(TopK& top, int k, const Step& st, int at, float& tv,
                                           int& ti) {
  const bool all[kSlots] = {true, true, true, true};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 sc = h ? st.s1 : st.s0;
    const unsigned bytes = h ? st.m.y : st.m.x;
    float v[kSlots] = {sc.x, sc.y, sc.z, sc.w};
    int id[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if ((bytes >> (8 * j)) & 0xffu) v[j] = kNegInf;
      id[j] = at + 4 * h + j;
    }
    offer_chunk(top, k, v, id, all, tv, ti);
  }
}

// The items [lo, hi) of one row (srow, mrow: the row's first score and seen
// byte; `flat` its offset in the [U, I] arrays), offered to `top`. With `vec`
// (both arrays' bases aligned), the aligned middle goes in steps of 8 items a
// lane and the ends one item a lane.
__device__ __forceinline__ void scores_row(TopK& top, const float* srow, const uint8_t* mrow,
                                           size_t flat, int lo, int hi, int k, bool vec) {
  const int lane = threadIdx.x & 31;
  float tv;
  int ti;
  top.kth(k, tv, ti);
  auto scalar = [&](int a, int b) {  // items a .. b - 1, kSlots * 32 a pass
    for (int c0 = a; c0 < b; c0 += kMaxK) {
      float v[kSlots];
      int id[kSlots];
      bool ok[kSlots];
#pragma unroll
      for (int g = 0; g < kSlots; ++g) {
        id[g] = c0 + g * 32 + lane;
        ok[g] = id[g] < b;
        v[g] = ok[g] ? (mrow[id[g]] ? kNegInf : __ldcs(srow + id[g])) : 0.f;
      }
      offer_chunk(top, k, v, id, ok, tv, ti);
    }
  };
  int i = lo;
  if (vec) {
    // the first item whose score (32 bytes) and seen bytes (8) are aligned
    const int a = min(hi, i + static_cast<int>((8 - ((flat + i) & 7)) & 7));
    scalar(i, a);
    i = a;
    if (i + kStep <= hi) {
      Step cur = load_step(srow, mrow, i + 8 * lane);
      for (; i + kStep <= hi; i += kStep) {
        Step next = cur;
        if (i + 2 * kStep <= hi) next = load_step(srow, mrow, i + kStep + 8 * lane);
        offer_step(top, k, cur, i + 8 * lane, tv, ti);
        cur = next;
      }
    }
  }
  scalar(i, hi);
}

__global__ void __launch_bounds__(kThreads)
scores_topk_kernel(const float* __restrict__ S, const uint8_t* __restrict__ seen,
                   float* __restrict__ out_v, int* __restrict__ out_i, Work work, int U, int I,
                   int k, int slices, int slice_items, bool vec) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int u = static_cast<int>(w / slices), s = static_cast<int>(w % slices);
  if (u >= U) return;  // the whole warp leaves; this kernel has no block barrier
  const size_t flat = static_cast<size_t>(u) * I;
  const int lo = s * slice_items, hi = min(I, lo + slice_items);
  TopK top;
  top.init();
  scores_row(top, S + flat, seen + flat, flat, lo, hi, k, vec);
  float* ov = out_v + static_cast<size_t>(u) * k;
  int* oi = out_i + static_cast<size_t>(u) * k;
  if (slices == 1) {
    top.store(ov, oi, k);
    return;
  }
  const size_t list = static_cast<size_t>(u) * slices;
  top.store(work.part_v + (list + s) * k, work.part_i + (list + s) * k, k);
  __threadfence();
  __syncwarp();
  bool last = false;
  if ((threadIdx.x & 31) == 0) last = last_ticket(work.tickets + u, slices);
  if (!__shfl_sync(kFull, last, 0)) return;
  merge_lists(work.part_v + list * k, work.part_i + list * k, slices, k, ov, oi);
}

// ------------------------------------------------------------------ matmul

using tf32mma::cp_async16;
using tf32mma::cp_async4;
using tf32mma::cp_async_commit;
using tf32mma::cp_async_wait_all;
using tf32mma::mma_tf32;
using tf32mma::split_tf32;

// Row stride (floats) of the staged P and Q rows: D rounded up to the mma's
// depth of 8, plus 4, which puts the 8 rows a fragment load touches on 8
// different groups of 4 banks.
__host__ __device__ __forceinline__ int matmul_ld(int D) { return ((D + 7) & ~7) + 4; }

template <int kUPW>
struct MatmulTile {
  static constexpr int kUsers = kWarps * kUPW;  // users of a block's tile
  static constexpr int kNT = kUsers / 8;        // mma n-tiles of 8 users
  // the seen bytes of one chunk that a thread carries: 16-byte pieces, or words
  // of 4 bytes read one by one
  static constexpr int kSeenVec = (kUsers * kChunk / 16 + kThreads - 1) / kThreads;
  static constexpr int kSeenWords = kUsers * kChunk / 4 / kThreads;
  static_assert(kSeenWords * 4 * kThreads == kUsers * kChunk, "seen words");

  static size_t smem_bytes(int D) {
    const size_t ld = static_cast<size_t>(matmul_ld(D));
    return sizeof(float) * (2 * kUsers * ld + 2 * kChunk * ld + kUsers * kLds) +
           2 * static_cast<size_t>(kUsers) * kChunk;
  }
};

// The seen bytes of chunk i0 of the tile's users, in registers, then into
// shared memory (ms [kUsers][kChunk]). Bytes past the catalog or past U are 0.
template <int kUPW>
struct SeenChunk {
  using T = MatmulTile<kUPW>;
  uint4 vec[T::kSeenVec];
  uint32_t word[T::kSeenWords];

  __device__ __forceinline__ void load(const uint8_t* seen, int u0, int U, int I, int i0,
                                       bool vec16) {
    if (vec16) {  // I % 16 == 0 and an aligned base: 16-byte pieces
#pragma unroll
      for (int j = 0; j < T::kSeenVec; ++j) {
        const int e = threadIdx.x + j * kThreads;
        const int r = e / (kChunk / 16), c = (e % (kChunk / 16)) * 16;
        vec[j] = make_uint4(0, 0, 0, 0);
        if (e < T::kUsers * kChunk / 16 && u0 + r < U && i0 + c < I) {
          vec[j] = __ldcs(reinterpret_cast<const uint4*>(seen + static_cast<size_t>(u0 + r) * I + i0 + c));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < T::kSeenWords; ++j) {
        const int e = 4 * (threadIdx.x + j * kThreads);
        const int r = e / kChunk, c = e % kChunk;
        uint32_t w = 0;
        if (u0 + r < U) {
          const uint8_t* row = seen + static_cast<size_t>(u0 + r) * I;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if (i0 + c + b < I) w |= static_cast<uint32_t>(row[i0 + c + b] != 0) << (8 * b);
          }
        }
        word[j] = w;
      }
    }
  }

  __device__ __forceinline__ void store(uint8_t* ms, bool vec16) const {
    if (vec16) {
#pragma unroll
      for (int j = 0; j < T::kSeenVec; ++j) {
        const int e = threadIdx.x + j * kThreads;
        if (e < T::kUsers * kChunk / 16) reinterpret_cast<uint4*>(ms)[e] = vec[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < T::kSeenWords; ++j) {
        reinterpret_cast<uint32_t*>(ms)[threadIdx.x + j * kThreads] = word[j];
      }
    }
  }
};

// Q rows i0 .. i0 + 127 (those below I) into qs [kChunk][ld], asynchronously.
__device__ __forceinline__ void copy_q_chunk(const float* Q, float* qs, int I, int D, int ld,
                                             int i0, bool vec16) {
  if (vec16) {  // D % 4 == 0 and an aligned base
    const int d4 = D >> 2;
    for (int e = threadIdx.x; e < kChunk * d4; e += kThreads) {
      const int r = e / d4, c = (e - r * d4) * 4;
      if (i0 + r < I) cp_async16(qs + r * ld + c, Q + static_cast<size_t>(i0 + r) * D + c);
    }
  } else {
    for (int e = threadIdx.x; e < kChunk * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      if (i0 + r < I) cp_async4(qs + r * ld + c, Q + static_cast<size_t>(i0 + r) * D + c);
    }
  }
  cp_async_commit();
}

template <int kUPW>
__global__ void __launch_bounds__(kThreads)
matmul_topk_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                   const uint8_t* __restrict__ seen, float* __restrict__ out_v,
                   int* __restrict__ out_i, Work work, int U, int I, int D, int k, int slices,
                   int slice_items, bool q_vec, bool seen_vec) {
  using T = MatmulTile<kUPW>;
  constexpr int UT = T::kUsers;
  extern __shared__ __align__(16) float smem[];
  const int ld = matmul_ld(D), Dk = ld - 4;
  uint32_t* phi = reinterpret_cast<uint32_t*>(smem);   // [UT][ld] P's TF32 high parts
  uint32_t* plo = phi + UT * ld;                       // [UT][ld] and low parts
  float* qbuf = reinterpret_cast<float*>(plo + UT * ld);  // [2][kChunk][ld]
  float* ss = qbuf + 2 * kChunk * ld;                  // [UT][kLds] the chunk's scores
  uint8_t* ms = reinterpret_cast<uint8_t*>(ss + UT * kLds);  // [2][UT][kChunk] seen bytes

  const int tile = blockIdx.x / slices, slice = blockIdx.x % slices;
  const int u0 = tile * UT;
  const int lo = slice * slice_items, hi = min(I, lo + slice_items);
  const int chunks = (hi - lo + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  copy_q_chunk(Q, qbuf, I, D, ld, lo, q_vec);
  for (int e = threadIdx.x; e < UT * Dk; e += kThreads) {
    const int r = e / Dk, d = e - r * Dk;
    const float x = (u0 + r < U && d < D) ? P[static_cast<size_t>(u0 + r) * D + d] : 0.f;
    split_tf32(x, phi[r * ld + d], plo[r * ld + d]);
  }
  for (int e = threadIdx.x; e < 2 * kChunk * (Dk - D); e += kThreads) {  // zero depth padding
    const int r = e / (Dk - D), d = D + e % (Dk - D);
    qbuf[r * ld + d] = 0.f;
  }
  {
    SeenChunk<kUPW> first;
    first.load(seen, u0, U, I, lo, seen_vec);
    first.store(ms, seen_vec);
  }

  TopK top[kUPW];
#pragma unroll
  for (int q = 0; q < kUPW; ++q) top[q].init();

  for (int c = 0; c < chunks; ++c) {
    const int i0 = lo + c * kChunk, n = min(kChunk, hi - i0);
    const int buf = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c's Q and seen bytes are in; the last merge is done
    const bool more = c + 1 < chunks;
    SeenChunk<kUPW> next;
    if (more) {
      copy_q_chunk(Q, qbuf + (buf ^ 1) * kChunk * ld, I, D, ld, i0 + kChunk, q_vec);
      next.load(seen, u0, U, I, i0 + kChunk, seen_vec);
    }

    // scores of items 16 warp .. 16 warp + 15 for every user of the tile
    float acc[T::kNT][4];
#pragma unroll
    for (int j = 0; j < T::kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const float* qa = qbuf + buf * kChunk * ld + (warp * 16 + g) * ld + t;
    for (int kk = 0; kk < Dk; kk += 8) {
      uint32_t ah[4], al[4];
      split_tf32(qa[kk], ah[0], al[0]);
      split_tf32(qa[8 * ld + kk], ah[1], al[1]);
      split_tf32(qa[kk + 4], ah[2], al[2]);
      split_tf32(qa[8 * ld + kk + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) {
        const int pr = (8 * j + g) * ld + kk + t;
        const uint32_t bh[2] = {phi[pr], phi[pr + 4]};
        const uint32_t bl[2] = {plo[pr], plo[pr + 4]};
        mma_tf32(acc[j], al, bh);
        mma_tf32(acc[j], ah, bl);
        mma_tf32(acc[j], ah, bh);
      }
    }
#pragma unroll
    for (int j = 0; j < T::kNT; ++j) {
      const int user = 8 * j + 2 * t, item = warp * 16 + g;
      ss[user * kLds + item] = acc[j][0];
      ss[(user + 1) * kLds + item] = acc[j][1];
      ss[user * kLds + item + 8] = acc[j][2];
      ss[(user + 1) * kLds + item + 8] = acc[j][3];
    }
    if (more) next.store(ms + (buf ^ 1) * UT * kChunk, seen_vec);
    __syncthreads();  // the chunk's scores are in

    const uint8_t* mc = ms + buf * UT * kChunk;
#pragma unroll
    for (int q = 0; q < kUPW; ++q) {
      const int r = warp * kUPW + q;
      if (u0 + r >= U) continue;  // warp-uniform
      float tv;
      int ti;
      top[q].kth(k, tv, ti);
      float v[kGroups];
      int id[kGroups];
      bool ok[kGroups];
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const int cc = gi * 32 + lane;
        ok[gi] = cc < n;
        v[gi] = mc[r * kChunk + cc] ? kNegInf : ss[r * kLds + cc];
        id[gi] = i0 + cc;
      }
      offer_chunk(top[q], k, v, id, ok, tv, ti);
    }
  }

  if (slices == 1) {
#pragma unroll
    for (int q = 0; q < kUPW; ++q) {
      const int u = u0 + warp * kUPW + q;
      if (u < U) top[q].store(out_v + static_cast<size_t>(u) * k, out_i + static_cast<size_t>(u) * k, k);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < kUPW; ++q) {
    const int u = u0 + warp * kUPW + q;
    if (u < U) {
      const size_t at = (static_cast<size_t>(u) * slices + slice) * k;
      top[q].store(work.part_v + at, work.part_i + at, k);
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = last_ticket(work.tickets + tile, slices);
  __syncthreads();
  if (!last) return;
  for (int q = 0; q < kUPW; ++q) {
    const int u = u0 + warp * kUPW + q;
    if (u >= U) break;
    const size_t list = static_cast<size_t>(u) * slices * k;
    merge_lists(work.part_v + list, work.part_i + list, slices, k,
                out_v + static_cast<size_t>(u) * k, out_i + static_cast<size_t>(u) * k);
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory on `device`; calls the
// runtime only when that is more than it was granted before there.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int device, size_t bytes, size_t* granted) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err == cudaSuccess) granted[device] = bytes;
  return err;
}

size_t narrow_granted[kMaxDevices];
size_t wide_granted[kMaxDevices];

}  // namespace

// One block of 64-bit fields per call. a: P [U, D] (matmul) or S [U, I]
// (scores), f32; q: Q [I, D] f32 (matmul only); seen [U, I] 1-byte (nonzero =
// exclude); out_v [U, k] f32, out_i [U, k] int32; all contiguous on CUDA device
// `device`. work: tickets [work_tickets] int32, all 0, then, 256-byte aligned,
// part_v [U * slices * k] f32 and part_i the same in int32; needed when
// slices > 1. The catalog is cut into `slices`
// slices of `slice_items` items (a multiple of 128 for the matmul kernel);
// wide: 64 users a matmul block, else 8. Launches on `stream`.
struct TopkArgs {
  const void* a;
  const void* q;
  const void* seen;
  void* out_v;
  void* out_i;
  void* work;
  long long U, I, D, k, slices, slice_items, wide, work_tickets, device;
  void* stream;
};

namespace {

cudaError_t prepare(const TopkArgs* a, long long tickets_needed, Work* w) {
  if (a->U < 1 || a->I < 1 || a->U > INT_MAX || a->I > INT_MAX || a->k < 1 || a->k > kMaxK ||
      a->k > a->I || a->slices < 1 || a->slice_items < 1 ||
      (a->slices - 1) * a->slice_items >= a->I || a->slices * a->slice_items < a->I) {
    return cudaErrorInvalidValue;
  }
  if (a->slices > 1 && (a->work == nullptr || a->work_tickets < tickets_needed)) {
    return cudaErrorInvalidValue;
  }
  const long long lists_at = (a->work_tickets * 4 + 255) / 256 * 256;
  char* base = static_cast<char*>(a->work);
  w->tickets = reinterpret_cast<int*>(base);
  w->part_v = reinterpret_cast<float*>(base + lists_at);
  w->part_i = reinterpret_cast<int*>(base + lists_at + 4 * a->U * a->slices * a->k);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int serving_topk_max_k() { return kMaxK; }

const char* serving_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory of a matmul block: users per tile 8 (wide = 0) or 64 (wide = 1).
size_t serving_topk_matmul_smem_bytes(int D, int wide) {
  return wide ? MatmulTile<8>::smem_bytes(D) : MatmulTile<1>::smem_bytes(D);
}

// Matmul blocks (8 users, or 64 with wide = 1) that fit one SM of CUDA device
// `device` at width D, or a negative cudaError_t.
int serving_topk_matmul_resident(int D, int wide, int device) {
  if (D < 1 || serving_topk_matmul_smem_bytes(D, wide) > kSmemLimit) return -cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return -guard.error();
  int blocks = 0;
  cudaError_t err;
  if (wide) {
    err = allow_smem(matmul_topk_kernel<8>, device, MatmulTile<8>::smem_bytes(D), wide_granted);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, matmul_topk_kernel<8>, kThreads,
                                                          MatmulTile<8>::smem_bytes(D));
    }
  } else {
    err = allow_smem(matmul_topk_kernel<1>, device, MatmulTile<1>::smem_bytes(D), narrow_granted);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, matmul_topk_kernel<1>, kThreads,
                                                          MatmulTile<1>::smem_bytes(D));
    }
  }
  return err == cudaSuccess ? blocks : -err;
}

int serving_topk_matmul(const TopkArgs* a) {
  if (a->D < 1 || a->D > INT_MAX || a->slice_items % kChunk != 0) return cudaErrorInvalidValue;
  const int D = static_cast<int>(a->D);
  if (serving_topk_matmul_smem_bytes(D, static_cast<int>(a->wide)) > kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  const long long users = a->wide ? MatmulTile<8>::kUsers : MatmulTile<1>::kUsers;
  const long long tiles = (a->U + users - 1) / users;
  if (tiles * a->slices > INT_MAX) return cudaErrorInvalidValue;
  const DeviceGuard guard(static_cast<int>(a->device));
  if (guard.error() != cudaSuccess) return guard.error();
  Work w;
  cudaError_t err = prepare(a, tiles, &w);
  if (err != cudaSuccess) return err;
  const int dev = static_cast<int>(a->device);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const int U = static_cast<int>(a->U), I = static_cast<int>(a->I), k = static_cast<int>(a->k);
  const int slices = static_cast<int>(a->slices), items = static_cast<int>(a->slice_items);
  const bool q_vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(a->q) % 16 == 0;
  const bool seen_vec = I % 16 == 0 && reinterpret_cast<uintptr_t>(a->seen) % 16 == 0;
  const unsigned blocks = static_cast<unsigned>(tiles * a->slices);
  const auto* P = static_cast<const float*>(a->a);
  const auto* Q = static_cast<const float*>(a->q);
  const auto* seen = static_cast<const uint8_t*>(a->seen);
  auto* ov = static_cast<float*>(a->out_v);
  auto* oi = static_cast<int*>(a->out_i);
  if (a->wide) {
    err = allow_smem(matmul_topk_kernel<8>, dev, MatmulTile<8>::smem_bytes(D), wide_granted);
    if (err != cudaSuccess) return err;
    matmul_topk_kernel<8><<<blocks, kThreads, MatmulTile<8>::smem_bytes(D), s>>>(
        P, Q, seen, ov, oi, w, U, I, D, k, slices, items, q_vec, seen_vec);
  } else {
    err = allow_smem(matmul_topk_kernel<1>, dev, MatmulTile<1>::smem_bytes(D), narrow_granted);
    if (err != cudaSuccess) return err;
    matmul_topk_kernel<1><<<blocks, kThreads, MatmulTile<1>::smem_bytes(D), s>>>(
        P, Q, seen, ov, oi, w, U, I, D, k, slices, items, q_vec, seen_vec);
  }
  return cudaGetLastError();
}

int serving_topk_scores(const TopkArgs* a) {
  const long long warps = a->U * a->slices;
  if (warps < 1 || (warps + kWarps - 1) / kWarps > INT_MAX) return cudaErrorInvalidValue;
  const DeviceGuard guard(static_cast<int>(a->device));
  if (guard.error() != cudaSuccess) return guard.error();
  Work w;
  const cudaError_t err = prepare(a, a->U, &w);
  if (err != cudaSuccess) return err;
  const bool vec = reinterpret_cast<uintptr_t>(a->a) % 32 == 0 &&
                   reinterpret_cast<uintptr_t>(a->seen) % 8 == 0;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  scores_topk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(a->stream)>>>(
      static_cast<const float*>(a->a), static_cast<const uint8_t*>(a->seen),
      static_cast<float*>(a->out_v), static_cast<int*>(a->out_i), w, static_cast<int>(a->U),
      static_cast<int>(a->I), static_cast<int>(a->k), static_cast<int>(a->slices),
      static_cast<int>(a->slice_items), vec);
  return cudaGetLastError();
}

}  // extern "C"
