// Row-sparse updates of an embedding table for Hopper (sm_90a), with a plain C
// interface for ctypes: the two steps of train/sparse.py that move [B, D] rows,
// on CUDA float32 rows.
//
// Replace no TPU kernel: the JAX package's train/sparse.py is plain jnp (a
// stable sort, a scatter-add, gathers and scatters of the touched rows) that it
// leaves to XLA. On the card those steps were PyTorch's index_put_,
// index_select, where and index_copy_: about a dozen passes over [B, D]
// tensors a step (0.9 GB each at DLRM's B = 1,753,088 ids and D = 128).
// Their plain PyTorch versions are dedup_rows_plain / rowwise_adagrad_plain in
// deeplearningrecommendationsystem_tpu_torch/train/sparse.py.
//
// The dedup (train/sparse.py::dedup_rows): dedup_long_runs_kernel, then
// dedup_short_runs_kernel, on the caller's stream from one entry (rows of one
// column: dedup_one_column_kernel alone). The launcher
// (ops/cuda/sparse_rows.py) sorts the ids once, stably, as int32 keys, and
// counts the key changes along the sorted keys with a cumulative sum, all
// [B]-sized and on the stream: nothing waits for the card. Each run of equal
// keys is summed by one block (one warp for one column), its gradient rows
// read through the sort's order and added from 0.0f in that order. That is the
// order in which PyTorch's index_put_(accumulate=True) adds them (its sort is
// stable and its indexing_backward_kernel walks a run from its first row; one
// column below), so the sums are index_put_'s bit for bit, with no atomics.
// The sum goes to the run's slot (the number of runs before it) and the key to
// that slot's uid; a sorted position past the last run owns that padding slot
// (the sentinel uid, a zero row). So every slot is written once, and there is
// no separate zero fill.
//   * Short runs (at most kLong positions: all but about 500 of DLRM's 1.34 M a
//     step) and the padding: a block takes kThreads sorted positions, lists the
//     slots that start there in shared memory, and its threads then take (slot,
//     VEC columns) items as a gather does (a float4 at D = 128), kDepth items at
//     a time with their first rows' loads issued together: most runs are one row.
//   * Long runs (a Zipf head: DLRM's three-row table takes about half of its
//     8,192 ids a step, a run of 4,600 rows) are chains of dependent adds as
//     long as the run, one a column, which wait on memory and use few warps. So
//     kLongWarps warps split a long run's columns, each lane keeps 32 rows in
//     flight, and the rows two steps ahead are asked of L2
//     (prefetch.global.L2).
//   * One column (a bias table's rows): index_put_ sums such a run in another
//     order (its stride-1 kernel: a warp a run, each lane's whole passes of 32
//     rows, the lanes folded by shuffles down, then lane 0 adds the rows left
//     over), and dedup_one_column_kernel adds them in that order, for the same
//     bits.
//
// rowwise_adagrad_kernel (train/sparse.py::rowwise_adagrad). Warp w owns slots
// [kSlots w, kSlots w + kSlots), whose loads it issues together. A slot whose
// uid is not a row of the table (the sentinel vocab: a padding slot, or another
// rank's ids on an EP mesh) does nothing. Otherwise the warp takes the mean
// square of the slot's gradient row (each lane's columns in order, then a
// butterfly over the lanes, so every lane holds the same bits), advances
// accum[uid], and writes table[uid] -= lr / (sqrt(accum) + eps) * g in place,
// rounding as the plain version's PyTorch ops do (lr / x is x.reciprocal() * lr
// there). Only the mean's order of summation differs from torch.mean's, a few
// ulps. The slots' rows are distinct (the dedup's), so no two warps write one
// row, and rows no slot names keep their bits.
//
// What bounds them: bytes. At the dlrm-dcnv2-train cell's step (B = 1,753,088,
// n = 1,344,273 distinct ids, D = 128): the dedup reads the gradient rows once
// and writes one row a slot (0.90 GB each way), the update reads the n sums
// (0.69 GB), reads and writes the n table rows (0.69 GB each way) and their
// accumulators: about 3.9 GB, 1.2 ms at 3.35 TB/s. The sort of the int32 keys
// adds four radix passes over [B] keys and int64 positions.
//
// Each entry point returns cudaGetLastError() after its launch (or a
// cudaError_t for arguments it does not take); the Python launcher raises when
// it is not 0.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 4;              // short-run items a thread takes at once, first loads together
constexpr int kSlots = 4;              // AdaGrad slots a warp takes at once, loads together
constexpr int kLong = 64;              // a run longer than this is a long run
constexpr int kLongWarps = 4;          // warps of a long run's block: 32-column groups each
constexpr int kAhead = 64;             // how far ahead a long run's rows are asked of L2
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void load_vec(const float* p, float (&x)[1]) { x[0] = __ldg(p); }
__device__ __forceinline__ void load_vec(const float* p, float (&x)[2]) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(p));
  x[0] = a.x;
  x[1] = a.y;
}
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}

// the table's rows are read and written by the same kernel: no __ldg there
__device__ __forceinline__ void load_rw(const float* p, float (&x)[1]) { x[0] = *p; }
__device__ __forceinline__ void load_rw(const float* p, float (&x)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  x[0] = a.x;
  x[1] = a.y;
}
__device__ __forceinline__ void load_rw(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}

__device__ __forceinline__ void store_vec(float* p, const float (&x)[1]) { *p = x[0]; }
__device__ __forceinline__ void store_vec(float* p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ long long warp_index() {
  return static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
}

// ------------------------------------------------------------------ dedup

// keys [B] sorted int32, order [B] the sort's positions, runs [B - 1]:
// runs[i] = key changes among sorted positions 1 .. i + 1 (so the run of
// position p >= 1 is runs[p - 1]); g [B, D]; uids [B], out [B, D].

__device__ __forceinline__ int slot_of(const int* runs, int p) { return p > 0 ? runs[p - 1] : 0; }

// Whether a run of more than kLong positions starts at p: the long-run
// kernel's, which the short-run kernel leaves alone.
__device__ __forceinline__ bool long_at(const int* keys, long long p, int key, int B) {
  return p + kLong < B && keys[p + kLong] == key;
}

// Short runs and padding: block b owns sorted positions [kThreads b,
// kThreads b + kThreads). Each thread looks at its position: past the last
// run, it owns padding slot p (the sentinel, a zero row); where a run of at
// most kLong positions starts, it walks the run's keys to its end and owns the
// run's slot. The block lists its slots in shared memory, then its threads
// take (slot, VEC columns) items as a gather does, kDepth items at a time with
// their first rows' loads issued together, and add each run's rows in order.
template <int VEC, class Uid>
__global__ void __launch_bounds__(kThreads)
dedup_short_runs_kernel(const int* __restrict__ keys, const long long* __restrict__ order,
                        const int* __restrict__ runs, const float* __restrict__ g,
                        Uid* __restrict__ uids, float* __restrict__ out, int B, int D,
                        int vocab) {
  __shared__ int item_slot[2 * kThreads];   // a run's slot or a padding slot
  __shared__ int item_start[2 * kThreads];  // its first position
  __shared__ int item_len[2 * kThreads];    // its positions; 0 for padding
  __shared__ long long tile_row[kThreads];  // order[] of the block's positions
  __shared__ int warp_items[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long p0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long p64 = p0 + t;
  const int p = static_cast<int>(p64);
  const int n = B > 1 ? runs[B - 2] + 1 : 1;  // runs of equal keys: the real slots
  bool pad = false, head = false;
  int len = 0;
  if (p64 < B) {
    tile_row[t] = order[p];
    const int key = keys[p];
    pad = p >= n;
    if (pad) uids[p] = static_cast<Uid>(vocab);
    if ((p == 0 || keys[p - 1] != key) && !long_at(keys, p, key, B)) {
      head = true;
      len = 1;
      while (p + len < B && keys[p + len] == key) ++len;  // at most kLong
      uids[slot_of(runs, p)] = static_cast<Uid>(key);
    }
  }
  // the block's items: a warp's counts by ballot, the warps' by a pass over kWarps
  const unsigned pads = __ballot_sync(kAll, pad), heads = __ballot_sync(kAll, head);
  if (lane == 0) warp_items[warp] = __popc(pads) + __popc(heads);
  __syncthreads();
  int base = 0, items = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    base += k < warp ? warp_items[k] : 0;
    items += warp_items[k];
  }
  const unsigned below = (1u << lane) - 1u;
  int at = base + __popc(pads & below) + __popc(heads & below);
  if (pad) {
    item_slot[at] = p;
    item_start[at] = p;
    item_len[at] = 0;
    ++at;
  }
  if (head) {
    item_slot[at] = slot_of(runs, p);
    item_start[at] = p;
    item_len[at] = len;
  }
  __syncthreads();

  const int vecs = D / VEC;  // VEC divides D
  const int work = items * vecs;
  for (int i0 = t; i0 < work; i0 += kDepth * kThreads) {
    float acc[kDepth][VEC];
    int it[kDepth], col[kDepth];
    // the first row of each item, the loads issued together (runs are mostly one row)
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int i = i0 + k * kThreads;
      it[k] = i < work ? i / vecs : -1;
      col[k] = it[k] >= 0 ? (i - it[k] * vecs) * VEC : 0;
      float x[VEC] = {};
      if (it[k] >= 0 && item_len[it[k]] > 0) {
        const int q = item_start[it[k]] - static_cast<int>(p0);  // in this block's tile
        load_vec(g + static_cast<size_t>(tile_row[q]) * D + col[k], x);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[k][j] = __fadd_rn(0.f, x[j]);
    }
    // the runs' other rows, in order
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (it[k] < 0) continue;
      const int start = item_start[it[k]], end = start + item_len[it[k]];
      for (int q = start + 1; q < end; ++q) {
        const long long r = q < p0 + kThreads ? tile_row[q - p0] : order[q];
        float x[VEC];
        load_vec(g + static_cast<size_t>(r) * D + col[k], x);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[k][j] = __fadd_rn(acc[k][j], x[j]);
      }
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (it[k] >= 0) store_vec(out + static_cast<size_t>(item_slot[it[k]]) * D + col[k], acc[k]);
    }
  }
}

// The end of the run of `key` that starts at `start`: the first later
// position with another key (or B). The lanes probe 32 positions a step,
// widening the stride 32-fold until one differs, then narrowing it inside the
// last stride: a few steps for any run (the keys are sorted).
__device__ int run_end(const int* keys, int start, int key, int B, int lane) {
  long long lo = start, hi = B, step = 1;  // keys[lo] == key; position hi differs (or is B)
  for (;;) {
    const long long q = lo + (lane + 1) * step;
    const unsigned other = __ballot_sync(kAll, q >= B || keys[q] != key);
    if (other) {
      const int f = __ffs(other) - 1;
      hi = min(lo + (f + 1) * step, static_cast<long long>(B));
      lo += f * step;
      break;
    }
    lo += 32 * step;
    step *= 32;
  }
  while (hi - lo > 1) {
    step = (hi - lo + 31) / 32;
    const long long q = lo + (lane + 1) * step;
    const unsigned other = __ballot_sync(kAll, q >= hi || keys[q] != key);
    const int f = __ffs(other) - 1;  // lane 31's probe reaches hi
    hi = min(lo + (f + 1) * step, hi);
    lo += f * step;
  }
  return static_cast<int>(hi);
}

// Long runs (a Zipf head: DLRM's three-row table takes about half of its
// 8,192 ids): block b looks at positions [kLong b, kLong b + kLong), where at
// most one run longer than kLong can start. Its kLongWarps warps split that
// run's columns in 32-column groups (a lane a column), so the run's chains of
// dependent adds, one a column, run side by side, and each lane keeps 32 rows
// in flight: the rows of a step come from one coalesced load of the sort's
// positions, shuffled out lane by lane, and the rows two steps ahead are asked
// of L2, so a step waits for L2 rather than for HBM.
template <class Uid>
__global__ void __launch_bounds__(kLongWarps * 32)
dedup_long_runs_kernel(const int* __restrict__ keys, const long long* __restrict__ order,
                       const int* __restrict__ runs, const float* __restrict__ g,
                       Uid* __restrict__ uids, float* __restrict__ out, int B, int D) {
  const int lane = threadIdx.x & 31;
  const long long p0 = static_cast<long long>(blockIdx.x) * kLong;
  int start = -1;
#pragma unroll
  for (int h = 0; h < kLong; h += 32) {
    const long long p = p0 + h + lane;
    bool here = false;
    if (p < B) {
      const int k = keys[p];
      here = (p == 0 || keys[p - 1] != k) && long_at(keys, p, k, B);
    }
    const unsigned m = __ballot_sync(kAll, here);
    if (m) start = static_cast<int>(p0 + h + __ffs(m) - 1);
  }
  if (start < 0) return;  // the same answer in every warp of the block
  const int key = keys[start];
  const int end = run_end(keys, start, key, B, lane);
  const int slot = slot_of(runs, start);
  if (threadIdx.x == 0) uids[slot] = static_cast<Uid>(key);

  for (int group = threadIdx.x >> 5; group * 32 < D; group += kLongWarps) {
    const int d = group * 32 + lane;
    const bool live = d < D;
    float acc = 0.f;
    // the rows of positions p + lane (this step) and p + kAhead + lane (to ask
    // of L2 now), each loaded a step before it is used
    long long next = start + lane < end ? order[start + lane] : 0;
    long long ahead = start + kAhead + lane < end ? order[start + kAhead + lane] : 0;
    for (int p = start; p < end; p += 32) {
      const long long mine = next, far = ahead;
      if (p + 32 + lane < end) next = order[p + 32 + lane];
      if (p + kAhead + 32 + lane < end) ahead = order[p + kAhead + 32 + lane];
      if (p + kAhead + lane < end) prefetch_l2(g + static_cast<size_t>(far) * D + group * 32);
      float v[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const long long r = __shfl_sync(kAll, mine, u);
        v[u] = live && p + u < end ? __ldg(g + static_cast<size_t>(r) * D + d) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        if (p + u < end) acc = __fadd_rn(acc, v[u]);
      }
    }
    if (live) out[static_cast<size_t>(slot) * D + d] = acc;
  }
}

// One column: warp w takes sorted position w. Past the last run it writes
// padding slot w (the sentinel, a zero row); where a run starts it sums the
// run as index_put_'s stride-1 kernel does (lane l adds rows l, l + 32, ... of
// the whole passes of 32 from 0.0f, the lanes fold with shuffles down 16, 8, 4,
// 2, 1, lane 0 adds the rows left over in order, then the sum is added to
// 0.0f) and owns the run's slot.
template <class Uid>
__global__ void __launch_bounds__(kThreads)
dedup_one_column_kernel(const int* __restrict__ keys, const long long* __restrict__ order,
                        const int* __restrict__ runs, const float* __restrict__ g,
                        Uid* __restrict__ uids, float* __restrict__ out, int B, int vocab) {
  const long long w = warp_index();
  if (w >= B) return;  // the same in every lane
  const int p = static_cast<int>(w), lane = threadIdx.x & 31;
  const int n = B > 1 ? runs[B - 2] + 1 : 1;  // runs of equal keys: the real slots
  if (p >= n && lane == 0) {
    uids[p] = static_cast<Uid>(vocab);
    out[p] = 0.f;
  }
  const int key = keys[p];
  if (p > 0 && keys[p - 1] == key) return;  // no run starts here
  const int end = run_end(keys, p, key, B, lane);
  const int whole = (end - p) / 32 * 32;
  float sum = 0.f;
  for (int i = lane; i < whole; i += 32) sum = __fadd_rn(sum, __ldg(g + order[p + i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_down_sync(kAll, sum, o));
  if (lane == 0) {
    for (int q = p + whole; q < end; ++q) sum = __fadd_rn(sum, __ldg(g + order[q]));
    const int slot = slot_of(runs, p);
    out[slot] = __fadd_rn(0.f, sum);
    uids[slot] = static_cast<Uid>(key);
  }
}

// The long runs' kernel, then the short runs' (they write disjoint slots).
template <int VEC, class Uid>
cudaError_t launch_dedup(const void* keys, const void* order, const void* runs, const void* g,
                         void* uids, void* out, int B, int D, int vocab, cudaStream_t stream) {
  const int* k = static_cast<const int*>(keys);
  const long long* o = static_cast<const long long*>(order);
  const int* r = static_cast<const int*>(runs);
  const float* gf = static_cast<const float*>(g);
  Uid* u = static_cast<Uid*>(uids);
  float* of = static_cast<float*>(out);
  const long long windows = (static_cast<long long>(B) + kLong - 1) / kLong;
  dedup_long_runs_kernel<Uid><<<static_cast<unsigned>(windows), kLongWarps * 32, 0, stream>>>(
      k, o, r, gf, u, of, B, D);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long blocks = (static_cast<long long>(B) + kThreads - 1) / kThreads;
  dedup_short_runs_kernel<VEC, Uid><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      k, o, r, gf, u, of, B, D, vocab);
  return cudaGetLastError();
}

template <class Uid>
cudaError_t launch_dedup_one_column(const void* keys, const void* order, const void* runs,
                                    const void* g, void* uids, void* out, int B, int vocab,
                                    cudaStream_t stream) {
  const long long blocks = (static_cast<long long>(B) + kWarps - 1) / kWarps;
  dedup_one_column_kernel<Uid><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int*>(keys), static_cast<const long long*>(order),
      static_cast<const int*>(runs), static_cast<const float*>(g), static_cast<Uid*>(uids),
      static_cast<float*>(out), B, vocab);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- adagrad

// table [vocab, D] and accum [vocab] updated in place; uids [B], g [B, D] the
// dedup's slots. Warp w owns slots [kSlots w, kSlots w + kSlots): their uids,
// then their accumulators and first pass's gradient and table values (one pass
// covers D <= 32 VEC: 128 at float4) are loaded together, then each slot is
// reduced and written in turn.
template <int VEC, class Uid>
__global__ void __launch_bounds__(kThreads)
rowwise_adagrad_kernel(float* __restrict__ table, float* __restrict__ accum,
                       const Uid* __restrict__ uids, const float* __restrict__ g, int B, int D,
                       int vocab, float inv_d, float lr, float eps) {
  const long long j0 = warp_index() * kSlots;
  if (j0 >= B) return;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * VEC;
  long long uid[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    // a padding slot, past the batch, or a row another rank holds: none
    const long long u = j0 + k < B ? static_cast<long long>(uids[j0 + k]) : -1;
    uid[k] = u >= 0 && u < vocab ? u : -1;
  }
  float before[kSlots], x0[kSlots][VEC], t0[kSlots][VEC];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) x0[k][j] = t0[k][j] = 0.f;
    before[k] = 0.f;
    if (uid[k] < 0) continue;
    before[k] = accum[uid[k]];
    if (d0 < D) {
      load_vec(g + static_cast<size_t>(j0 + k) * D + d0, x0[k]);
      load_rw(table + static_cast<size_t>(uid[k]) * D + d0, t0[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (uid[k] < 0) continue;  // the same in every lane
    const float* gj = g + static_cast<size_t>(j0 + k) * D;
    float* row = table + static_cast<size_t>(uid[k]) * D;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) sq = __fadd_rn(sq, __fmul_rn(x0[k][j], x0[k][j]));
    for (int d = d0 + 32 * VEC; d < D; d += 32 * VEC) {
      float x[VEC];
      load_vec(gj + d, x);
#pragma unroll
      for (int j = 0; j < VEC; ++j) sq = __fadd_rn(sq, __fmul_rn(x[j], x[j]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq = __fadd_rn(sq, __shfl_xor_sync(kAll, sq, o));
    // the plain version's ops, each rounded as PyTorch rounds it: the mean as a
    // sum times 1 / D, a + mean, sqrt, + eps, lr / x as x.reciprocal() * lr,
    // then old - scale * g as a product and a difference (no fused multiply-add)
    const float a = __fadd_rn(before[k], __fmul_rn(sq, inv_d));
    const float scale = __fmul_rn(__frcp_rn(__fadd_rn(__fsqrt_rn(a), eps)), lr);
    if (lane == 0) accum[uid[k]] = a;
    if (d0 < D) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) t0[k][j] = __fsub_rn(t0[k][j], __fmul_rn(scale, x0[k][j]));
      store_vec(row + d0, t0[k]);
    }
    for (int d = d0 + 32 * VEC; d < D; d += 32 * VEC) {
      float x[VEC], t[VEC];
      load_vec(gj + d, x);
      load_rw(row + d, t);
#pragma unroll
      for (int j = 0; j < VEC; ++j) t[j] = __fsub_rn(t[j], __fmul_rn(scale, x[j]));
      store_vec(row + d, t);
    }
  }
}

template <int VEC, class Uid>
cudaError_t launch_adagrad(void* table, void* accum, const void* uids, const void* g, int B,
                           int D, int vocab, float lr, float eps, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kWarps) * kSlots;
  const long long blocks = (static_cast<long long>(B) + per_block - 1) / per_block;
  rowwise_adagrad_kernel<VEC, Uid><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<float*>(table), static_cast<float*>(accum), static_cast<const Uid*>(uids),
      static_cast<const float*>(g), B, D, vocab, 1.0f / static_cast<float>(D), lr, eps);
  return cudaGetLastError();
}

// the widest load of 4, 2 or 1 floats that divides the row and every pointer
int width(uintptr_t a, uintptr_t b, long long D) {
  const uintptr_t align = a | b | static_cast<uintptr_t>(D * sizeof(float));
  return align % 16 == 0 ? 4 : (align % 8 == 0 ? 2 : 1);
}

bool bad_sizes(long long B, long long D, long long vocab, long long uid_bytes) {
  // keys and slots are int32: the sentinel vocab and every position fit
  return B < 1 || B > 0x7fffffffLL || D < 1 || D > 0x7fffffffLL || vocab < 1 ||
         vocab >= 0x7fffffffLL || (uid_bytes != 4 && uid_bytes != 8);
}

}  // namespace

extern "C" {

const char* sparse_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One block of 64-bit fields per call, as csrc/gather.cu's entries take them.

// keys [B] int32 sorted, order [B] int64, runs [B - 1] int32, g [B, D] f32;
// writes uids [B] (int32: uid_bytes 4, int64: 8) and out [B, D] f32; all on
// CUDA device `device`, launched on `stream`. B >= 1.
struct DedupArgs {
  const void* keys;
  const void* order;
  const void* runs;
  const void* g;
  void* uids;
  void* out;
  long long B, D, vocab, uid_bytes, device;
  void* stream;
};

int dedup_segments(const DedupArgs* a) {
  if (bad_sizes(a->B, a->D, a->vocab, a->uid_bytes)) return cudaErrorInvalidValue;
  const DeviceGuard guard(static_cast<int>(a->device));
  if (guard.error() != cudaSuccess) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const int B = static_cast<int>(a->B), D = static_cast<int>(a->D);
  const int V = static_cast<int>(a->vocab);
  if (D == 1) {
    return a->uid_bytes == 4
               ? launch_dedup_one_column<int>(a->keys, a->order, a->runs, a->g, a->uids, a->out,
                                              B, V, s)
               : launch_dedup_one_column<long long>(a->keys, a->order, a->runs, a->g, a->uids,
                                                    a->out, B, V, s);
  }
  const int vec = width(reinterpret_cast<uintptr_t>(a->g), reinterpret_cast<uintptr_t>(a->out), D);
#define DEDUP(VEC, UID) \
  launch_dedup<VEC, UID>(a->keys, a->order, a->runs, a->g, a->uids, a->out, B, D, V, s)
  if (a->uid_bytes == 4) {
    return vec == 4 ? DEDUP(4, int) : (vec == 2 ? DEDUP(2, int) : DEDUP(1, int));
  }
  return vec == 4 ? DEDUP(4, long long) : (vec == 2 ? DEDUP(2, long long) : DEDUP(1, long long));
#undef DEDUP
}

// table [vocab, D] f32 and accum [vocab] f32, updated in place; uids [B]
// (int32: uid_bytes 4, int64: 8) and g [B, D] f32 the dedup's slots; all on
// CUDA device `device`, launched on `stream`. B >= 1.
struct AdagradArgs {
  void* table;
  void* accum;
  const void* uids;
  const void* g;
  long long B, D, vocab, uid_bytes;
  double lr, eps;
  long long device;
  void* stream;
};

int rowwise_adagrad(const AdagradArgs* a) {
  if (bad_sizes(a->B, a->D, a->vocab, a->uid_bytes)) return cudaErrorInvalidValue;
  const DeviceGuard guard(static_cast<int>(a->device));
  if (guard.error() != cudaSuccess) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const int B = static_cast<int>(a->B), D = static_cast<int>(a->D);
  const int V = static_cast<int>(a->vocab);
  // PyTorch takes a Python float operand of a float32 tensor op as a float
  const float lr = static_cast<float>(a->lr), eps = static_cast<float>(a->eps);
  const int vec =
      width(reinterpret_cast<uintptr_t>(a->table), reinterpret_cast<uintptr_t>(a->g), D);
#define ADAGRAD(VEC, UID) launch_adagrad<VEC, UID>(a->table, a->accum, a->uids, a->g, B, D, V, lr, eps, s)
  if (a->uid_bytes == 4) {
    return vec == 4 ? ADAGRAD(4, int) : (vec == 2 ? ADAGRAD(2, int) : ADAGRAD(1, int));
  }
  return vec == 4 ? ADAGRAD(4, long long)
                  : (vec == 2 ? ADAGRAD(2, long long) : ADAGRAD(1, long long));
#undef ADAGRAD
}

}  // extern "C"
