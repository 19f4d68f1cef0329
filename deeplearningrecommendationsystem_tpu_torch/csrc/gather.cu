// Embedding-table row gather and its backward (scatter-add) for Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// Replace the Pallas TPU kernels of deeplearningrecommendationsystem_tpu/ops/pallas/:
//   * gather.py::gather_rows_pallas      (row DMAs, ids in scalar memory)  -> gather_rows_kernel
//   * gather_mm.py::gather_mm_fwd_pallas (in-VMEM onehot @ table)           -> gather_rows_kernel
//   * onehot_grad.py::onehot_grad        (in-VMEM onehot^T @ g, f32 acc)    -> onehot_grad_kernel
// Their plain PyTorch versions are gather_rows_kernel_plain / onehot_grad_plain in
// deeplearningrecommendationsystem_tpu_torch/ops/gather.py.
//
// Both TPU forwards compute table[ids]; the mask matmul of gather_mm.py is the
// TPU's way round having no gather hardware, so one kernel here stands for both.
// Ids follow JAX's `table[ids]`: a negative id counts from the end once (id + V);
// the gather then clamps to [0, V - 1], and the backward drops an id that is
// still outside [0, V). Neither kernel reads or writes outside the table.
//
// What bounds them. Bytes: the gather writes B rows (58.8 MB for the MF batch
// of 229.7k ids at D = 64, f32) and reads them from tables that stay in the
// 50 MB L2; the backward reads g (N * D values) once and adds into a table of
// V * D floats. At small batches (a 37-row bias table, a 512-id target tile of
// DIN's full-history serving) the device work is under a microsecond and the
// host's cost of one call is the bound, so the launch path is part of the design:
//   * each C entry takes its arguments as one packed block (ctypes converts one
//     argument, not ten), takes the device index and makes that device current
//     itself (cudaSetDevice only when it differs, restored after), picks the
//     copy width from the row bytes and the pointers, and, for the backward,
//     zeroes the output on the stream with cudaMemsetAsync (not a kernel
//     launch). The Python launcher checks its tensors in one boolean test,
//     allocates with torch.empty only, and passes the current stream's raw
//     handle (ops/cuda/gather.py).
//
// gather_rows_kernel: out[n, :] = table[id(n), :] for a table of f32 or bf16
// rows. A block stages the ids of its rows in shared memory, then its threads
// copy the rows as a flat run of vectors, the widest of 16, 8, 4 or 2 bytes that
// divides the row and the pointers: neighbouring threads move neighbouring
// pieces of a row, so stores are coalesced and a 256-byte row (D = 64, f32) is
// read by 16 threads at once. Rows per block grow as rows narrow (at least 64,
// and 256 / vectors-per-row), so that every thread moves at least one vector
// for D = 1 to 8 (a bias table's 4-byte rows fill all 256 threads).
//
// onehot_grad_kernel: out[v, :] = sum over n with id(n) = v of g[n, :], f32
// sums for f32 or bf16 g. A block takes a tile of 256 ids and adds up repeated
// ids on chip before it touches the table:
//   1. the tile's ids go into a hash table in shared memory (open addressing,
//      512 slots). Lanes of a warp that hold one id agree first
//      (__match_any_sync), so one lane probes for them all; the thread that
//      inserts an id numbers its group;
//   2. a counting sort (group sizes, a block scan) puts the tile's rows in
//      group order;
//   3. warp w sums the sorted positions [32 w, 32 w + 32): a run of one group
//      is summed in registers and flushed once. A group that lies inside the
//      warp's 32 positions is added to the table with one atomic per column; a
//      group that spans warps adds its partial sums into a shared buffer, which
//      goes to the table once per column after the block's warps are done. So
//      the table takes one atomic per (distinct id in the tile, column): a DIN
//      history tile (each user's 10 items repeated row after row) takes about
//      10 groups instead of 256 rows, the MF user table (ids grouped by user)
//      one or two, random item ids about as many as rows.
//   Loads: for D >= 32 a lane owns 1, 2 or 4 neighbouring columns (a float,
//   float2 or float4 load, so a warp reads a 256-byte row in one instruction
//   at D = 64) and issues the loads of 8 rows before it adds them; float2 and
//   float4 sums go to the table as one vector atomic (sm_90). For D < 32 the
//   lanes map to rows instead: lane l takes sorted position 32 w + l, the warp
//   walks the columns, and lanes holding the same group are combined by a
//   segmented shuffle reduction before the group's first lane flushes, so a
//   bias table (D = 1) uses the whole warp.
//   Contention: 229.7k MF rows land on 943 user rows (about 244 each); DIN's
//   879k history ids on the 1682 item rows. Sums meet in an order that changes
//   from run to run, so float results differ in the last bits between runs;
//   on integer-valued cotangents (sums below 2^24) they are exact in any order.
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinGatherRows = 64;          // gather: rows per block for wide rows
constexpr int kTile = kThreads;             // onehot_grad: ids per block, one per thread
constexpr int kWarps = kThreads / 32;       // each sums 32 sorted positions of the tile
constexpr int kHashBits = 9;
constexpr int kHashSlots = 1 << kHashBits;  // twice the tile: probes stay short
constexpr int kUnroll = 8;                  // rows whose loads a lane issues before adding
constexpr int kSplitMaxD = 1024;            // widest row whose split sums stay in shared memory

// Makes `device` current for the entry point's calls and restores the previous
// device after; sets nothing when it is current already.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : target_(device) {
    error_ = cudaGetDevice(&previous_);
    if (error_ == cudaSuccess && previous_ != device) error_ = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (previous_ >= 0 && previous_ != target_) cudaSetDevice(previous_);
  }
  cudaError_t error() const { return error_; }

 private:
  int target_;
  int previous_ = -1;
  cudaError_t error_;
};

template <class Id>
__device__ __forceinline__ long long wrapped(const Id* ids, long long n, int V) {
  long long id = static_cast<long long>(ids[n]);
  return id < 0 ? id + V : id;
}

// ------------------------------------------------------------------ gather

int gather_rows_per_block(int vecs_per_row) {
  const int fill = kThreads / vecs_per_row;
  return fill > kMinGatherRows ? fill : kMinGatherRows;
}

template <class Vec, class Id>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Vec* __restrict__ table, const Id* __restrict__ ids,
                   Vec* __restrict__ out, long long B, int V, int vecs_per_row,
                   int rows_per_block) {
  __shared__ int rows[kThreads];  // rows_per_block <= kThreads
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int n = static_cast<int>(min(static_cast<long long>(rows_per_block), B - r0));
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const long long id = wrapped(ids, r0 + t, V);
    rows[t] = static_cast<int>(id < 0 ? 0 : (id >= V ? V - 1 : id));
  }
  __syncthreads();
  const int total = n * vecs_per_row;
  Vec* dst = out + r0 * vecs_per_row;
  for (int t = threadIdx.x; t < total; t += kThreads) {
    const int r = t / vecs_per_row;
    const int j = t - r * vecs_per_row;
    dst[t] = table[static_cast<size_t>(rows[r]) * vecs_per_row + j];
  }
}

template <class Vec, class Id>
cudaError_t launch_gather(const void* table, const void* ids, void* out, long long B, int V,
                          int row_bytes, cudaStream_t stream) {
  const int vecs = row_bytes / static_cast<int>(sizeof(Vec));
  const int rows = gather_rows_per_block(vecs);
  const long long blocks = (B + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_rows_kernel<Vec, Id><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Vec*>(table), static_cast<const Id*>(ids), static_cast<Vec*>(out), B, V,
      vecs, rows);
  return cudaGetLastError();
}

template <class Id>
cudaError_t gather_by_width(const void* table, const void* ids, void* out, long long B, int V,
                            int row_bytes, cudaStream_t stream) {
  // the widest copy unit that divides the row and both pointers
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return launch_gather<uint4, Id>(table, ids, out, B, V, row_bytes, stream);
  if (align % 8 == 0) return launch_gather<uint2, Id>(table, ids, out, B, V, row_bytes, stream);
  if (align % 4 == 0) {
    return launch_gather<unsigned int, Id>(table, ids, out, B, V, row_bytes, stream);
  }
  if (align % 2 == 0) {
    return launch_gather<unsigned short, Id>(table, ids, out, B, V, row_bytes, stream);
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ onehot_grad

struct GradTile {
  int hash_id[kHashSlots];     // the id a hash slot holds, -1 if empty
  int hash_group[kHashSlots];  // the group numbered for that id
  int group_id[kTile];         // group -> id
  int group_count[kTile];      // group -> rows of the tile with that id
  int group_start[kTile];      // group -> its first sorted position
  int sorted_row[kTile];       // sorted position -> row of the tile
  int sorted_group[kTile];     // sorted position -> group; -1 past the kept rows
  int warp_total[kWarps];      // the scan's per-warp sums
  int split_id[kWarps];        // id whose partial sums split buffer b holds, -1 if none
  int groups;
};

__device__ __forceinline__ int hash_slot(int id) {
  return static_cast<int>((static_cast<unsigned>(id) * 2654435761u) >> (32 - kHashBits));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[1]) {
  x[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[2]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  x[0] = a.x;
  x[1] = a.y;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ void add_to_table(float* p, const float (&x)[1]) { atomicAdd(p, x[0]); }
__device__ __forceinline__ void add_to_table(float* p, const float (&x)[2]) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
}
__device__ __forceinline__ void add_to_table(float* p, const float (&x)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
}

// Adds a run's sums (columns d .. d + W - 1 of group `group`) to the table, or,
// when the group spans more than the warp's 32 sorted positions, to the split
// buffer of the group's first warp, flushed once after the block's warps are done.
template <int W>
__device__ __forceinline__ void flush(GradTile& s, float* split_buf, bool use_buf, float* out,
                                      int D, int group, int seg0, int d, const float (&acc)[W]) {
  const int start = s.group_start[group];
  const int id = s.group_id[group];
  if (!use_buf || (start >= seg0 && start + s.group_count[group] <= seg0 + 32)) {
    add_to_table(out + static_cast<size_t>(id) * D + d, acc);
    return;
  }
  const int b = start >> 5;
  s.split_id[b] = id;  // every writer of buffer b writes the same id
#pragma unroll
  for (int j = 0; j < W; ++j) atomicAdd(split_buf + b * D + d + j, acc[j]);
}

// VEC: columns per lane for D >= 32 (1, 2 or 4); 0 maps lanes to rows (D < 32).
template <class G, class Id, int VEC>
__global__ void __launch_bounds__(kThreads)
onehot_grad_kernel(const Id* __restrict__ ids, const G* __restrict__ g, float* __restrict__ out,
                   long long N, int V, int D) {
  __shared__ GradTile s;
  extern __shared__ float split_buf[];  // [kWarps][D] when D <= kSplitMaxD
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  const int n = static_cast<int>(min(static_cast<long long>(kTile), N - r0));
  const bool use_buf = D <= kSplitMaxD;

  // 1. the tile's ids, staged; an id still outside [0, V) after the wrap is
  //    dropped, as JAX's scatter-add drops it
  int id = -1;
  if (t < n) {
    const long long w = wrapped(ids, r0 + t, V);
    if (w >= 0 && w < V) id = static_cast<int>(w);
  }
  for (int i = t; i < kHashSlots; i += kThreads) s.hash_id[i] = -1;
  s.group_count[t] = 0;
  if (t < kWarps) s.split_id[t] = -1;
  if (t == 0) s.groups = 0;
  if (use_buf) {
    for (int i = t; i < kWarps * D; i += kThreads) split_buf[i] = 0.f;
  }
  __syncthreads();

  // 2. distinct ids. The lanes of a warp that hold one id agree first
  //    (__match_any_sync), so a tile of one user's rows costs 8 probes, not
  //    256; the lowest of them probes the hash table, and the thread that
  //    inserts an id numbers its group
  const unsigned peers = __match_any_sync(0xffffffffu, id);
  const int leader = __ffs(peers) - 1;
  int slot = -1;
  if (id >= 0 && lane == leader) {
    slot = hash_slot(id);
    for (;;) {
      const int held = atomicCAS(&s.hash_id[slot], -1, id);
      if (held == -1) {
        const int group = atomicAdd(&s.groups, 1);
        s.hash_group[slot] = group;
        s.group_id[group] = id;
        break;
      }
      if (held == id) break;
      slot = (slot + 1) & (kHashSlots - 1);
    }
  }
  slot = __shfl_sync(0xffffffffu, slot, leader);
  __syncthreads();
  const int group = id >= 0 ? s.hash_group[slot] : -1;
  int base = 0;  // the peers take consecutive ranks in their group
  if (id >= 0 && lane == leader) base = atomicAdd(&s.group_count[group], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  const int rank = base + __popc(peers & ((1u << lane) - 1u));
  __syncthreads();

  // 3. counting sort of the tile's rows by group: an exclusive scan of the counts
  const int groups = s.groups;
  const int count = t < groups ? s.group_count[t] : 0;
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s.warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
  int kept = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = s.warp_total[w];
    if (w < warp) before += x;
    kept += x;
  }
  if (t < groups) s.group_start[t] = before + incl - count;
  __syncthreads();
  if (id >= 0) {
    const int p = s.group_start[group] + rank;
    s.sorted_row[p] = t;
    s.sorted_group[p] = group;
  }
  if (t >= kept) s.sorted_group[t] = -1;
  __syncthreads();

  // 4. warp w sums the sorted positions [seg0, seg0 + 32)
  const int seg0 = warp * 32;
  const int seg1 = min(seg0 + 32, kept);
  if constexpr (VEC == 0) {
    // lanes on rows: lane l holds position seg0 + l; a segmented shuffle
    // reduction leaves each run's sum in its first lane
    const int p = seg0 + lane;
    const int grp = p < seg1 ? s.sorted_group[p] : -1;
    const bool head = grp >= 0 && (lane == 0 || s.sorted_group[p - 1] != grp);
    unsigned joins = 0;  // bit k: lane + 2^k holds the same group
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int o = 1 << k;
      const int other = __shfl_down_sync(0xffffffffu, grp, o);
      if (lane + o < 32 && other == grp) joins |= 1u << k;
    }
    const G* row = g + (grp >= 0 ? static_cast<size_t>(r0 + s.sorted_row[p]) * D : 0);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float v = grp >= 0 ? to_float(row[d]) : 0.f;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float y = __shfl_down_sync(0xffffffffu, v, 1 << k);
        if (joins & (1u << k)) v += y;
      }
      if (head) {
        const float acc[1] = {v};
        flush(s, split_buf, use_buf, out, D, grp, seg0, d, acc);
      }
    }
  } else {
    // lanes on columns: lane l owns columns [VEC l, VEC l + VEC) of each pass
    for (int d = lane * VEC; d < D; d += 32 * VEC) {
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
      int cur = -1;
      for (int p = seg0; p < seg1; p += kUnroll) {
        float v[kUnroll][VEC];
        int grp[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = p + u;
          grp[u] = q < seg1 ? s.sorted_group[q] : -1;
          if (grp[u] >= 0) {
            load_vec(g + static_cast<size_t>(r0 + s.sorted_row[q]) * D + d, v[u]);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[u][j] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (grp[u] < 0) continue;
          if (grp[u] != cur) {
            if (cur >= 0) flush(s, split_buf, use_buf, out, D, cur, seg0, d, acc);
            cur = grp[u];
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += v[u][j];
        }
      }
      if (cur >= 0) flush(s, split_buf, use_buf, out, D, cur, seg0, d, acc);
    }
  }

  // 5. the split groups' sums, once per column
  if (use_buf) {
    __syncthreads();
    for (int i = t; i < kWarps * D; i += kThreads) {
      const int b = i / D;
      const int owner = s.split_id[b];
      if (owner >= 0) atomicAdd(out + static_cast<size_t>(owner) * D + (i - b * D), split_buf[i]);
    }
  }
}

template <class G, class Id, int VEC>
cudaError_t launch_grad(const void* ids, const void* g, void* out, long long N, int V, int D,
                        cudaStream_t stream) {
  const long long blocks = (N + kTile - 1) / kTile;
  const size_t split_bytes = D <= kSplitMaxD ? sizeof(float) * kWarps * D : 0;
  onehot_grad_kernel<G, Id, VEC><<<static_cast<unsigned>(blocks), kThreads, split_bytes, stream>>>(
      static_cast<const Id*>(ids), static_cast<const G*>(g), static_cast<float*>(out), N, V, D);
  return cudaGetLastError();
}

template <class G, class Id>
cudaError_t grad_by_width(const void* ids, const void* g, void* out, long long N, int V, int D,
                          cudaStream_t stream) {
  if (D < 32) return launch_grad<G, Id, 0>(ids, g, out, N, V, D, stream);
  // columns per lane: a warp's pass covers 32 * VEC columns, and a lane's load
  // of VEC values must be aligned in g and out (out is allocated aligned)
  const uintptr_t row_align = reinterpret_cast<uintptr_t>(g) | (static_cast<uintptr_t>(D) *
                                                                sizeof(G));
  if (D % 4 == 0 && D >= 128 && row_align % (4 * sizeof(G)) == 0) {
    return launch_grad<G, Id, 4>(ids, g, out, N, V, D, stream);
  }
  if (D % 2 == 0 && D >= 64 && row_align % (2 * sizeof(G)) == 0) {
    return launch_grad<G, Id, 2>(ids, g, out, N, V, D, stream);
  }
  return launch_grad<G, Id, 1>(ids, g, out, N, V, D, stream);
}

}  // namespace

extern "C" {

const char* gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One block of 64-bit fields per call: ctypes converts one argument instead
// of nine or ten, which is a fifth of a small launch's host time.

// table [V, row_bytes] (f32 or bf16 rows), ids [B] int32 (id_bytes 4) or int64
// (id_bytes 8), out [B, row_bytes], all on CUDA device `device`; launches on
// `stream`. B >= 1.
struct GatherArgs {
  const void* table;
  const void* ids;
  void* out;
  long long B, V, row_bytes, id_bytes, device;
  void* stream;
};

int gather_rows(const GatherArgs* a) {
  if (a->B < 1 || a->V < 1 || a->V > 0x7fffffffLL || a->row_bytes < 1 ||
      a->row_bytes > 0x7fffffffLL || (a->id_bytes != 4 && a->id_bytes != 8)) {
    return cudaErrorInvalidValue;
  }
  const DeviceGuard guard(static_cast<int>(a->device));
  if (guard.error() != cudaSuccess) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const int V = static_cast<int>(a->V), row_bytes = static_cast<int>(a->row_bytes);
  return a->id_bytes == 4 ? gather_by_width<int>(a->table, a->ids, a->out, a->B, V, row_bytes, s)
                          : gather_by_width<long long>(a->table, a->ids, a->out, a->B, V, row_bytes, s);
}

// ids [N] int32 or int64, g [N, D] f32 (g_bf16 = 0) or bf16 (g_bf16 = 1), out
// [V, D] f32, all on CUDA device `device`. Zeroes out on `stream`, then, for
// N >= 1, launches the kernel there.
struct GradArgs {
  const void* ids;
  const void* g;
  void* out;
  long long N, V, D, g_bf16, id_bytes, device;
  void* stream;
};

int onehot_grad(const GradArgs* a) {
  if (a->N < 0 || a->V < 1 || a->D < 1 || a->V > 0x7fffffffLL || a->D > 0x7fffffffLL ||
      (a->id_bytes != 4 && a->id_bytes != 8)) {
    return cudaErrorInvalidValue;
  }
  if ((a->N + kTile - 1) / kTile > 0x7fffffffLL) return cudaErrorInvalidValue;
  const DeviceGuard guard(static_cast<int>(a->device));
  if (guard.error() != cudaSuccess) return guard.error();
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const long long N = a->N;
  const int V = static_cast<int>(a->V), D = static_cast<int>(a->D);
  const cudaError_t zeroed =
      cudaMemsetAsync(a->out, 0, static_cast<size_t>(V) * static_cast<size_t>(D) * sizeof(float), s);
  if (zeroed != cudaSuccess || N == 0) return zeroed;
  if (a->id_bytes == 4) {
    return a->g_bf16 ? grad_by_width<__nv_bfloat16, int>(a->ids, a->g, a->out, N, V, D, s)
                     : grad_by_width<float, int>(a->ids, a->g, a->out, N, V, D, s);
  }
  return a->g_bf16 ? grad_by_width<__nv_bfloat16, long long>(a->ids, a->g, a->out, N, V, D, s)
                   : grad_by_width<float, long long>(a->ids, a->g, a->out, N, V, D, s);
}

}  // extern "C"
