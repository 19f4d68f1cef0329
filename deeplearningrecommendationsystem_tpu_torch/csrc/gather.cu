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
// gather_rows_kernel: out[n, :] = table[id(n), :] for a table of f32 or bf16
// rows. A block loads the ids of its 64 rows into shared memory (no scalar
// prefetch), then its threads copy the rows as a flat run of vectors, the widest
// of 16, 8, 4 or 2 bytes that divides the row and the pointers: neighbouring
// threads move neighbouring 16-byte pieces of a row, so stores are coalesced and
// a 256-byte row (D = 64, f32) is read by 16 threads at once.
//   Bound: bytes. At the MF training shape (B = 229.7k ids, D = 64, f32) the
//   output alone is B * 256 B = 58.8 MB, written once; the tables (943 and 1682
//   rows, 0.24 and 0.43 MB) stay in the 50 MB L2, so the rows are read from L2.
//
// onehot_grad_kernel: out[v, :] = sum over n with id(n) = v of g[n, :], into a
// zeroed f32 out, for f32 or bf16 g. A warp takes 32 consecutive rows; lane l
// owns columns l, l + 32, ... and runs down the rows, summing in a register
// while the id stays the same and flushing the sum with one f32 atomicAdd when
// the id changes. The MF batches are grouped by user (positives per user, then
// the negatives user-major), so the user table takes about one atomic per
// (user run, column) instead of one per row; the item table takes one per row.
//   Bound: bytes: g (B * D * 4 B) and ids read once, out written once.
//   Contention: 229.7k rows land on 943 user rows, about 244 updates each;
//   the run-length sums cut that down. Sums meet in an order that changes from
//   run to run, so float results differ in the last bits between runs; on
//   integer-valued cotangents (sums below 2^24) they are exact in any order.
//
// Each entry point returns cudaGetLastError() after its launch (or a cudaError_t
// for arguments it does not take); the Python launcher raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 64;  // gather: ids staged in shared memory per block
constexpr int kRowsPerWarp = 32;   // onehot_grad: rows one warp runs down

template <class Id>
__device__ __forceinline__ long long wrapped(const Id* ids, long long n, int V) {
  long long id = static_cast<long long>(ids[n]);
  return id < 0 ? id + V : id;
}

template <class Vec, class Id>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Vec* __restrict__ table, const Id* __restrict__ ids,
                   Vec* __restrict__ out, long long B, int V, int vecs_per_row) {
  __shared__ int rows[kRowsPerBlock];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const int n = static_cast<int>(min(static_cast<long long>(kRowsPerBlock), B - r0));
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class G, class Id>
__global__ void __launch_bounds__(kThreads)
onehot_grad_kernel(const Id* __restrict__ ids, const G* __restrict__ g, float* __restrict__ out,
                   long long N, int V, int D) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long r0 = warp * kRowsPerWarp;
  if (r0 >= N) return;
  const long long r1 = min(N, r0 + kRowsPerWarp);
  for (int d = lane; d < D; d += 32) {
    long long cur = -1;
    float acc = 0.f;
    for (long long r = r0; r < r1; ++r) {
      const long long id = wrapped(ids, r, V);
      if (id < 0 || id >= V) continue;  // dropped, as JAX's scatter-add drops it
      if (id != cur) {
        if (cur >= 0) atomicAdd(out + static_cast<size_t>(cur) * D + d, acc);
        cur = id;
        acc = 0.f;
      }
      acc += to_float(g[static_cast<size_t>(r) * D + d]);
    }
    if (cur >= 0) atomicAdd(out + static_cast<size_t>(cur) * D + d, acc);
  }
}

template <class Vec, class Id>
cudaError_t launch_gather(const void* table, const void* ids, void* out, long long B, int V,
                          int row_bytes, cudaStream_t stream) {
  const long long blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  gather_rows_kernel<Vec, Id><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Vec*>(table), static_cast<const Id*>(ids), static_cast<Vec*>(out), B, V,
      row_bytes / static_cast<int>(sizeof(Vec)));
  return cudaGetLastError();
}

template <class Id>
cudaError_t gather_by_width(const void* table, const void* ids, void* out, long long B, int V,
                            int row_bytes, int vec_bytes, cudaStream_t stream) {
  switch (vec_bytes) {
    case 16: return launch_gather<uint4, Id>(table, ids, out, B, V, row_bytes, stream);
    case 8: return launch_gather<uint2, Id>(table, ids, out, B, V, row_bytes, stream);
    case 4: return launch_gather<unsigned int, Id>(table, ids, out, B, V, row_bytes, stream);
    case 2: return launch_gather<unsigned short, Id>(table, ids, out, B, V, row_bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <class G, class Id>
cudaError_t launch_grad(const void* ids, const void* g, void* out, long long N, int V, int D,
                        cudaStream_t stream) {
  const long long warps = (N + kRowsPerWarp - 1) / kRowsPerWarp;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  onehot_grad_kernel<G, Id><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Id*>(ids), static_cast<const G*>(g), static_cast<float*>(out), N, V, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table [V, row_bytes] (f32 or bf16 rows), ids [B] int32 (id_bytes 4) or int64
// (id_bytes 8), out [B, row_bytes]; vec_bytes in {16, 8, 4, 2} divides row_bytes
// and both pointers' alignment. B >= 1.
int gather_rows(const void* table, const void* ids, void* out, long long B, int V, int row_bytes,
                int vec_bytes, int id_bytes, void* stream) {
  if (B < 1 || V < 1 || row_bytes < 1 || vec_bytes < 1 || row_bytes % vec_bytes) {
    return cudaErrorInvalidValue;
  }
  if ((B + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4) return gather_by_width<int>(table, ids, out, B, V, row_bytes, vec_bytes, s);
  if (id_bytes == 8) {
    return gather_by_width<long long>(table, ids, out, B, V, row_bytes, vec_bytes, s);
  }
  return cudaErrorInvalidValue;
}

// ids [N] int32 or int64, g [N, D] f32 (g_bf16 = 0) or bf16 (g_bf16 = 1),
// out [V, D] f32, zeroed by the caller. N >= 1.
int onehot_grad(const void* ids, const void* g, void* out, long long N, int V, int D, int g_bf16,
                int id_bytes, void* stream) {
  if (N < 1 || V < 1 || D < 1) return cudaErrorInvalidValue;
  if ((N + kRowsPerWarp - 1) / kRowsPerWarp * 32 / kThreads + 1 > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4) {
    return g_bf16 ? launch_grad<__nv_bfloat16, int>(ids, g, out, N, V, D, s)
                  : launch_grad<float, int>(ids, g, out, N, V, D, s);
  }
  if (id_bytes == 8) {
    return g_bf16 ? launch_grad<__nv_bfloat16, long long>(ids, g, out, N, V, D, s)
                  : launch_grad<float, long long>(ids, g, out, N, V, D, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
