// Pieces of the fused full-batch trainers' cost on one card, for
// tools/probe_fullbatch_costs.py (plain C interface for ctypes).
//
// * probe_parent_epoch: the MF epoch kernel as csrc/mf_epoch.cu had it before
//   it became one persistent launch (float32, int32 ids, 4 columns a lane),
//   with its user or item gradient flushes (f32 atomicAdd) left out by `mode`
//   (bit 1: no user gradient, bit 2: no item gradient; 3: the forward alone);
//   probe_parent_adam its Adam launch; probe_parent_run_c both for E epochs
//   from one C loop.
// * probe_empty: n launches of an empty one-block kernel from one C loop.
// * probe_grid_sync: a cooperative launch whose blocks pass n grid barriers.
// * probe_gather: each warp gathers rows of a [V, 64] table by the ids of 32
//   positions at a time, R rows in flight, and sums them (the L2 gather rate).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 32;
constexpr int kCols = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ void flush(float* d, long long row, int D, int lane,
                                      const float (&acc)[kCols]) {
  if (row < 0) return;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int col = lane + 32 * k;
    if (col < D) atomicAdd(d + static_cast<size_t>(row) * D + col, acc[k]);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
parent_epoch_kernel(const int* __restrict__ uid, const int* __restrict__ iid,
                    const float* __restrict__ y, const float* __restrict__ pu,
                    const float* __restrict__ pi, float* __restrict__ du, float* __restrict__ di,
                    float* __restrict__ loss, long long B, int U, int I, int D) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long r0 = warp * kRowsPerWarp;
  if (r0 >= B) return;
  const long long r1 = min(B, r0 + kRowsPerWarp);
  const float nb = static_cast<float>(B);
  float acc_u[kCols], acc_i[kCols];
  long long cur_u = -1, cur_i = -1;
  float loss_sum = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const long long u = uid[r];
    const long long i = iid[r];
    const bool u_ok = u >= 0 && u < U;
    const bool i_ok = i >= 0 && i < I;
    float ue[kCols], ie[kCols];
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = lane + 32 * k;
      ue[k] = (col < D && u_ok) ? pu[static_cast<size_t>(u) * D + col] : 0.f;
      ie[k] = (col < D && i_ok) ? pi[static_cast<size_t>(i) * D + col] : 0.f;
      part = fmaf(ue[k], ie[k], part);
    }
    const float z = warp_sum(part);
    const float yr = y[r];
    loss_sum += fmaxf(z, 0.f) - z * yr + log1pf(expf(-fabsf(z)));
    const float g = (1.f / (1.f + expf(-z)) - yr) / nb;
    if (!(kMode & 1) && u_ok) {
      if (u != cur_u) {
        flush(du, cur_u, D, lane, acc_u);
        cur_u = u;
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc_u[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc_u[k] += g * ie[k];
    }
    if (!(kMode & 2) && i_ok) {
      if (i != cur_i) {
        flush(di, cur_i, D, lane, acc_i);
        cur_i = i;
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc_i[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc_i[k] += g * ue[k];
    }
  }
  if (!(kMode & 1)) flush(du, cur_u, D, lane, acc_u);
  if (!(kMode & 2)) flush(di, cur_i, D, lane, acc_i);
  if (lane == 0) atomicAdd(loss, loss_sum / nb);
}

__global__ void __launch_bounds__(kThreads)
parent_adam_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                   float* __restrict__ d, long long n, float lr, float wd, int step) {
  const float t = static_cast<float>(step);
  const float bc1 = 1.f - expf(t * logf(0.9f));
  const float bc2 = 1.f - expf(t * logf(0.999f));
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < n;
       j += stride) {
    const float dw = d[j] + wd * p[j];
    const float mj = 0.9f * m[j] + 0.1f * dw;
    const float vj = 0.999f * v[j] + 0.001f * dw * dw;
    p[j] = p[j] - lr * (mj / bc1) / (sqrtf(vj / bc2) + 1e-8f);
    m[j] = mj;
    v[j] = vj;
    d[j] = 0.f;
  }
}

__global__ void empty_kernel() {}

__global__ void grid_sync_kernel(int n, int* out) {
  cg::grid_group grid = cg::this_grid();
  for (int j = 0; j < n; ++j) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = n;
}

template <class T>
__device__ __forceinline__ float as_float(T x) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(x);
  } else {
    return x;
  }
}

template <class T, int R>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ ids, const T* __restrict__ table, long long B, int D,
              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * kThreads / 32;
  float s = 0.f;
  for (long long p0 = warp * 32; p0 < B; p0 += warps * 32) {
    const int mine = p0 + lane < B ? ids[p0 + lane] : -1;
    for (int j = 0; j < 32; j += R) {
      float v[R][2];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int id = __shfl_sync(kFull, mine, j + q);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int col = lane + 32 * k;
          v[q][k] = (id >= 0 && col < D) ? as_float(table[static_cast<size_t>(id) * D + col]) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) s += v[q][0] * v[q][1];
    }
  }
  s = warp_sum(s);
  if (lane == 0) out[warp] = s;
}

template <class T>
cudaError_t gather(int R, const int* ids, const void* table, long long B, int D, float* out,
                   int blocks, cudaStream_t s) {
  const T* t = static_cast<const T*>(table);
  switch (R) {
    case 1: gather_kernel<T, 1><<<blocks, kThreads, 0, s>>>(ids, t, B, D, out); break;
    case 4: gather_kernel<T, 4><<<blocks, kThreads, 0, s>>>(ids, t, B, D, out); break;
    case 8: gather_kernel<T, 8><<<blocks, kThreads, 0, s>>>(ids, t, B, D, out); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t parent_epoch(int mode, const int* uid, const int* iid, const float* y, const float* pu,
                         const float* pi, float* du, float* di, float* loss, long long B, int U,
                         int I, int D, cudaStream_t s) {
  const long long warps = (B + kRowsPerWarp - 1) / kRowsPerWarp;
  const unsigned blocks = static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  switch (mode) {
    case 0: parent_epoch_kernel<0><<<blocks, kThreads, 0, s>>>(uid, iid, y, pu, pi, du, di, loss, B, U, I, D); break;
    case 1: parent_epoch_kernel<1><<<blocks, kThreads, 0, s>>>(uid, iid, y, pu, pi, du, di, loss, B, U, I, D); break;
    case 2: parent_epoch_kernel<2><<<blocks, kThreads, 0, s>>>(uid, iid, y, pu, pi, du, di, loss, B, U, I, D); break;
    case 3: parent_epoch_kernel<3><<<blocks, kThreads, 0, s>>>(uid, iid, y, pu, pi, du, di, loss, B, U, I, D); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t parent_adam(float* p, float* m, float* v, float* d, long long n, int step,
                        cudaStream_t s) {
  const long long blocks = min((n + kThreads - 1) / kThreads, 132LL * 16);
  parent_adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p, m, v, d, n, 0.01f,
                                                                      1e-5f, step);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int probe_parent_epoch(int mode, const void* uid, const void* iid, const void* y, const void* pu,
                       const void* pi, void* du, void* di, void* loss, long long B, int U, int I,
                       int D, void* stream) {
  return parent_epoch(mode, static_cast<const int*>(uid), static_cast<const int*>(iid),
                      static_cast<const float*>(y), static_cast<const float*>(pu),
                      static_cast<const float*>(pi), static_cast<float*>(du),
                      static_cast<float*>(di), static_cast<float*>(loss), B, U, I, D,
                      static_cast<cudaStream_t>(stream));
}

// p, m, v, d: both tables' values in one array each (n values)
int probe_parent_adam(void* p, void* m, void* v, void* d, long long n, int step, void* stream) {
  return parent_adam(static_cast<float*>(p), static_cast<float*>(m), static_cast<float*>(v),
                     static_cast<float*>(d), n, step, static_cast<cudaStream_t>(stream));
}

// E epochs of (probe_parent_epoch mode 0, probe_parent_adam) from one C loop;
// pu and pi are the first U*D and the next I*D values of p (du, di of d)
int probe_parent_run_c(int E, const void* uid, const void* iid, const void* y, void* p, void* m,
                       void* v, void* d, void* loss, long long B, int U, int I, int D,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* df = static_cast<float*>(d);
  const long long nu = static_cast<long long>(U) * D;
  for (int e = 0; e < E; ++e) {
    cudaError_t err = parent_epoch(0, static_cast<const int*>(uid), static_cast<const int*>(iid),
                                   static_cast<const float*>(y), pf, pf + nu, df, df + nu,
                                   static_cast<float*>(loss) + e, B, U, I, D, s);
    if (err != cudaSuccess) return err;
    err = parent_adam(pf, static_cast<float*>(m), static_cast<float*>(v), df,
                      nu + static_cast<long long>(I) * D, e + 1, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int probe_empty(int n, void* stream) {
  for (int j = 0; j < n; ++j) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int probe_max_coop_blocks(int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_sync_kernel, threads, 0);
  return sms * per_sm;
}

int probe_grid_sync(int blocks, int threads, int n, void* out, void* stream) {
  void* args[] = {&n, &out};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_sync_kernel), blocks,
                                     threads, args, 0, static_cast<cudaStream_t>(stream));
}

// ids [B] int32; table [V, D] f32 (bf16 0) or bf16 (1); out [blocks * 8] f32
int probe_gather(int bf16, int R, const void* ids, const void* table, long long B, int D,
                 void* out, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  return bf16 ? gather<__nv_bfloat16>(R, id, table, B, D, o, blocks, s)
              : gather<float>(R, id, table, B, D, o, blocks, s);
}

}  // extern "C"
